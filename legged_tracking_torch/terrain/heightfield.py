"""Runtime heightfield representation + the contact sampler (port of
``terrain/heightfield.py``).

The world is a grid of sub-terrain tiles, each a two-layer heightfield
``(2, h, w)`` — layer 0 ceiling, layer 1 floor, meters.  Tiles are stored once
as ``(T, 2, h, w)``; each env carries a tile index.

The JAX package samples contacts through a patch: it cuts a bf16 window of
whole (16, 128) granules around the base (``extract_patches_batched_granule``)
and contracts it with bf16 one-hot weight rows (``sample_patch_bilinear``).
On a GPU the natural shape is a direct gather of the four cells each point
needs, so this module gathers straight from the bf16 tile table.  It keeps
every rounding the patch path makes: the window clamps, the bf16 weights and
the bf16 stage-1 sums.  Each f32 sum then adds at most two exact products of
bf16 values, so the result equals the JAX CPU result bit for bit.

``sample_height_bilinear`` is the flat float32 sampler the JAX package holds
its patch path to.  Here it is the oracle of the contact sampler and runs on
no path of the program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import fma


class TerrainArrays(NamedTuple):
    tiles: torch.Tensor            # (T, 2, h, w) f32 meters; [:,0]=ceiling, [:,1]=floor
    env_tile: torch.Tensor         # (N,) int32 tile index per env
    env_origin: torch.Tensor       # (N, 3) robot spawn origin (world)
    env_terrain_origin: torch.Tensor  # (N, 3) tile lower-corner origin (world)
    horizontal_scale: float
    is_plane: bool                 # plane mode (flat floor, no ceiling)
    # structural top of the ceiling layer: the ceiling is a SLAB occupying
    # z in [h_ceil(x,y), ceiling_top]
    ceiling_top: float = 1e3


def plane_terrain(num_envs: int, env_spacing: float = 3.0, ceiling: float = 1e3,
                  device="cuda") -> TerrainArrays:
    """Flat-plane world: a grid of robots, dummy 2x2 tiles (reference
    _get_env_origins else-branch, legged_robot_trajectory_tracking.py:1848-1858)."""
    num_cols = int(np.floor(np.sqrt(num_envs)))
    num_rows = int(np.ceil(num_envs / num_cols))
    xx, yy = np.meshgrid(np.arange(num_rows), np.arange(num_cols), indexing="ij")
    origins = np.zeros((num_envs, 3), dtype=np.float32)
    origins[:, 0] = env_spacing * xx.flatten()[:num_envs]
    origins[:, 1] = env_spacing * yy.flatten()[:num_envs]
    tiles = np.zeros((1, 2, 2, 2), dtype=np.float32)
    tiles[:, 0] = ceiling
    t = lambda a: torch.as_tensor(a, device=device)
    return TerrainArrays(
        tiles=t(tiles),
        env_tile=t(np.zeros(num_envs, dtype=np.int32)),
        env_origin=t(origins),
        env_terrain_origin=t(origins * np.array([1.0, 1.0, 0.0], np.float32)),
        horizontal_scale=1.0,
        is_plane=True,
    )


def bf16_table(terrain: TerrainArrays) -> torch.Tensor:
    """The bf16 tile table both samplers read.  ``Tensor.to`` rounds to
    nearest even, as JAX's ``astype(jnp.bfloat16)`` does."""
    return terrain.tiles.to(torch.bfloat16).contiguous()


@functools.lru_cache(maxsize=64)
def inv_hs(hs: float) -> float:
    """The float32 reciprocal of the cell size (20.0 at hs = 0.05)."""
    return float(np.float32(1.0) / np.float32(hs))


@functools.lru_cache(maxsize=64)
def grad_weights(hs: float) -> tuple:
    """The bf16 weights of the bilinear x-derivative, ``(-1 / hs, 1 / hs)``
    in float32 rounded to bf16 as the patch path rounds them, as Python
    floats: a sampler multiplies by them as constants and copies nothing
    to the device."""
    inv = inv_hs(hs)
    w = torch.tensor([-inv, inv], dtype=torch.float32).to(torch.bfloat16)
    return tuple(w.float().tolist())


def to_cells(x: torch.Tensor, hs: float) -> torch.Tensor:
    """``x / hs`` as the JAX package computes it under ``jit``: XLA folds a
    division by a constant into a multiply by its float32 reciprocal.  The
    two differ in the last bit, which decides the cell of a point that lies
    on a cell boundary (every grid-aligned spawn position does)."""
    return x * torch.full((), inv_hs(hs), dtype=x.dtype, device=x.device)


def contact_window(terrain: TerrainArrays, base_xy, px: int, py: int):
    """Window of ``extract_patches_batched_granule`` around each base.

    base_xy (N, 2) -> (xs (N,), ys (N,), PX, PY): rows [xs, xs + PX) and
    columns [ys, ys + PY) of each env's tile.  xs is granule-aligned and the
    window covers ceil(px/16)+1 granules of 16 rows; rows past the tile and
    columns past its width repeat the edge cell, as the granule table does.
    """
    h, w = terrain.tiles.shape[2], terrain.tiles.shape[3]
    n_gran_tile = -(-h // 16)
    n_gran = min(-(-px // 16) + 1, n_gran_tile)
    local = to_cells(base_xy - terrain.env_terrain_origin[:, :2], terrain.horizontal_scale)
    xs_raw = torch.clamp(local[:, 0].to(torch.int32) - px // 2, 0, max(h - px, 0))
    ys = torch.clamp(local[:, 1].to(torch.int32) - py // 2, 0, max(w - py, 0))
    g0 = torch.clamp(torch.div(xs_raw, 16, rounding_mode="floor"), 0, n_gran_tile - n_gran)
    return g0 * 16, ys, n_gran * 16, py


def sample_window_bilinear(table, env_tile, xs, ys, PX: int, PY: int, hs: float,
                           env_terrain_origin, points_xy):
    """Bilinear heights + gradients, with the semantics of
    ``sample_patch_bilinear`` on the window of :func:`contact_window`.

    table (T, 2, h, w) bf16; env_tile, xs, ys (N,); env_terrain_origin (N, 3);
    points_xy (N, P, 2) world.  Returns heights (N, P, 2) [ceiling, floor]
    and grads (N, P, 2, 2) d h / d xy.
    """
    h, w = table.shape[2], table.shape[3]
    local = to_cells(points_xy - env_terrain_origin[:, None, :2], hs)  # (N, P, 2)
    x = torch.clamp(local[..., 0], 0.0, h - 1.001) - xs[:, None]
    y = torch.clamp(local[..., 1], 0.0, w - 1.001) - ys[:, None]
    x = torch.clamp(x, 0.0, PX - 1.001)
    y = torch.clamp(y, 0.0, PY - 1.001)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = x - x0
    fy = y - y0

    # the two nonzero entries of each bf16 weight row (window columns x0, x0+1)
    bf = lambda a: a.to(torch.bfloat16).float()
    wx = torch.stack([bf(1 - fx), bf(fx)], dim=-1)                     # (N, P, 2)
    wy = torch.stack([bf(1 - fy), bf(fy)], dim=-1)
    dw = grad_weights(hs)

    # cells (x0 + i, y0 + j) of the window, i, j in {0, 1}, both layers
    off = torch.arange(2, device=x.device, dtype=torch.int32)
    rows = torch.clamp(xs[:, None, None] + x0[..., None] + off, max=h - 1)   # (N, P, 2)
    cols = torch.clamp(ys[:, None, None] + y0[..., None] + off, max=w - 1)
    layer = torch.arange(2, device=x.device, dtype=torch.int64)
    idx = (((env_tile.long()[:, None, None, None, None] * 2 + layer[:, None, None])
            * h + rows.long()[:, :, None, :, None]) * w
           + cols.long()[:, :, None, None, :])                         # (N, P, l, i, j)
    cell = table.reshape(-1)[idx].float()

    # stage 1 over x (value and x-derivative weights), rounded to bf16 as the
    # patch path stores its stage-1 sums
    A = bf(wx[:, :, None, 0, None] * cell[..., 0, :] + wx[:, :, None, 1, None] * cell[..., 1, :])
    Ax = bf(dw[0] * cell[..., 0, :] + dw[1] * cell[..., 1, :])          # (N, P, l, j)
    # stage 2 over y
    height = A[..., 0] * wy[:, :, None, 0] + A[..., 1] * wy[:, :, None, 1]
    dhdx = Ax[..., 0] * wy[:, :, None, 0] + Ax[..., 1] * wy[:, :, None, 1]
    dhdy = A[..., 0] * dw[0] + A[..., 1] * dw[1]
    return height, torch.stack([dhdx, dhdy], dim=-1)


def _gather_layers(tiles: torch.Tensor, env_tile, xi, yi) -> torch.Tensor:
    """Both layers at integer cell coords, as float32.

    tiles (T, 2, h, w) of any dtype; env_tile (...,) broadcastable against
    the leading dims of xi / yi (..., P).  Returns (..., P, 2) [ceiling,
    floor].  One flat-index gather per layer: per-point tile copies would
    cost O(N * P * h * w) memory (24 GB at 4096 envs)."""
    L, h, w = tiles.shape[1], tiles.shape[2], tiles.shape[3]
    flat = tiles.reshape(-1)
    base = env_tile.long()[..., None] * (L * h * w) + xi.long() * w + yi.long()
    return torch.stack([flat[base], flat[base + h * w]], dim=-1).float()


def sample_height_bilinear(terrain: TerrainArrays, env_tile, env_terrain_origin, points_xy):
    """Bilinear floor/ceiling heights + gradients at world-frame xy points,
    in float32 on the four cells around each point: no window, no bf16
    stage.  The flat oracle that the contact sampler
    (:func:`sample_window_bilinear`) is held to; no path of the program
    calls it.

    The arithmetic is the compiled JAX function's: ``/ hs`` is a multiply by
    the float32 reciprocal (:func:`to_cells`) and each ``a * wa + b * wb``
    one fused multiply-add, ``fma(a, wa, b * wb)``, which matches it bit for
    bit on the CPU.

    env_tile (...,); env_terrain_origin (..., 3); points_xy (..., P, 2)
    world.  Returns heights (..., P, 2) [ceiling, floor] and grads
    (..., P, 2, 2) d h / d xy.
    """
    tiles = terrain.tiles
    h, w = tiles.shape[2], tiles.shape[3]
    hs = terrain.horizontal_scale
    local = to_cells(points_xy - env_terrain_origin[..., None, :2], hs)
    x = torch.clamp(local[..., 0], 0.0, h - 1.001)
    y = torch.clamp(local[..., 1], 0.0, w - 1.001)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    h00 = _gather_layers(tiles, env_tile, x0, y0)
    h10 = _gather_layers(tiles, env_tile, x0 + 1, y0)
    h01 = _gather_layers(tiles, env_tile, x0, y0 + 1)
    h11 = _gather_layers(tiles, env_tile, x0 + 1, y0 + 1)

    hx0 = fma(h00, 1 - fy, h01 * fy)
    hx1 = fma(h10, 1 - fy, h11 * fy)
    height = fma(hx0, 1 - fx, hx1 * fx)                      # (..., P, 2)
    dhdx = to_cells(hx1 - hx0, hs)
    dhdy = to_cells(fma(h01 - h00, 1 - fx, (h11 - h10) * fx), hs)
    return height, torch.stack([dhdx, dhdy], dim=-1)          # (..., P, 2, 2)


def sample_height_nearest(terrain: TerrainArrays, env_tile, env_terrain_origin, points_xy):
    """Nearest(floor)-cell heights, the semantics of the reference height
    scan (``(points / horizontal_scale).long()`` truncation,
    legged_robot_trajectory_tracking.py:1948-1956), from the float32 tiles.
    The cell is picked with :func:`to_cells`, as the compiled JAX package
    picks it.

    env_tile (N,), env_terrain_origin (N, 3), points_xy (N, P, 2) world.
    Returns (N, P, 2) [ceiling, floor]."""
    tiles = terrain.tiles
    L, h, w = tiles.shape[1], tiles.shape[2], tiles.shape[3]
    local = to_cells(points_xy - env_terrain_origin[:, None, :2], terrain.horizontal_scale)
    x0 = torch.clamp(local[..., 0].to(torch.int32), 0, h - 2).long()
    y0 = torch.clamp(local[..., 1].to(torch.int32), 0, w - 2).long()
    base = env_tile.long()[:, None] * (L * h * w) + x0 * w + y0
    flat = tiles.reshape(-1)
    return torch.stack([flat[base], flat[base + h * w]], dim=-1)
