"""Observation height scan, plain PyTorch: the arithmetic of kernel B1
(the port's ``terrain/scan.py``), without the kernel.

For each env n and each of the P base-local scan points: ``px = (grid_x +
base_x) + cam_x``, ``lx = (px - origin_x) * inv_hs`` (likewise y), ``x0 =
clip(trunc(lx), 0, h-2)``, ``y0 = clip(trunc(ly), 0, w-2)`` and ``out[n, l,
p] = tiles[env_tile[n], l, x0, y0]`` for l in {ceiling, floor}.
"""

from __future__ import annotations

import torch

from .heightfield import to_cells


def scan_cells(tiles, env_tile, frames, grid_pts, hs: float):
    """(N, P) int64: the flat index into ``tiles.reshape(-1)`` of the
    ceiling cell each scan point reads; its floor cell is ``h * w`` further.
    Arguments as for :func:`scan_heights_reference`."""
    T, L, h, w = tiles.shape
    px = (grid_pts[None, :, 0] + frames[:, 0, 0, None]) + frames[:, 1, 0, None]
    py = (grid_pts[None, :, 1] + frames[:, 0, 1, None]) + frames[:, 1, 1, None]
    lx = to_cells(px - frames[:, 2, 0, None], hs)                    # (N, P)
    ly = to_cells(py - frames[:, 2, 1, None], hs)
    x0 = torch.clamp(lx.to(torch.int32), 0, h - 2).long()
    y0 = torch.clamp(ly.to(torch.int32), 0, w - 2).long()
    return env_tile.long()[:, None] * (L * h * w) + x0 * w + y0


def scan_heights_reference(tiles, env_tile, frames, grid_pts, hs: float):
    """Plain PyTorch version of kernel B1, the same arithmetic in the same
    order.  tiles (T, 2, h, w) bf16; env_tile (N,) int32; frames (N, 3, 2) f32
    [base_xy, camera shift, terrain origin]; grid_pts (P, 2) f32.  Returns
    (N, 2, P) f32 [ceiling, floor]."""
    h, w = tiles.shape[2:]
    cell = scan_cells(tiles, env_tile, frames, grid_pts, hs)
    flat = tiles.reshape(-1)
    return torch.stack([flat[cell], flat[cell + h * w]], dim=1).float()


def scan_heights(tiles, env_tile, frames, grid_pts, hs: float):
    """The plain version on any device (the reference runs no kernel)."""
    return scan_heights_reference(tiles, env_tile, frames, grid_pts, hs)
