"""Tunnel terrain generation: two-layer (ceiling + floor) heightfields.

A copy of the JAX package's numpy builder (``legged_tracking_tpu/terrain/
tunnel.py``) that returns torch tensors on the requested device; the numpy
part is unchanged, so the tiles are bitwise equal.

Host-side (numpy) world building, mirroring the semantics of the reference
``go1_gym/utils/tunnel.py`` + ``tunnel_fn.py``: a grid of
``num_rows x num_cols`` sub-terrain tiles; each tile has a generated obstacle
window of size ``terrain_ratio_x x terrain_ratio_y`` centred in the tile, a
flat floor inside the tunnel, a raised (0.5 m) floor border outside the window
(the tunnel side walls, tunnel.py:81), and a ceiling obstacle field flipped
down from ``ceiling_height`` and clipped to stay >= 0.05 m off the ground
(tunnel.py:96-98).

The output is a :class:`TerrainArrays` — tiles as one ``(T, 2, h, w)``
tensor that the engine queries with pure gathers.  No trimesh conversion is
needed (the reference converts to trimesh only because PhysX requires meshes,
tunnel.py:128-147).
"""

from __future__ import annotations

import numpy as np
import torch

from .traversable import valid_checking
from .heightfield import TerrainArrays, plane_terrain


def _quantize(h_meters: np.ndarray, vertical_scale: float) -> np.ndarray:
    """Match the reference's int16 heightfield storage: heights are truncated
    to integer multiples of vertical_scale (tunnel_fn.py:95,161,579)."""
    return (h_meters / vertical_scale).astype(np.int64).astype(np.float64) * vertical_scale


def _wedge_field(rng, means, half_w, half_l, pixel_x, pixel_y, length_m, width_m):
    """Height of a union of 4-sided wedges (pyramids with rectangular base).

    means: (K, 3) apex (x=width-coord, y=length-coord, z=height);
    half_w/half_l: (K,) base half extents.  Evaluated on the tile grid.
    Mirrors the plane-union construction of tunnel_fn.vec_plane_from_points
    (tunnel_fn.py:3-21) without the intermediate per-plane point stacking.
    """
    # grid coordinates: rows = length axis, cols = width axis
    wv = np.linspace(-width_m / 2.0, width_m / 2.0, pixel_y)
    lv = np.linspace(-length_m / 2.0, length_m / 2.0, pixel_x)
    W, L = np.meshgrid(wv, lv)  # (pixel_x, pixel_y)

    field = np.zeros((pixel_x, pixel_y))
    for (mx, my, mz), hw, hl in zip(means, half_w, half_l):
        # four planes through apex (mx,my,mz) and base edges at z=0
        # plane along +x edge: z = mz * (1 - (x-mx)/hw) etc.; wedge height is
        # the min over the four planes, clipped at 0
        zx_pos = mz * (1.0 - (W - mx) / hw)
        zx_neg = mz * (1.0 + (W - mx) / hw)
        zy_pos = mz * (1.0 - (L - my) / hl)
        zy_neg = mz * (1.0 + (L - my) / hl)
        h = np.minimum(np.minimum(zx_pos, zx_neg), np.minimum(zy_pos, zy_neg))
        field = np.maximum(field, np.clip(h, 0.0, None))
    return field


def _box_field(rng, means, half_w, half_l, pixel_x, pixel_y, length_m, width_m, hs):
    """Axis-aligned box obstacles (narrow_path, tunnel_fn.py:78-87).

    The reference indexes pixel windows as int((c - e/2)/hs):int((c + e/2)/hs)
    from the array origin with *negative coordinates wrapping python-style*;
    coordinates there are tile-centred, so we translate to the centred grid.
    """
    field = np.zeros((pixel_x, pixel_y))
    for (mx, my, mz), hw, hl in zip(means, half_w, half_l):
        # reference: rows indexed by the first ("x") coord, cols by second.
        x_low, x_high = int((mx - hw) / hs), int((mx + hw) / hs)
        y_low, y_high = int((my - hl) / hs), int((my + hl) / hs)
        field[x_low:x_high, y_low:y_high] = mz
    return field


def _path_obstacle_params(rng, num_y, top, p_flat):
    """Shared single_path / narrow_path obstacle sampling (tunnel_fn.py:50-76).

    Returns (means (K,3), lw_low, lw_high). Note the reference's quirky
    ``np.random.uniform(mean_x)`` draw: z ~ U(mean_off, 1) elementwise.
    """
    p1 = rng.uniform()
    if top:
        offset_y = rng.uniform(-0.6, 0.6, size=(num_y, 1))
        offset_x = rng.uniform(-0.3, 0.3, size=(num_y, 1))
        h_a, h_b = (0.4, 0.7) if p1 < p_flat else (0.0, 0.0)
        lw_low, lw_high = 0.2, 0.4
    else:
        offset_y = rng.uniform(-0.4, 0.4, size=(num_y, 1))
        offset_x = rng.uniform(-0.2, 0.2, size=(num_y, 1))
        h_a, h_b = (0.15, 0.3) if p1 < p_flat else (0.0, 0.0)
        lw_low, lw_high = 0.1, 0.3
    # one obstacle column at the tile centre (linspace(-w/2,w/2,3)[1:-1] == [0])
    mean_x = np.zeros((num_y, 1)) + offset_x
    mean_y = np.zeros((num_y, 1)) + offset_y
    u = rng.uniform(low=mean_x, high=1.0)  # NB: low may exceed... matches ref draw
    mean_z = u * (h_a - h_b) + h_b
    means = np.stack([mean_x.ravel(), mean_y.ravel(), mean_z.ravel()], axis=1)
    return means, lw_low, lw_high


def single_path_field(rng, pixel_x, pixel_y, hs, vs, p_flat, p_double, top,
                      length_m, width_m):
    """Wedge obstacles on the tunnel path (tunnel_fn.single_path, :99-163)."""
    num_y = 2 if rng.uniform() < p_double else 1
    means, lw_low, lw_high = _path_obstacle_params(rng, num_y, top, p_flat)
    half_w, half_l = rng.uniform(low=lw_low, high=lw_high, size=(2, means.shape[0]))
    field = _wedge_field(rng, means, half_w, half_l, pixel_x, pixel_y, length_m, width_m)
    if not top:
        field[0, :] = 0.5
        field[-1, :] = 0.5
        field[:, 0] = 0.5
        field[:, -1] = 0.5
    return _quantize(field, vs)


def narrow_path_field(rng, pixel_x, pixel_y, hs, vs, p_flat, p_double, top,
                      length_m, width_m):
    """Box obstacles on the tunnel path (tunnel_fn.narrow_path, :44-97)."""
    num_y = 2 if rng.uniform() < p_double else 1
    means, lw_low, lw_high = _path_obstacle_params(rng, num_y, top, p_flat)
    half_w, half_l = rng.uniform(low=lw_low / 2, high=lw_high / 2, size=(2, means.shape[0]))
    field = _box_field(rng, means, half_w, half_l, pixel_x, pixel_y, length_m, width_m, hs)
    if not top:
        field[0, :] = 0.5
        field[-1, :] = 0.5
        field[:, 0] = 0.5
        field[:, -1] = 0.5
    return _quantize(field, vs)


def random_pyramid_field(rng, pixel_x, pixel_y, hs, vs, num_x, num_y,
                         var_x, var_y, length_min, length_max,
                         height_min, height_max, length_m, width_m):
    """Grid of randomly perturbed pyramids (tunnel_fn.random_pyramid, :546-581)."""
    mean_l = np.linspace(-length_m / 2, length_m / 2, num_x + 2)
    mean_w = np.linspace(-width_m / 2, width_m / 2, num_y + 2)
    ML, MW = np.meshgrid(mean_l, mean_w)
    ML = np.clip(ML + rng.uniform(-var_x, var_x, ML.shape), -length_m / 2, length_m / 2)
    MW = np.clip(MW + rng.uniform(-var_y, var_y, MW.shape), -width_m / 2, width_m / 2)
    MZ = rng.uniform(height_min, height_max, size=ML.shape)
    # reference means are (x=length-coord?, ...) — it passes (mean_x from
    # linspace over l) as the first coordinate which multiplies the width
    # axis of the eval grid; replicate that coupling exactly:
    means = np.stack([ML.ravel(), MW.ravel(), MZ.ravel()], axis=1)
    half_w, half_l = rng.uniform(low=length_min, high=length_max, size=(2, means.shape[0]))
    field = _wedge_field(rng, means, half_w, half_l, pixel_x, pixel_y, length_m, width_m)
    return _quantize(field, vs)


def random_uniform_field(rng, pixel_x, pixel_y, hs, vs, difficulty):
    """Random rough field (tunnel.py:155-162 'random' branch)."""
    min_height = -0.05 - 0.05 * difficulty
    step = 0.005 + 0.005 * difficulty
    levels = np.arange(min_height, 0.05 + step, step)
    field = rng.choice(levels, size=(pixel_x, pixel_y))
    return _quantize(field, vs)


def even_tile_grid(num_envs: int, most: int) -> int:
    """The largest g <= ``most`` whose g x g tiles ``num_envs`` envs fill
    evenly, as :func:`build_tunnel_terrain` assigns them (1 at worst)."""
    g = most
    while g > 1 and num_envs % (g * g):
        g -= 1
    return g


def build_tunnel_terrain(tcfg, num_envs: int, seed: int = 0, device="cuda") -> TerrainArrays:
    """Build the tunnel world -> TerrainArrays.

    Mirrors Terrain.__init__ (reference tunnel.py:52-147) + _get_env_origins
    (legged_robot_trajectory_tracking.py:1808-1847): envs are assigned
    round-robin over the (num_rows x num_cols) tile grid (grid repeat order).
    """
    rng = np.random.RandomState(seed)
    hs, vs = tcfg.horizontal_scale, tcfg.vertical_scale
    length_px = int(tcfg.terrain_length / hs)
    width_px = int(tcfg.terrain_width / hs)
    win_x = int(length_px * tcfg.terrain_ratio_x)
    win_y = int(width_px * tcfg.terrain_ratio_y)
    win_len_m = tcfg.terrain_length * tcfg.terrain_ratio_x
    win_wid_m = tcfg.terrain_width * tcfg.terrain_ratio_y

    n_tiles = tcfg.num_rows * tcfg.num_cols
    tiles = np.zeros((n_tiles, 2, length_px, width_px), dtype=np.float32)
    tiles[:, 0] = tcfg.ceiling_height          # default ceiling everywhere
    tiles[:, 1] = 0.5                          # raised floor border (walls)

    def gen(top: bool, difficulty: float):
        if tcfg.terrain_type in ("single_path", "multi_path"):
            # multi_path is unimplemented in the reference (README.md:9);
            # fall back to single_path semantics.
            return single_path_field(rng, win_x, win_y, hs, vs, tcfg.p_flat,
                                     tcfg.p_double, top, win_len_m, win_wid_m)
        if tcfg.terrain_type == "narrow_path":
            return narrow_path_field(rng, win_x, win_y, hs, vs, tcfg.p_flat,
                                     tcfg.p_double, top, win_len_m, win_wid_m)
        if tcfg.terrain_type == "random_pyramid":
            if difficulty < 0.25:
                d_num = 2
            elif difficulty < 0.625:
                d_num = 1
            else:
                d_num = 0
            sub = tcfg.top if top else tcfg.bottom
            return random_pyramid_field(
                rng, win_x, win_y, hs, vs,
                sub.pyramid_num_x - d_num, sub.pyramid_num_y - d_num,
                sub.pyramid_var_x, sub.pyramid_var_y,
                sub.pyramid_length_min, sub.pyramid_length_max,
                sub.pyramid_height_min, sub.pyramid_height_max,
                win_len_m, win_wid_m)
        if tcfg.terrain_type == "random":
            return random_uniform_field(rng, win_x, win_y, hs, vs, difficulty)
        raise ValueError(f"unknown terrain_type {tcfg.terrain_type}")

    # paste windows into tile centres
    sx = int(round((0.5 - tcfg.terrain_ratio_x / 2.0) * length_px, 4))
    sy = int((0.5 - tcfg.terrain_ratio_y / 2.0) * width_px)
    for k in range(n_tiles):
        difficulty = rng.uniform(0.0, 1.0)
        valid = False
        while not valid:
            top = gen(True, difficulty)
            bottom = gen(False, difficulty)
            # ceiling flip + minimum ground clearance (tunnel.py:96-98)
            top = np.clip(tcfg.ceiling_height - top, 0.05, None)
            valid = True
            if tcfg.valid_tunnel_only:
                # traversability check (tunnel.py:107-124; OMPL there)
                start = np.array([-0.375 * win_len_m, 0, 0.27, 0, 0, 0, 1.0])
                goal = np.array([0.375 * win_len_m, 0, 0.27, 0, 0, 0, 1.0])
                valid = valid_checking(np.stack([top, bottom]), start, goal,
                                       tcfg.terrain_length, tcfg.terrain_width,
                                       tcfg.terrain_ratio_y, hs)
        tiles[k, 0, sx:sx + win_x, sy:sy + win_y] = top
        tiles[k, 1, sx:sx + win_x, sy:sy + win_y] = bottom

    # env assignment: row-major tile grid repeated m times
    assert num_envs % n_tiles == 0, (num_envs, tcfg.num_rows, tcfg.num_cols)
    m = num_envs // n_tiles
    grid_r, grid_c = np.meshgrid(np.arange(tcfg.num_rows), np.arange(tcfg.num_cols),
                                 indexing="ij")
    grid_r = np.tile(grid_r.ravel(), m)
    grid_c = np.tile(grid_c.ravel(), m)
    env_tile = (grid_r * tcfg.num_cols + grid_c).astype(np.int32)

    # origins (tunnel.py:211-217)
    env_origin = np.stack([
        (grid_r + 0.5 - tcfg.start_loc) * tcfg.terrain_length,
        (grid_c + 0.5) * tcfg.terrain_width,
        np.zeros_like(grid_r, dtype=np.float64),
    ], axis=-1).astype(np.float32)
    env_terrain_origin = np.stack([
        grid_r * tcfg.terrain_length,
        grid_c * tcfg.terrain_width,
        np.zeros_like(grid_r, dtype=np.float64),
    ], axis=-1).astype(np.float32)

    t = lambda a: torch.as_tensor(a, device=device)
    return TerrainArrays(
        tiles=t(tiles),
        env_tile=t(env_tile),
        env_origin=t(env_origin),
        env_terrain_origin=t(env_terrain_origin),
        horizontal_scale=hs,
        is_plane=False,
        ceiling_top=float(tcfg.ceiling_height),
    )


def build_terrain(cfg, num_envs: int, seed: int = 0, device="cuda") -> TerrainArrays:
    """Dispatch on mesh_type (reference create_sim, :592-614)."""
    if cfg.terrain.mesh_type == "plane":
        return plane_terrain(num_envs, env_spacing=cfg.env.env_spacing, device=device)
    return build_tunnel_terrain(cfg.terrain, num_envs, seed, device=device)
