"""Classic legged_gym single-layer terrain generators (numpy, init-time).

A copy of the JAX package's numpy terrain code
(``legged_tracking_tpu/terrain/legged_gym_terrains.py``) that returns the
port's :class:`TerrainArrays` on the requested device.  The numpy part is
unchanged (the same ``np.random.RandomState`` call order, float32 tiles and
origins), so the tiles are bitwise equal for the same seed.

It reimplements the semantics of the ``isaacgym.terrain_utils`` generators
that the reference velocity task uses (go1_gym/utils/terrain.py:114-159):
pyramid slopes, pyramid stairs, discrete obstacles, stepping stones and
random uniform noise, on int16 height grids scaled by ``vertical_scale``
(meters out).  The heightfield itself is the collision and scan source.
"""

from __future__ import annotations

import numpy as np
import torch

from .heightfield import TerrainArrays


class SubTerrain:
    """Height grid container (terrain_utils.SubTerrain parity)."""

    def __init__(self, width, length, vertical_scale, horizontal_scale):
        self.width = width          # pixels along x
        self.length = length        # pixels along y
        self.vertical_scale = vertical_scale
        self.horizontal_scale = horizontal_scale
        self.height_field_raw = np.zeros((width, length), dtype=np.int16)


def random_uniform_terrain(terrain, min_height, max_height, step=0.005,
                           downsampled_scale=None, rng=None):
    rng = rng or np.random
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    min_r = int(min_height / terrain.vertical_scale)
    max_r = int(max_height / terrain.vertical_scale)
    step_r = max(int(step / terrain.vertical_scale), 1)
    heights_range = np.arange(min_r, max_r + step_r, step_r)
    w_down = int(terrain.width * terrain.horizontal_scale / downsampled_scale)
    l_down = int(terrain.length * terrain.horizontal_scale / downsampled_scale)
    coarse = rng.choice(heights_range, (max(w_down, 2), max(l_down, 2)))
    # bilinear upsample to the full grid
    xs = np.linspace(0, coarse.shape[0] - 1, terrain.width)
    ys = np.linspace(0, coarse.shape[1] - 1, terrain.length)
    x0 = np.clip(xs.astype(int), 0, coarse.shape[0] - 2)
    y0 = np.clip(ys.astype(int), 0, coarse.shape[1] - 2)
    fx = (xs - x0)[:, None]
    fy = (ys - y0)[None, :]
    c00 = coarse[x0][:, y0]
    c10 = coarse[x0 + 1][:, y0]
    c01 = coarse[x0][:, y0 + 1]
    c11 = coarse[x0 + 1][:, y0 + 1]
    interp = (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
              + c01 * (1 - fx) * fy + c11 * fx * fy)
    terrain.height_field_raw += interp.astype(np.int16)
    return terrain


def pyramid_sloped_terrain(terrain, slope, platform_size=1.0):
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = terrain.width // 2, terrain.length // 2
    xx = ((cx - np.abs(cx - x)) / cx)[:, None]
    yy = ((cy - np.abs(cy - y)) / cy)[None, :]
    max_height = int(slope * (terrain.horizontal_scale / terrain.vertical_scale)
                     * (terrain.width / 2))
    terrain.height_field_raw += (max_height * xx * yy).astype(np.int16)

    half = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = cx - half, cx + half
    y1, y2 = cy - half, cy + half
    min_h = min(terrain.height_field_raw[x1, y1], 0)
    max_h = max(terrain.height_field_raw[x1, y1], 0)
    terrain.height_field_raw = np.clip(terrain.height_field_raw, min_h, max_h)
    return terrain


def pyramid_stairs_terrain(terrain, step_width, step_height, platform_size=1.0):
    step_w = int(step_width / terrain.horizontal_scale)
    step_h = int(step_height / terrain.vertical_scale)
    platform = int(platform_size / terrain.horizontal_scale)
    height = 0
    sx, ex = 0, terrain.width
    sy, ey = 0, terrain.length
    while (ex - sx) > platform and (ey - sy) > platform:
        sx += step_w
        ex -= step_w
        sy += step_w
        ey -= step_w
        height += step_h
        terrain.height_field_raw[sx:ex, sy:ey] = height
    return terrain


def discrete_obstacles_terrain(terrain, max_height, min_size, max_size,
                               num_rects, platform_size=1.0, rng=None):
    rng = rng or np.random
    max_h = int(max_height / terrain.vertical_scale)
    min_s = int(min_size / terrain.horizontal_scale)
    max_s = int(max_size / terrain.horizontal_scale)
    heights = [-max_h, -max_h // 2, max_h // 2, max_h]
    for _ in range(num_rects):
        w = rng.choice(range(min_s, max_s, 4))
        l = rng.choice(range(min_s, max_s, 4))
        sx = rng.choice(range(0, max(terrain.width - w, 1), 4))
        sy = rng.choice(range(0, max(terrain.length - l, 1), 4))
        terrain.height_field_raw[sx:sx + w, sy:sy + l] = rng.choice(heights)
    half = int(platform_size / terrain.horizontal_scale / 2)
    cx, cy = terrain.width // 2, terrain.length // 2
    terrain.height_field_raw[cx - half:cx + half, cy - half:cy + half] = 0
    return terrain


def stepping_stones_terrain(terrain, stone_size, stone_distance, max_height,
                            platform_size=1.0, depth=-10.0, rng=None):
    rng = rng or np.random
    stone = max(int(stone_size / terrain.horizontal_scale), 1)
    dist = int(stone_distance / terrain.horizontal_scale)
    max_h = int(max_height / terrain.vertical_scale)
    terrain.height_field_raw[:] = int(depth / terrain.vertical_scale)
    sx = 0
    while sx < terrain.width:
        sy = rng.randint(0, stone) if stone > 1 else 0
        # fill this row band with stones
        while sy < terrain.length:
            h = rng.randint(-max_h, max_h + 1) if max_h > 0 else 0
            terrain.height_field_raw[sx:sx + stone, sy:sy + stone] = h
            sy += stone + dist
        sx += stone + dist
    half = int(platform_size / terrain.horizontal_scale / 2)
    cx, cy = terrain.width // 2, terrain.length // 2
    terrain.height_field_raw[cx - half:cx + half, cy - half:cy + half] = 0
    return terrain


def make_legged_gym_tile(cfg, choice: float, difficulty: float, proportions,
                         rng) -> np.ndarray:
    """One sub-terrain by curriculum proportion thresholds
    (reference terrain.py:114-159).  Returns heights in meters (w, l)."""
    px = int(cfg.terrain_length / cfg.horizontal_scale)
    py = int(cfg.terrain_width / cfg.horizontal_scale)
    t = SubTerrain(px, py, cfg.vertical_scale, cfg.horizontal_scale)
    slope = difficulty * 0.4
    step_height = 0.05 + 0.18 * difficulty
    max_platform_height = getattr(cfg, "max_platform_height", 0.2)
    discrete_obstacles_height = 0.05 + difficulty * (max_platform_height - 0.05)
    stepping_stones_size = 1.5 * (1.05 - difficulty)
    stone_distance = 0.05 if difficulty == 0 else 0.1
    if choice < proportions[0]:
        if choice < proportions[0] / 2:
            slope *= -1
        pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
    elif choice < proportions[1]:
        pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
        random_uniform_terrain(t, -0.05, 0.05, step=cfg.terrain_smoothness,
                               downsampled_scale=0.2, rng=rng)
    elif choice < proportions[3]:
        if choice < proportions[2]:
            step_height *= -1
        pyramid_stairs_terrain(t, step_width=0.31, step_height=step_height,
                               platform_size=3.0)
    elif choice < proportions[4]:
        discrete_obstacles_terrain(t, discrete_obstacles_height, 1.0, 2.0, 20,
                                   platform_size=3.0, rng=rng)
    elif choice < proportions[5]:
        stepping_stones_terrain(t, stone_size=stepping_stones_size,
                                stone_distance=stone_distance, max_height=0.0,
                                platform_size=4.0, rng=rng)
    elif choice < proportions[6]:
        pass
    elif choice < proportions[7]:
        pass
    elif len(proportions) > 8 and choice < proportions[8]:
        random_uniform_terrain(t, -cfg.terrain_noise_magnitude,
                               cfg.terrain_noise_magnitude, step=0.005,
                               downsampled_scale=0.2, rng=rng)
    elif len(proportions) > 9 and choice < proportions[9]:
        random_uniform_terrain(t, -0.05, 0.05, step=cfg.terrain_smoothness,
                               downsampled_scale=0.2, rng=rng)
        t.height_field_raw[:t.width // 2, :] = 0
    return t.height_field_raw.astype(np.float32) * cfg.vertical_scale


def build_velocity_terrain(tcfg, num_envs: int, seed: int = 0, device="cuda") -> TerrainArrays:
    """Single-layer legged_gym world -> TerrainArrays (ceiling at +1e3).

    Tile assignment and origins mirror Terrain.add_terrain_to_map
    (terrain.py:161-179): env origin at the tile centre, z at the tile max.
    """
    rng = np.random.RandomState(seed)
    proportions = [float(np.sum(tcfg.terrain_proportions[:i + 1]))
                   for i in range(len(tcfg.terrain_proportions))]
    px = int(tcfg.terrain_length / tcfg.horizontal_scale)
    py = int(tcfg.terrain_width / tcfg.horizontal_scale)
    n_tiles = tcfg.num_rows * tcfg.num_cols
    tiles = np.zeros((n_tiles, 2, px, py), dtype=np.float32)
    tiles[:, 0] = 1e3
    origin_z = np.zeros(n_tiles, dtype=np.float32)
    for k in range(n_tiles):
        i, j = np.unravel_index(k, (tcfg.num_rows, tcfg.num_cols))
        if tcfg.curriculum:
            difficulty = i / tcfg.num_rows
            choice = j / tcfg.num_cols + 0.001
        else:
            choice = rng.uniform(0, 1)
            difficulty = rng.choice([0.5, 0.75, 0.9])
        tiles[k, 1] = make_legged_gym_tile(tcfg, choice, difficulty, proportions, rng)
        origin_z[k] = tiles[k, 1].max()

    # round-robin tile assignment (the reference velocity env spreads envs
    # over the tile grid; the env count need not divide by the tiles)
    env_tile = (np.arange(num_envs) % n_tiles).astype(np.int32)
    grid_r = env_tile // tcfg.num_cols
    grid_c = env_tile % tcfg.num_cols
    env_origin = np.stack([
        (grid_r + 0.5) * tcfg.terrain_length,
        (grid_c + 0.5) * tcfg.terrain_width,
        origin_z[env_tile],
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
        horizontal_scale=tcfg.horizontal_scale,
        is_plane=False,
    )
