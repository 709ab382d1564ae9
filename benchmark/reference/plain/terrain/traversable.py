"""The tunnel's traversability check, which the terrain build runs on each
tile (the reference's planner.valid_checking, planner.py:467-499): a grid
search at crawl height over the poses where the robot's ellipsoid clears
both layers."""

from __future__ import annotations

from collections import deque

import numpy as np

# the robot's half extents (reference :1212)
ROBOT_SIZE = np.array([0.3762, 0.0935, 0.114])


def _pose_valid(elevation_map, hs, x, y, z, yaw, robot_size=ROBOT_SIZE):
    """Pose collision check against the (2, nx, ny) elevation map (meters).

    The terrain is solid below the floor layer and above the ceiling layer,
    so a yaw-aligned robot ellipsoid at (x, y, z) is free iff for every map
    column inside its footprint ellipse the vertical robot extent
    [z - h, z + h] (h from the ellipsoid cross-section) clears both layers.
    """
    nx, ny = elevation_map.shape[1:]
    r = int(np.ceil(max(robot_size[:2]) / hs)) + 1
    xi = int(round(x / hs))
    yi = int(round(y / hs))
    x0, x1 = max(xi - r, 0), min(xi + r + 1, nx)
    y0, y1 = max(yi - r, 0), min(yi + r + 1, ny)
    if x0 >= x1 or y0 >= y1:
        return False
    gx, gy = np.meshgrid(np.arange(x0, x1) * hs, np.arange(y0, y1) * hs, indexing="ij")
    dx0, dy0 = gx - x, gy - y
    c, s = np.cos(-yaw), np.sin(-yaw)
    dx = c * dx0 - s * dy0
    dy = s * dx0 + c * dy0
    q = (dx / robot_size[0]) ** 2 + (dy / robot_size[1]) ** 2
    inside = q < 1.0
    if not inside.any():
        return True
    h = robot_size[2] * np.sqrt(np.clip(1.0 - q, 0.0, None))
    floor = elevation_map[1, x0:x1, y0:y1]
    ceil = elevation_map[0, x0:x1, y0:y1]
    ok = (floor <= z - h + 1e-6) & (ceil >= z + h - 1e-6)
    return bool(np.all(ok[inside]))


def valid_checking(elevation_map, start_state, goal_state, env_length, env_width,
                   terrain_ratio_y, horizontal_scale, crawl_height: float = 0.27) -> bool:
    """Tunnel traversability via grid BFS (reference planner.valid_checking,
    :467-499).

    elevation_map: (2, nx, ny) meters with x along the tunnel.  start/goal
    follow the reference convention: x measured from the tunnel centre.
    env_length, env_width and terrain_ratio_y are the reference's signature
    and unused, as in the JAX package.
    """
    nx, ny = elevation_map.shape[1:]
    hs = horizontal_scale
    # validity grid at crawl height, yaw = 0
    free = np.zeros((nx, ny), dtype=bool)
    for i in range(nx):
        for j in range(ny):
            z = elevation_map[1, i, j] + crawl_height
            free[i, j] = _pose_valid(elevation_map, hs, i * hs, j * hs, z, 0.0)

    def to_idx(state):
        xi = int(round((state[0] + nx * hs / 2.0) / hs))
        yi = int(round((state[1] + ny * hs / 2.0) / hs))
        return (np.clip(xi, 0, nx - 1), np.clip(yi, 0, ny - 1))

    si, gi = to_idx(start_state), to_idx(goal_state)
    if not free[si]:
        # snap to the nearest free cell in the start column region
        cands = np.argwhere(free[max(si[0] - 2, 0): si[0] + 3])
        if len(cands) == 0:
            return False
        si = (cands[0][0] + max(si[0] - 2, 0), cands[0][1])
    seen = np.zeros_like(free)
    q = deque([si])
    seen[si] = True
    while q:
        i, j = q.popleft()
        if i >= gi[0]:          # reached the goal end of the tunnel
            return True
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ii, jj = i + di, j + dj
            if 0 <= ii < nx and 0 <= jj < ny and free[ii, jj] and not seen[ii, jj]:
                seen[ii, jj] = True
                q.append((ii, jj))
    return False
