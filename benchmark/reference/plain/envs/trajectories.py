"""Batched waypoint generators (port of ``envs/trajectories.py``).

Each returns ``(N, traj_length, 6)`` poses ``[x, y, z, roll, pitch, yaw]`` in
world frame (reference ``TrajectoryFunctions``,
go1_gym/envs/trajectories/trajectory_function.py:10-93), and takes
``(draw, tag, base_pos, cfg, terrain, target_dist)``: ``draw`` is the env's
:meth:`~.legged_env.LeggedEnv.draw` and ``tag`` the key its draws hang from
(the JAX env's ``fold_in(keys, 14)``); an element ``("split", n, i)`` of a
tag names the i-th of ``jax.random.split(key, n)``.  ``target_dist`` (N, 1)
is the goal distance of the fix-target curriculum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..terrain.heightfield import to_cells
from ..utils.math import fma as _fma


def _uniform(draw, tag, shape):
    """U[0, 1) under ``tag`` (the JAX package's ``jax.random.uniform(k, shape)``)."""
    return draw(tag, shape, 0.0, 1.0)


def fixed_target(draw, tag, base_pos, cfg, terrain, target_dist):
    """Fixed delta between waypoints (trajectory_function.py:14-26)."""
    c = cfg.commands
    L = c.traj_length
    N = base_pos.shape[0]
    n = torch.arange(1, L + 1, dtype=torch.float32, device=base_pos.device)[None, :]
    base_x = target_dist if cfg.curriculum_thresholds.cl_fix_target else c.base_x
    x = n * base_x + base_pos[:, 0:1]
    y = n * c.base_y + base_pos[:, 1:2]
    full = lambda v: torch.full((N, L), v, dtype=torch.float32, device=base_pos.device)
    return torch.stack([x, y, full(c.base_z), full(c.base_roll), full(c.base_pitch),
                        full(0.0)], dim=-1)


def random_goal(draw, tag, base_pos, cfg, terrain, target_dist):
    """Random xy goal and random yaw (trajectory_function.py:28-40).  Each
    ``u * range + offset`` is one fused multiply-add, as compiled in the JAX
    package."""
    c = cfg.commands
    L = c.traj_length
    N = base_pos.shape[0]
    ux, uy, uyaw = (_uniform(draw, tag + (("split", 3, i),), (N, L)) for i in range(3))
    x_mean = target_dist if cfg.curriculum_thresholds.cl_fix_target else c.x_mean
    f32 = np.float32
    x = _fma(ux - 0.5, f32(c.x_range), x_mean) + base_pos[:, 0:1]
    y = _fma(uy - 0.5, f32(c.y_range), f32(c.y_mean)) + base_pos[:, 1:2]
    yaw = _fma(uyaw * 2, f32(c.yaw_range), -f32(c.yaw_range))
    z = torch.full_like(x, c.base_z)
    zero = torch.zeros_like(x)
    return torch.stack([x, y, z, zero, zero, yaw], dim=-1)


def linspace_f32(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` as the JAX package's jitted env
    computes it, bitwise: XLA folds the constant expression
    ``start * (1 - i / div) + stop * i / div`` into ``start * (1 - i * r) +
    i * (stop * r)`` with ``r`` the float32 reciprocal of ``div``, and sets
    the last point to ``stop``.  ``torch.linspace`` and an eager
    ``jnp.linspace`` (which contracts into a fused multiply-add) differ from
    it in the last ulp.  Computed in numpy float32, where nothing fuses."""
    f32 = np.float32
    a, b = f32(start), f32(stop)
    if num == 1:
        out = np.array([a])
    else:
        r = f32(1) / f32(num - 1)
        i = np.arange(num - 1, dtype=f32)
        out = np.append(a * (f32(1) - i * r) + i * (b * r), b)
    return torch.as_tensor(out.astype(f32), device=device)


def valid_goal(draw, tag, base_pos, cfg, terrain, target_dist):
    """Goal at the y of the widest floor-to-ceiling opening at a random x
    (trajectory_function.py:42-67).  ``x / hs`` is the JAX package's jitted
    ``x * float32(1 / hs)`` (``to_cells``), and its multiply-adds are fused,
    as compiled."""
    c = cfg.commands
    L = c.traj_length
    N = base_pos.shape[0]
    tiles = terrain.tiles                               # (T, 2, h, w)
    h, w = tiles.shape[2], tiles.shape[3]
    origin = terrain.env_terrain_origin
    x_mean = target_dist if cfg.curriculum_thresholds.cl_fix_target else c.x_mean
    x = _fma(_uniform(draw, tag, (N, L)) - 0.5, np.float32(c.x_range), x_mean)
    x = x + base_pos[:, 0:1] - origin[:, 0:1]
    xp = torch.clamp(to_cells(x, terrain.horizontal_scale).to(torch.int32), 0, h - 1).long()
    tile = terrain.env_tile.long()[:, None]
    row = tiles[tile, 0, xp] - tiles[tile, 1, xp]       # (N, L, w) openings
    # the tent that breaks ties between equal openings toward the middle
    edge = (torch.clamp(linspace_f32(-0.01, 0.01, w, base_pos.device), 0, 1)
            + torch.clamp(linspace_f32(0.01, -0.01, w, base_pos.device), 0, 1))
    yp = torch.argmax(row - edge, dim=-1)
    x = x + origin[:, 0:1]
    y = _fma(yp.to(torch.float32), np.float32(terrain.horizontal_scale), origin[:, 1:2])
    z = torch.full_like(x, c.base_z)
    zero = torch.zeros_like(x)
    return torch.stack([x, y, z, zero, zero, zero], dim=-1)


def random_target(draw, tag, base_pos, cfg, terrain, target_dist):
    """Random 6-DoF waypoints with linear interpolation
    (trajectory_function.py:70-93)."""
    c = cfg.commands
    ni = c.num_interpolation
    if c.traj_length % ni:
        raise ValueError(f"traj_length {c.traj_length} is not a multiple of "
                         f"num_interpolation {ni}")
    nt = c.traj_length // ni + 1
    N = base_pos.shape[0]
    dev = base_pos.device
    ranges = np.asarray([c.x_range, c.y_range, c.z_range,
                         c.roll_range, c.pitch_range, c.yaw_range], np.float32)
    dims = [_fma(_uniform(draw, tag + (("split", 6, i),), (N, nt)) * 2, ranges[i], -ranges[i])
            for i in range(6)]
    tp = torch.stack(dims, dim=-1)                       # (N, nt, 6)
    tp = torch.cat([torch.zeros_like(tp[:, :1]), tp[:, 1:]], dim=1)
    # / ni is a multiply by the float32 reciprocal once compiled
    delta = (tp[:, 1:] - tp[:, :-1]) * float(np.float32(1) / np.float32(ni))
    steps = torch.arange(1, ni + 1, dtype=torch.float32, device=dev)
    interp = tp[:, :-1, None, :] + steps[None, None, :, None] * delta[:, :, None, :]
    interp = interp.reshape(N, -1, 6)                    # (N, traj_length, 6)
    return torch.cat([interp[..., :3] + base_pos[:, None, :], interp[..., 3:]], dim=-1)


TRAJ_FUNCTIONS = {
    "fixed_target": fixed_target,
    "random_goal": random_goal,
    "valid_goal": valid_goal,
    "random_target": random_target,
}
