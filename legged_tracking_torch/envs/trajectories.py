"""Batched waypoint generators (port of ``envs/trajectories.py``).

Each returns ``(N, traj_length, 6)`` poses ``[x, y, z, roll, pitch, yaw]`` in
world frame (reference ``TrajectoryFunctions``,
go1_gym/envs/trajectories/trajectory_function.py:10-93).  Only
``fixed_target``, the main path's goal, is ported so far.
"""

from __future__ import annotations

import torch


def fixed_target(base_pos, cfg, target_dist):
    """Fixed delta between waypoints (trajectory_function.py:14-26), for all
    envs: base_pos (N, 3) -> (N, L, 6).  ``target_dist`` (a () tensor)
    overrides base_x when the fix-target curriculum is active."""
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


TRAJ_FUNCTIONS = {
    "fixed_target": fixed_target,
}
