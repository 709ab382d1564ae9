"""Runtime command sources for deployment (a copy of
``legged_tracking_tpu/deploy/command_profiles.py``; ``PlannerGoalProfile``
plans with the port's own ``utils/planner.plan``).

Ports of ``go1_gym_deploy/utils/command_profile.py``: fixed front goals,
on-robot resampled random trajectories (mirroring ``_traj_fn_random_target``),
and RC-joystick velocity commands.
"""

from __future__ import annotations

import numpy as np

from ..utils.planner import plan


class CommandProfile:
    def __init__(self, dt, max_time_s=10.0):
        self.dt = dt
        self.max_timestep = int(max_time_s / dt)
        self.commands = np.zeros(15)

    def get_command(self, t):
        return self.commands, False

    def reset(self, reset_time=None):
        pass


class DummyFrontGoalProfile(CommandProfile):
    """Fixed goal Δx ahead (reference command_profile.py:23-65)."""

    def __init__(self, dt, goal_x: float = 2.6):
        super().__init__(dt)
        self.goal = np.array([goal_x, 0.0])

    def get_command(self, t):
        cmd = np.zeros(15)
        cmd[:2] = self.goal
        return cmd, False


class RandomTrajectoryProfile(CommandProfile):
    """On-robot random 6-DoF waypoints with interpolation, resampled every
    episode — mirrors _traj_fn_random_target (reference :67-150)."""

    def __init__(self, dt, se, x_range=0.5, y_range=0.5, yaw_range=np.pi,
                 traj_length=10, switch_dist=0.3, episode_s=10.0, seed=0):
        super().__init__(dt, episode_s)
        self.se = se
        self.rng = np.random.RandomState(seed)
        self.x_range, self.y_range, self.yaw_range = x_range, y_range, yaw_range
        self.traj_length = traj_length
        self.switch_dist = switch_dist
        self.traj = None
        self.idx = 0
        self._resample()

    def _resample(self):
        n = self.traj_length + 1
        xs = self.rng.uniform(-self.x_range, self.x_range, n)
        ys = self.rng.uniform(-self.y_range, self.y_range, n)
        yaws = self.rng.uniform(-self.yaw_range, self.yaw_range, n)
        xs[0] = ys[0] = yaws[0] = 0.0
        self.traj = np.stack([xs, ys, yaws], axis=1)[1:]
        self.idx = 0

    def get_command(self, t):
        xy, yaw = self.se.get_xy_yaw()
        target = self.traj[self.idx]
        rel = target[:2] - xy
        # rotate into yaw frame
        c, s = np.cos(-yaw), np.sin(-yaw)
        rel_body = np.array([c * rel[0] - s * rel[1], s * rel[0] + c * rel[1]])
        reset = False
        if np.linalg.norm(rel_body) < self.switch_dist:
            self.idx += 1
            if self.idx >= len(self.traj):
                self._resample()
                reset = True
        cmd = np.zeros(15)
        cmd[:2] = rel_body
        return cmd, reset


class RCControllerProfile(CommandProfile):
    """Joystick velocity + gait commands (reference :238-330)."""

    def __init__(self, dt, state_estimator, x_scale=1.0, y_scale=1.0,
                 yaw_scale=1.0):
        super().__init__(dt)
        self.se = state_estimator
        self.x_scale, self.y_scale, self.yaw_scale = x_scale, y_scale, yaw_scale

    def get_command(self, t):
        cmd = self.se.get_command()
        cmd[0] *= self.x_scale
        cmd[1] *= self.y_scale
        cmd[2] *= self.yaw_scale
        return cmd, False


class ConstantAccelerationProfile(CommandProfile):
    def __init__(self, dt, max_speed, accel_time, zero_buf_time=0.0):
        super().__init__(dt)
        self.max_speed = max_speed
        self.accel_timesteps = accel_time / dt
        self.zero_buf_timesteps = zero_buf_time / dt

    def get_command(self, t):
        ts = t / self.dt
        cmd = np.zeros(15)
        if ts > self.zero_buf_timesteps:
            cmd[0] = min((ts - self.zero_buf_timesteps)
                         / self.accel_timesteps, 1.0) * self.max_speed
        return cmd, False


class PlannerGoalProfile(CommandProfile):
    """Planner-in-the-loop goal commands (the reference's archived
    deploy-with-planner experiments, scripts_archived_1/deploy_*): replans a
    waypoint path to a world-frame goal over a scanned elevation map with the
    sampling-based planner (utils/planner.plan) every ``replan_steps``, and
    feeds the next waypoint (relative, yaw-frame) to the policy like the
    other goal profiles.

    elevation_map: (2, nx, ny) [ceiling, floor] meters, map-local;
    map_origin: world xy of the map's (0, 0) pixel corner.
    """

    def __init__(self, dt, se, elevation_map, goal_xy, horizontal_scale=0.05,
                 map_origin=(0.0, 0.0), z_nominal=0.27, switch_dist=0.3,
                 replan_steps=100, seed=0):
        super().__init__(dt)
        self.se = se
        self.emap = np.asarray(elevation_map)
        self.hs = horizontal_scale
        self.map_origin = np.asarray(map_origin, dtype=np.float64)
        self.goal = np.asarray(goal_xy, dtype=np.float64)
        self.z_nominal = z_nominal
        self.switch_dist = switch_dist
        self.replan_steps = max(int(replan_steps), 1)
        self.seed = seed
        self.path = None      # (L, 4) map-local [x, y, z, yaw]
        self.idx = 0
        self._steps = 0

    def _replan(self):
        xy, yaw = self.se.get_xy_yaw()
        start = np.array([xy[0] - self.map_origin[0],
                          xy[1] - self.map_origin[1], self.z_nominal, yaw])
        goal = np.array([self.goal[0] - self.map_origin[0],
                         self.goal[1] - self.map_origin[1],
                         self.z_nominal, 0.0])
        self.path = plan(self.emap, start, goal, self.hs, seed=self.seed)
        self.idx = 1 if self.path is not None and len(self.path) > 1 else 0

    def get_command(self, t):
        if self._steps % self.replan_steps == 0:
            self._replan()
        self._steps += 1
        xy, yaw = self.se.get_xy_yaw()
        if self.path is None:            # planner found nothing: head straight
            target = self.goal
        else:
            wp = self.path[min(self.idx, len(self.path) - 1)]
            target = wp[:2] + self.map_origin
            if (np.linalg.norm(target - xy) < self.switch_dist
                    and self.idx < len(self.path) - 1):
                self.idx += 1
                wp = self.path[self.idx]
                target = wp[:2] + self.map_origin
        rel = target - xy
        c, s = np.cos(-yaw), np.sin(-yaw)
        cmd = np.zeros(15)
        cmd[0] = c * rel[0] - s * rel[1]
        cmd[1] = s * rel[0] + c * rel[1]
        return cmd, False
