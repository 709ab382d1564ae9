"""Hardware "env" agents: mirror the sim observation layout on the robot (a
copy of ``legged_tracking_tpu/deploy/lcm_agent.py``; the joint order and the
default pose come from the port's ``physics/go1_model_data.py``).

Ports of ``go1_gym_deploy/envs/lcm_traj_agent.py`` (trajectory policies) and
``lcm_agent.py`` (velocity policies): build observations from StateEstimator
state exactly as the sim ``compute_observations`` does, publish actions as
joint PD targets on ``pd_plustau_targets`` at dt = decimation * sim_dt.

Height measurements are stubbed to flat-tunnel dummies exactly like the
reference (lcm_traj_agent.py:149-163 — perception integration left open).
"""

from __future__ import annotations

import time

import numpy as np

from ..physics import go1_model_data as D
from .lcm_types import pd_tau_targets_lcmt


class LCMAgent:
    """Trajectory/velocity-policy agent (reference lcm_traj_agent.LCMAgent)."""

    def __init__(self, cfg, se, command_profile, lc):
        self.cfg = cfg
        self.se = se
        self.command_profile = command_profile
        self.lc = lc
        self.timestep = 0
        self.dt = cfg.control.decimation * cfg.sim.dt
        self.num_obs = cfg.env.num_observations
        self.num_commands = 2 if cfg.env.command_type in ("xy", "xy_norm") else \
            (6 if cfg.env.command_type == "6dof" else cfg.commands.num_commands)

        self.default_dof_pos = np.array(
            [cfg.init_state.default_joint_angles[n] for n in D.DOF_NAMES])
        self.p_gains = np.full(12, cfg.control.stiffness)
        self.d_gains = np.full(12, cfg.control.damping)
        self.commands = np.zeros((1, self.num_commands))
        self.commands_scale = np.ones(self.num_commands)
        self.actions = np.zeros((1, 12))
        self.last_actions = np.zeros((1, 12))
        self.gait_indices = np.zeros(1)
        self.clock_inputs = np.zeros((1, 4))
        self.joint_pos_target = np.zeros(12)

    def reset_gait_indices(self):
        self.gait_indices[:] = 0.0

    def get_obs(self) -> np.ndarray:
        cfg = self.cfg
        grav = self.se.get_gravity_vector()
        cmds, reset_timer = self.command_profile.get_command(self.timestep * self.dt)
        self.commands[:, :] = cmds[: self.num_commands]
        if reset_timer:
            self.reset_gait_indices()
        dof_pos = self.se.get_dof_pos()
        dof_vel = self.se.get_dof_vel()
        ob = np.concatenate([
            grav.reshape(1, -1),
            self.commands * self.commands_scale,
            (dof_pos - self.default_dof_pos).reshape(1, -1) * cfg.obs_scales.dof_pos,
            dof_vel.reshape(1, -1) * cfg.obs_scales.dof_vel,
            np.clip(self.actions, -cfg.normalization.clip_actions,
                    cfg.normalization.clip_actions),
        ], axis=1)
        if cfg.env.observe_heights:
            # perception stub: flat-tunnel dummies (reference :149-163)
            nx = len(cfg.terrain.measured_points_x)
            if cfg.terrain.measure_front_half:
                nx = nx - (nx // 2 + 1)
            ny = len(cfg.terrain.measured_points_y)
            mh = np.ones((2, nx, ny)) * cfg.terrain.ceiling_height
            mh[1] = 0.0
            ob = np.concatenate([ob, mh.reshape(1, -1)], axis=-1) \
                * cfg.obs_scales.height_measurements
        if cfg.env.observe_two_prev_actions:
            ob = np.concatenate([ob, self.last_actions], axis=1)
        if cfg.env.observe_clock_inputs:
            frequencies = self.commands[:, 4] if self.num_commands > 4 else 3.0
            self.gait_indices = np.remainder(
                self.gait_indices + self.dt * frequencies, 1.0)
            if self.num_commands > 8:
                phases, offsets, bounds = (self.commands[:, 5],
                                           self.commands[:, 6], self.commands[:, 7])
            else:
                phases = offsets = bounds = 0.0
            fi = np.stack([self.gait_indices + phases + offsets + bounds,
                           self.gait_indices + offsets,
                           self.gait_indices + bounds,
                           self.gait_indices + phases], axis=1)
            self.clock_inputs = np.sin(2 * np.pi * np.remainder(fi, 1.0))
            ob = np.concatenate([ob, self.clock_inputs], axis=1)
        if cfg.env.observe_vel:
            ob = np.concatenate([
                self.se.get_body_linear_vel().reshape(1, -1) * cfg.obs_scales.lin_vel,
                self.se.get_body_angular_vel().reshape(1, -1) * cfg.obs_scales.ang_vel,
                ob], axis=1)
        if cfg.env.observe_yaw:
            ob = np.concatenate([ob, self.se.get_yaw().reshape(1, -1)], axis=-1)
        if cfg.env.observe_contact_states:
            ob = np.concatenate([ob, self.se.get_contact_state().reshape(1, -1)], axis=-1)
        return ob.astype(np.float32)

    def publish_action(self, action, hard_reset: bool = False):
        """Policy action -> PD targets on the robot's pd_plustau_targets topic
        (reference lcm_traj_agent.publish_action:206-246)."""
        cfg = self.cfg
        msg = pd_tau_targets_lcmt()
        target = np.asarray(action).reshape(-1)[:12] * cfg.control.action_scale
        target[[0, 3, 6, 9]] *= cfg.control.hip_scale_reduction
        self.joint_pos_target = target + self.default_dof_pos
        msg.q_des = list(self.joint_pos_target[self.se.joint_idxs])
        msg.qd_des = [0.0] * 12
        msg.kp = list(self.p_gains)
        msg.kd = list(self.d_gains)
        msg.tau_ff = [0.0] * 12
        msg.se_contactState = [0.0] * 4
        msg.timestamp_us = int(time.time() * 1e6)
        msg.id = -1 if hard_reset else 0
        self.lc.publish("pd_plustau_targets", msg.encode())

    def step(self, action):
        self.last_actions = self.actions.copy()
        self.actions = np.asarray(action).reshape(1, -1)
        self.publish_action(self.actions)
        # pace the control loop at dt
        time.sleep(max(self.dt - 0.002, 0))
        self.timestep += 1
        return self.get_obs()
