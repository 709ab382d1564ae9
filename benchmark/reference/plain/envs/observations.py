"""Observation assembly, privileged observations, and the noise scale vector
(port of ``envs/observations.py``).

The obs layout is identical to the JAX package's and the reference's
(``compute_observations`` / ``_get_noise_scale_vec``, reference
legged_robot_trajectory_tracking.py:357-590, 1086-1166).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.math import get_scale_shift


def command_dim(cfg) -> int:
    if cfg.env.command_type in ("xy", "xy_norm"):
        return 2
    if cfg.env.command_type == "6dof":
        return 6
    return cfg.commands.num_commands           # velocity task (15-dim)


def num_scalar_obs(cfg) -> int:
    n = 3 + 12 + 12 + cfg.env.num_actions      # gravity, dof pos/vel, actions
    if cfg.env.observe_command:
        n += command_dim(cfg)
    if cfg.env.timestep_in_obs:
        n += 1
    if cfg.env.observe_two_prev_actions:
        n += cfg.env.num_actions
    if cfg.env.observe_timing_parameter:
        n += 1
    if cfg.env.observe_clock_inputs:
        n += 4
    if cfg.env.observe_vel:
        n += 6
    if cfg.env.observe_only_ang_vel:
        n += 3
    if cfg.env.observe_only_lin_vel:
        n += 3
    if cfg.env.observe_yaw:
        n += 1
    if cfg.env.observe_contact_states:
        n += 4
    return n


def num_height_obs(cfg) -> int:
    if not cfg.env.observe_heights:
        return 0
    nx = len(cfg.terrain.measured_points_x)
    ny = len(cfg.terrain.measured_points_y)
    if cfg.terrain.measure_front_half:
        nx = nx - (nx // 2 + 1)
    return 2 * nx * ny


def num_obs(cfg) -> int:
    return num_scalar_obs(cfg) + num_height_obs(cfg)


def num_privileged_obs(cfg) -> int:
    e = cfg.env
    n = 0
    n += 1 if e.priv_observe_friction else 0
    n += 1 if e.priv_observe_ground_friction else 0
    n += 1 if e.priv_observe_restitution else 0
    n += 1 if e.priv_observe_base_mass else 0
    n += 3 if e.priv_observe_com_displacement else 0
    n += 12 if e.priv_observe_motor_strength else 0
    n += 12 if e.priv_observe_motor_offset else 0
    n += 1 if e.priv_observe_body_height else 0
    n += 3 if e.priv_observe_body_velocity else 0
    n += 3 if e.priv_observe_gravity else 0
    n += 1 if e.priv_observe_Kp_factor else 0
    n += 1 if e.priv_observe_Kd_factor else 0
    return n


def height_obs(cfg, measured_heights, base_z, camera_pitch):
    """Front-half slice + camera_zero normalization (reference :388-423).

    measured_heights: (N, 2, nx, ny); returns (N, num_height_obs).
    """
    nx = measured_heights.shape[2]
    x_start = nx // 2 + 1 if cfg.terrain.measure_front_half else 0
    front = measured_heights[:, :, x_start:, :]
    if cfg.env.camera_zero:
        cam_off = float(np.linalg.norm([0.12, 0.0, 0.0]))
        front = front - base_z[:, None, None, None]
        front = front - (torch.sin(camera_pitch) * cam_off)[:, None, None, None]
        front = torch.clamp(front, -0.3, 0.3)
    else:
        front = torch.clamp(front, 0.0, cfg.terrain.ceiling_height)
        front = front / cfg.terrain.ceiling_height - 0.5
    return front.reshape(front.shape[0], -1) * cfg.obs_scales.height_measurements


def scalar_obs(cfg, *, projected_gravity, commands, dof_pos, default_dof_pos,
               dof_vel, actions, episode_length):
    """The scalar block in reference concatenation order (:360-469)."""
    parts = [projected_gravity]
    if cfg.env.observe_command:
        parts.append(commands)
    parts += [
        (dof_pos - default_dof_pos) * cfg.obs_scales.dof_pos,
        dof_vel * cfg.obs_scales.dof_vel,
        actions,
    ]
    if cfg.env.timestep_in_obs:
        parts.append((episode_length[:, None] / cfg.env.max_episode_length).float())
    return torch.cat(parts, dim=-1)


def assemble_obs(cfg, scalars, heights, *, base_lin_vel, base_ang_vel,
                 base_quat, last_actions, foot_contact_z,
                 gait_indices=None, clock_inputs=None):
    """The obs vector: scalars, heights, and the optional previous-action,
    gait-clock (velocity task), velocity, yaw and contact blocks."""
    parts = [scalars]
    if cfg.env.observe_heights:
        parts.append(heights)
    if cfg.env.observe_two_prev_actions:
        parts.append(last_actions)
    if cfg.env.observe_timing_parameter:
        parts.append(gait_indices[:, None])
    if cfg.env.observe_clock_inputs:
        parts.append(clock_inputs)
    obs = torch.cat(parts, dim=-1)
    if cfg.env.observe_vel:
        obs = torch.cat([base_lin_vel * cfg.obs_scales.lin_vel,
                         base_ang_vel * cfg.obs_scales.ang_vel, obs], dim=-1)
    if cfg.env.observe_only_ang_vel:
        obs = torch.cat([base_ang_vel * cfg.obs_scales.ang_vel, obs], dim=-1)
    if cfg.env.observe_only_lin_vel:
        obs = torch.cat([base_lin_vel * cfg.obs_scales.lin_vel, obs], dim=-1)
    if cfg.env.observe_yaw:
        from ..utils import quat as qt
        fwd = qt.quat_apply(base_quat, torch.tensor([1.0, 0.0, 0.0], device=base_quat.device))
        heading = torch.atan2(fwd[:, 1], fwd[:, 0])[:, None]
        obs = torch.cat([obs, heading], dim=-1)
    if cfg.env.observe_contact_states:
        obs = torch.cat([obs, (foot_contact_z > 1.0).float()], dim=-1)
    return obs


def noise_scale_vec(cfg) -> np.ndarray:
    """Per-dim noise amplitudes (reference _get_noise_scale_vec, :1086-1166)."""
    ns, lvl, os_ = cfg.noise_scales, cfg.noise.noise_level, cfg.obs_scales
    vec = [np.ones(3) * ns.gravity * lvl]
    if cfg.env.observe_command:
        vec.append(np.zeros(command_dim(cfg)))
    vec += [
        np.ones(12) * ns.dof_pos * lvl * os_.dof_pos,
        np.ones(12) * ns.dof_vel * lvl * os_.dof_vel,
        np.zeros(cfg.env.num_actions),
    ]
    if cfg.env.timestep_in_obs:
        vec.append(np.zeros(1))
    if cfg.env.observe_heights:
        vec.append(np.zeros(num_height_obs(cfg)))
    if cfg.env.observe_two_prev_actions:
        vec.append(np.zeros(cfg.env.num_actions))
    if cfg.env.observe_timing_parameter:
        vec.append(np.zeros(1))
    if cfg.env.observe_clock_inputs:
        vec.append(np.zeros(4))
    v = np.concatenate(vec)
    if cfg.env.observe_vel:
        v = np.concatenate([np.ones(3) * ns.lin_vel * lvl * os_.lin_vel,
                            np.ones(3) * ns.ang_vel * lvl * os_.ang_vel, v])
    if cfg.env.observe_only_ang_vel:
        v = np.concatenate([np.ones(3) * ns.ang_vel * lvl * os_.ang_vel, v])
    if cfg.env.observe_only_lin_vel:
        v = np.concatenate([np.ones(3) * ns.lin_vel * lvl * os_.lin_vel, v])
    if cfg.env.observe_yaw:
        v = np.concatenate([v, np.zeros(1)])
    if cfg.env.observe_contact_states:
        v = np.concatenate([v, np.ones(4) * ns.contact_states * lvl])
    return v.astype(np.float32)


def privileged_obs(cfg, *, friction, restitution, payload, com_displacement,
                   motor_strength, motor_offset, kp_factor, kd_factor,
                   base_z, base_lin_vel, gravity_vec):
    """Privileged vector in reference flag order (:482-587), each term
    normalized by get_scale_shift of its normalization range."""
    nm = cfg.normalization
    parts = []

    def norm1(x, rng):
        scale, shift = get_scale_shift(rng)
        return (x - shift) * scale

    e = cfg.env
    if e.priv_observe_friction:
        parts.append(norm1(friction, nm.friction_range)[:, None])
    if e.priv_observe_restitution:
        parts.append(norm1(restitution, nm.restitution_range)[:, None])
    if e.priv_observe_base_mass:
        parts.append(norm1(payload, nm.added_mass_range)[:, None])
    if e.priv_observe_com_displacement:
        parts.append(norm1(com_displacement, nm.com_displacement_range))
    if e.priv_observe_motor_strength:
        parts.append(norm1(motor_strength, nm.motor_strength_range))
    if e.priv_observe_motor_offset:
        parts.append(norm1(motor_offset, nm.motor_offset_range))
    if e.priv_observe_body_height:
        parts.append(norm1(base_z, nm.body_height_range)[:, None])
    if e.priv_observe_body_velocity:
        parts.append(norm1(base_lin_vel, nm.body_velocity_range))
    if e.priv_observe_gravity:
        scale, shift = get_scale_shift(nm.gravity_range)
        g = torch.broadcast_to(gravity_vec, base_lin_vel.shape)
        parts.append((g - shift) / scale)
    if e.priv_observe_Kp_factor:
        parts.append(norm1(kp_factor[:, :1], nm.Kp_factor_range))
    if e.priv_observe_Kd_factor:
        parts.append(norm1(kd_factor[:, :1], nm.Kd_factor_range))
    if not parts:
        return torch.zeros((friction.shape[0], 0), device=friction.device)
    return torch.cat(parts, dim=-1)
