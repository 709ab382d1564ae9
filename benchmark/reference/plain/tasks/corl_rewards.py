"""Walk-these-ways (MoB) reward terms (port of ``tasks/corl_rewards.py``).

Batched ``CoRLRewards`` (go1_gym/envs/rewards/corl_rewards.py:7-202):
velocity tracking, gait-shaped contact force/velocity terms, action
smoothness, foot slip/clearance/impact, orientation control, and the
Raibert-heuristic footstep prior.  ``rewards.containers.get_container
("CoRLRewards")`` returns :data:`CORL_REWARDS`.

A division by a configuration constant is a multiply by its float32
reciprocal, as XLA compiles the JAX package's; a norm is the square root of
the sum of squares, as ``jnp.linalg.norm`` is.  Constants are filled on the
device from the context's tensors, never copied from the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..rewards.containers import (_action_rate, _ang_vel_xy, _collision, _dof_acc, _dof_pos,
                                  _dof_pos_limits, _dof_vel, _lin_vel_z, _orientation,
                                  _torques, slots)
from ..utils import quat as qt
from ..utils.math import norm as _norm


def _recip(x) -> float:
    """The float32 reciprocal of a constant (XLA's folding of ``/ x``)."""
    return float(np.float32(1.0) / np.float32(x))


def _tracking_lin_vel(ctx, cfg):
    err = torch.sum(torch.square(ctx.commands[:, :2] - ctx.base_lin_vel[:, :2]), dim=1)
    return torch.exp(-err * _recip(cfg.rewards.tracking_sigma))


def _tracking_ang_vel(ctx, cfg):
    err = torch.square(ctx.commands[:, 2] - ctx.base_ang_vel[:, 2])
    return torch.exp(-err * _recip(cfg.rewards.tracking_sigma_yaw))


def _jump(ctx, cfg):
    body_height = ctx.base_pos[:, 2]
    target = ctx.commands[:, 3] + cfg.rewards.base_height_target
    return -torch.square(body_height - target)


def _feet_forces(ctx):
    return _norm(ctx.contact_forces[:, slots(ctx.feet_slots), :])


def _tracking_contacts_shaped_force(ctx, cfg):
    forces = _feet_forces(ctx)
    desired = ctx.desired_contact_states
    r = -(1 - desired) * (1 - torch.exp(-(forces * forces) * _recip(cfg.rewards.gait_force_sigma)))
    return torch.sum(r, dim=1) * 0.25


def _tracking_contacts_shaped_vel(ctx, cfg):
    vels = _norm(ctx.foot_velocities)
    desired = ctx.desired_contact_states
    r = -(desired * (1 - torch.exp(-(vels * vels) * _recip(cfg.rewards.gait_vel_sigma))))
    return torch.sum(r, dim=1) * 0.25


def _action_smoothness_1(ctx, cfg):
    diff = torch.square(ctx.joint_pos_target - ctx.last_joint_pos_target)
    diff = diff * (ctx.last_actions != 0)           # ignore the first step
    return torch.sum(diff, dim=1)


def _action_smoothness_2(ctx, cfg):
    diff = torch.square(ctx.joint_pos_target - 2 * ctx.last_joint_pos_target
                        + ctx.last_last_joint_pos_target)
    diff = diff * (ctx.last_actions != 0)
    diff = diff * (ctx.last_last_actions != 0)
    return torch.sum(diff, dim=1)


def _feet_slip(ctx, cfg):
    # contact | pre-step last_contacts (corl_rewards.py:108-110): the env
    # gives the filtered mask, since it owns the last_contacts state
    vxy2 = torch.square(_norm(ctx.foot_velocities[:, :, :2]))
    return torch.sum(ctx.feet_contact_filt * vxy2, dim=1)


def _feet_contact_vel(ctx, cfg):
    near_ground = ctx.foot_positions[:, :, 2] < 0.03
    v2 = torch.square(_norm(ctx.foot_velocities))
    return torch.sum(near_ground * v2, dim=1)


def _feet_contact_forces(ctx, cfg):
    return torch.sum(torch.clamp(_feet_forces(ctx) - cfg.rewards.max_contact_force, min=0.0),
                     dim=1)


def _feet_clearance_cmd_linear(ctx, cfg):
    phases = 1 - torch.abs(1.0 - torch.clamp(ctx.foot_phase * 2.0 - 1.0, 0.0, 1.0) * 2.0)
    foot_height = ctx.foot_positions[:, :, 2]
    target = ctx.commands[:, 9:10] * phases + 0.02   # +2 cm foot radius
    r = torch.square(target - foot_height) * (1 - ctx.desired_contact_states)
    return torch.sum(r, dim=1)


def _feet_impact_vel(ctx, cfg):
    prev_vz = ctx.prev_foot_velocities[:, :, 2]
    contact = _feet_forces(ctx) > 1.0
    return torch.sum(contact * torch.square(torch.clamp(prev_vz, -100.0, 0.0)), dim=1)


def _orientation_control(ctx, cfg):
    rp = ctx.commands[:, 10:12]
    zero, one = torch.zeros_like(rp[:, 0]), torch.ones_like(rp[:, 0])
    quat_roll = qt.quat_from_angle_axis(-rp[:, 1], torch.stack([one, zero, zero], dim=-1))
    quat_pitch = qt.quat_from_angle_axis(-rp[:, 0], torch.stack([zero, one, zero], dim=-1))
    desired_quat = qt.quat_mul(quat_roll, quat_pitch)
    desired_pg = qt.quat_rotate_inverse(desired_quat, ctx.gravity_unit.expand(rp.shape[0], 3))
    return torch.sum(torch.square(ctx.projected_gravity[:, :2] - desired_pg[:, :2]), dim=1)


def _raibert_heuristic(ctx, cfg):
    rel = ctx.foot_positions - ctx.base_pos[:, None, :]
    feet_body = qt.quat_apply_yaw_inverse(ctx.base_quat[:, None, :], rel)

    # the JAX package's documented divergence from the reference
    # (corl_rewards.py:169-174 there): the nominal y of each foot takes the
    # sign of the foot's side (FR/RR at negative body-frame y)
    cmd = ctx.commands
    # a (N, 4) row of constants, filled on the device
    row = lambda *vals: torch.stack([torch.full_like(cmd[:, 0], v) for v in vals], dim=1)
    if cfg.commands.num_commands >= 13:
        sw = cmd[:, 12:13]
        ys_nom = torch.cat([-sw / 2, sw / 2, -sw / 2, sw / 2], dim=1)
    else:
        ys_nom = row(-0.15, 0.15, -0.15, 0.15)
    if cfg.commands.num_commands >= 14:
        sl = cmd[:, 13:14]
        xs_nom = torch.cat([sl / 2, sl / 2, -sl / 2, -sl / 2], dim=1)
        stance_length = sl
    else:
        stance_length = 0.45
        xs_nom = row(0.225, 0.225, -0.225, -0.225)

    phases = torch.abs(1.0 - ctx.foot_phase * 2.0) - 0.5
    frequencies = cmd[:, 4]
    x_vel_des = cmd[:, 0:1]
    yaw_vel_des = cmd[:, 2:3]
    y_vel_des = yaw_vel_des * stance_length / 2
    ys_off = phases * y_vel_des * (0.5 / frequencies[:, None]) * row(1.0, 1.0, -1.0, -1.0)
    xs_off = phases * x_vel_des * (0.5 / frequencies[:, None])

    desired = torch.stack([xs_nom + xs_off, ys_nom + ys_off], dim=2)
    err = torch.abs(desired - feet_body[:, :, :2])
    return torch.sum(torch.square(err), dim=(1, 2))


CORL_REWARDS = {
    "tracking_lin_vel": _tracking_lin_vel,
    "tracking_ang_vel": _tracking_ang_vel,
    "lin_vel_z": _lin_vel_z,
    "ang_vel_xy": _ang_vel_xy,
    "orientation": _orientation,
    "torques": _torques,
    "dof_acc": _dof_acc,
    "action_rate": _action_rate,
    "collision": _collision,
    "dof_pos_limits": _dof_pos_limits,
    "jump": _jump,
    "tracking_contacts_shaped_force": _tracking_contacts_shaped_force,
    "tracking_contacts_shaped_vel": _tracking_contacts_shaped_vel,
    "dof_pos": _dof_pos,
    "dof_vel": _dof_vel,
    "action_smoothness_1": _action_smoothness_1,
    "action_smoothness_2": _action_smoothness_2,
    "feet_slip": _feet_slip,
    "feet_contact_vel": _feet_contact_vel,
    "feet_contact_forces": _feet_contact_forces,
    "feet_clearance_cmd_linear": _feet_clearance_cmd_linear,
    "feet_impact_vel": _feet_impact_vel,
    "orientation_control": _orientation_control,
    "raibert_heuristic": _raibert_heuristic,
}
