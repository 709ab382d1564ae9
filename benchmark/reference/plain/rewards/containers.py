"""Reward terms as pure batched functions (port of ``rewards/containers.py``).

``CRAWLING_REWARDS`` mirrors RewardsCrawling
(go1_gym/envs/rewards/reward_crawling.py:9-123), the container of the
tunnel task; ``TRAJECTORY_TRACKING_REWARDS`` mirrors
TrajectoryTrackingRewards (trajectory_tracking_reward.py:9-171), the
container of the goal and planner recipes; the velocity task's
``CoRLRewards`` are in :mod:`..tasks.corl_rewards`.  Each term is
``fn(ctx: RewardCtx, cfg) -> (N,)``; the env keeps the non-zero-scaled
subset.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-6


class RewardCtx(NamedTuple):
    """Everything reward terms may read."""

    dt: float
    max_episode_length: float
    base_pos: torch.Tensor            # (N, 3)
    base_lin_vel: torch.Tensor        # (N, 3) body frame
    base_ang_vel: torch.Tensor        # (N, 3) body frame
    projected_gravity: torch.Tensor   # (N, 3)
    dof_pos: torch.Tensor             # (N, 12)
    dof_vel: torch.Tensor             # (N, 12)
    last_dof_vel: torch.Tensor        # (N, 12)
    default_dof_pos: torch.Tensor     # (12,)
    dof_pos_soft_limits: torch.Tensor  # (12, 2)
    torques: torch.Tensor             # (N, 12)
    actions: torch.Tensor             # (N, 12)
    last_actions: torch.Tensor        # (N, 12)
    contact_forces: torch.Tensor      # (N, R, 3) net per report slot
    penalised_slots: tuple            # static report-slot indices
    feet_slots: tuple                 # static report-slot indices (4)
    relative_linear: torch.Tensor     # (N, 3) goal pos in yaw-aligned body frame
    relative_rotation: torch.Tensor   # (N, 3) goal rpy - base rpy, wrapped
    local_relative_linear: torch.Tensor  # (N, 3) local (planned) target
    reached_buf: torch.Tensor         # (N,) bool
    plan_buf: torch.Tensor            # (N,) bool
    replan: torch.Tensor              # (N,) bool
    episode_length_buf: torch.Tensor  # (N,) int
    reset_buf: torch.Tensor           # (N,) bool (pre-reward termination)
    feet_air_time: torch.Tensor       # (N, 4) updated air time (post-contact)
    feet_first_contact: torch.Tensor  # (N, 4) bool

    # --- velocity-task (walk-these-ways) extras; None for the tunnel task ---
    commands: torch.Tensor | None = None              # (N, num_commands)
    desired_contact_states: torch.Tensor | None = None  # (N, 4)
    foot_positions: torch.Tensor | None = None        # (N, 4, 3) world
    foot_velocities: torch.Tensor | None = None       # (N, 4, 3) world
    prev_foot_velocities: torch.Tensor | None = None  # (N, 4, 3) world (pre-step)
    foot_phase: torch.Tensor | None = None            # (N, 4) gait phase in [0, 1)
    joint_pos_target: torch.Tensor | None = None      # (N, 12)
    last_joint_pos_target: torch.Tensor | None = None
    last_last_joint_pos_target: torch.Tensor | None = None
    last_last_actions: torch.Tensor | None = None
    gravity_unit: torch.Tensor | None = None          # (3,) normalized world gravity
    feet_contact_filt: torch.Tensor | None = None     # (N, 4) contact | last_contacts
    base_quat: torch.Tensor | None = None             # (N, 4) xyzw


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def slots(idx):
    """Report-slot indices as an index: a slice when they are consecutive
    (the feet are), so that indexing a tensor on the card takes no index
    list from the host."""
    idx = [int(i) for i in idx]
    if idx and idx == list(range(idx[0], idx[-1] + 1)):
        return slice(idx[0], idx[-1] + 1)
    return idx


# ---------------------------------------------------------------- penalties

def _torques(ctx, cfg):
    return torch.sum(torch.square(ctx.torques), dim=1)


def _dof_vel(ctx, cfg):
    return torch.sum(torch.square(ctx.dof_vel), dim=1)


def _dof_acc(ctx, cfg):
    return torch.sum(torch.square((ctx.last_dof_vel - ctx.dof_vel) / ctx.dt), dim=1)


def _dof_pos(ctx, cfg):
    return torch.sum(torch.square(ctx.dof_pos - ctx.default_dof_pos), dim=1)


def _dof_pos_limits(ctx, cfg):
    lo = ctx.dof_pos_soft_limits[:, 0]
    hi = ctx.dof_pos_soft_limits[:, 1]
    out = -torch.clamp(ctx.dof_pos - lo, max=0.0) + torch.clamp(ctx.dof_pos - hi, min=0.0)
    return torch.sum(out, dim=1)


def _collision(ctx, cfg):
    f = ctx.contact_forces[:, list(ctx.penalised_slots), :]
    return torch.sum((_norm(f) > 0.1).float(), dim=1)


def _action_rate(ctx, cfg):
    return torch.sum(torch.square(ctx.last_actions - ctx.actions), dim=1)


def _base_height(ctx, cfg):
    return torch.square(ctx.base_pos[:, 2] - cfg.rewards.base_height_target)


def _ang_vel_xy(ctx, cfg):
    return torch.sum(torch.square(ctx.base_ang_vel[:, :2]), dim=1)


def _lin_vel_z(ctx, cfg):
    return torch.square(ctx.base_lin_vel[:, 2])


def _orientation(ctx, cfg):
    return torch.sum(torch.square(ctx.projected_gravity[:, :2]), dim=1)


def _large_vel(ctx, cfg):
    mag = _norm(ctx.base_lin_vel[:, :2]) > 0.5
    return torch.sum(torch.square(ctx.base_lin_vel[:, :2]), dim=1) * mag


# ---------------------------------------------------------------- task terms

def _target_lin_vel(ctx, cfg):
    """Unit-vector-to-goal * target speed, zeroed when within reach criterion."""
    tv = ctx.relative_linear[:, :2]
    mag = torch.linalg.vector_norm(tv, dim=1, keepdim=True)
    tv = tv / (mag + EPS) * cfg.rewards.target_lin_vel
    return tv * (mag > cfg.rewards.lin_reaching_criterion), mag


def _e2e(ctx, cfg):
    mag = _norm(ctx.relative_linear[:, :2])
    if cfg.env.terminate_end_of_trajectory:
        return (mag < cfg.commands.switch_dist) * float(cfg.env.max_episode_length)
    reached = mag < cfg.commands.switch_dist
    after = ctx.episode_length_buf > cfg.rewards.T_reach
    err = torch.sum(torch.square(ctx.base_lin_vel[:, :2]), dim=-1)
    return torch.exp(-err / cfg.rewards.tracking_sigma_lin) * reached * after


def _vel_form(tv, base_vel, cfg):
    if cfg.rewards.lin_vel_form == "exp":
        err = torch.sum(torch.square(tv - base_vel), dim=-1)
        return torch.exp(-err / cfg.rewards.tracking_sigma_lin)
    if cfg.rewards.lin_vel_form == "l1":
        return torch.sum(torch.abs(tv - base_vel), dim=-1)
    if cfg.rewards.lin_vel_form == "l2":
        return torch.sum(torch.square(tv - base_vel), dim=-1)
    raise ValueError(cfg.rewards.lin_vel_form)


def _exploration_lin(ctx, cfg):
    tv, mag = _target_lin_vel(ctx, cfg)
    base = ctx.base_lin_vel[:, :2]
    if cfg.rewards.lin_vel_form == "prod":
        bmag = torch.linalg.vector_norm(base, dim=1, keepdim=True)
        rew = torch.sum(tv / cfg.rewards.target_lin_vel * base / (bmag + EPS), dim=-1)
        rew = rew * (bmag[:, 0] > cfg.rewards.small_vel_threshold)
        rew = rew + torch.exp(-bmag[:, 0] ** 2 / cfg.rewards.tracking_sigma_lin) * (
            mag[:, 0] < cfg.rewards.lin_reaching_criterion)
        return rew
    return _vel_form(tv, base, cfg)


def _exploration_yaw(ctx, cfg):
    tw = ctx.relative_rotation[:, 2]
    mag = torch.abs(tw)
    tw = tw / (mag + EPS) * cfg.rewards.target_ang_vel
    tw = tw * (mag > cfg.rewards.ang_reaching_criterion)
    err = torch.square(tw - ctx.base_ang_vel[:, 2])
    return torch.exp(-err / cfg.rewards.tracking_sigma_ang)


def _reaching_z(ctx, cfg):
    return torch.square(ctx.relative_linear[:, 2])


def _reaching_roll(ctx, cfg):
    return torch.square(ctx.relative_rotation[:, 0])


def _reaching_pitch(ctx, cfg):
    return torch.square(ctx.relative_rotation[:, 1])


def _reaching_yaw_abs(ctx, cfg):
    return torch.square(ctx.relative_rotation[:, 2])


def _reach_goal(ctx, cfg):
    return ctx.reached_buf.float()


def _reach_goal_t(ctx, cfg):
    return ctx.reached_buf * ctx.episode_length_buf.float()


def _reach_goal_T(ctx, cfg):
    return ctx.reached_buf * (ctx.episode_length_buf > cfg.rewards.T_reach).float()


def _task(ctx, cfg):
    tv, _ = _target_lin_vel(ctx, cfg)
    err = torch.sum(torch.square(tv - ctx.base_lin_vel[:, :2]), dim=-1)
    in_dist = _norm(ctx.relative_linear[:, :2]) < cfg.rewards.large_dist_threshold
    return torch.exp(-err / cfg.rewards.tracking_sigma_lin) * in_dist


def _exploration(ctx, cfg):
    base = ctx.base_lin_vel[:, :2]
    local = ctx.local_relative_linear[:, :2]
    r = torch.sum(base * local, dim=1)
    r = r / (_norm(local) + EPS)
    r = r / (_norm(base) + EPS)
    return r * (_norm(base) > cfg.rewards.small_vel_threshold)


def _reaching_local_goal(ctx, cfg):
    return (ctx.plan_buf & ctx.replan).float()


def _stalling(ctx, cfg):
    small = _norm(ctx.base_lin_vel[:, :2]) < cfg.rewards.small_vel_threshold
    far = _norm(ctx.relative_linear[:, :2]) > cfg.rewards.large_dist_threshold
    return -(small & far).float()


def _linear_vel(ctx, cfg):
    return (_norm(ctx.base_lin_vel[:, :3]) > 0.7).float()


def _survive(ctx, cfg):
    return torch.ones_like(ctx.reset_buf, dtype=torch.float32)


def _feet_air_time(ctx, cfg):
    """Reward long swing phases on first contact
    (trajectory_tracking_reward.py:115-126); the env step keeps the air time."""
    return torch.sum((ctx.feet_air_time - 0.5) * ctx.feet_first_contact, dim=1)


def _reaching_linear_vel(ctx, cfg):
    tv, _ = _target_lin_vel(ctx, cfg)
    return _vel_form(tv, ctx.base_lin_vel[:, :2], cfg)


CRAWLING_REWARDS = {
    "dof_acc": _dof_acc,
    "torques": _torques,
    "dof_pos_limits": _dof_pos_limits,
    "collision": _collision,
    "action_rate": _action_rate,
    "base_height": _base_height,
    "ang_vel_xy": _ang_vel_xy,
    "orientation": _orientation,
    "large_vel": _large_vel,
    "e2e": _e2e,
    "exploration_lin": _exploration_lin,
    "exploration_yaw": _exploration_yaw,
    "reaching_z": _reaching_z,
    "reaching_roll": _reaching_roll,
    "reaching_pitch": _reaching_pitch,
}


TRAJECTORY_TRACKING_REWARDS = {
    "torques": _torques,
    "dof_vel": _dof_vel,
    "dof_acc": _dof_acc,
    "dof_pos": _dof_pos,
    "collision": _collision,
    "action_rate": _action_rate,
    "dof_pos_limits": _dof_pos_limits,
    "orientation": _orientation,
    "reach_goal": _reach_goal,
    "reach_goal_t": _reach_goal_t,
    "reach_goal_T": _reach_goal_T,
    "task": _task,
    "exploration": _exploration,
    "reaching_local_goal": _reaching_local_goal,
    "stalling": _stalling,
    "linear_vel": _linear_vel,
    "lin_vel_z": _lin_vel_z,
    "ang_vel_xy": _ang_vel_xy,
    "feet_air_time": _feet_air_time,
    "survive": _survive,
    "reaching_linear_vel": _reaching_linear_vel,
    "reaching_z": _reaching_z,
    "reaching_roll": _reaching_roll,
    "reaching_pitch": _reaching_pitch,
    "reaching_yaw_abs": _reaching_yaw_abs,
    "exploration_yaw": _exploration_yaw,
    "reaching_yaw": _exploration_yaw,
}


def get_container(name: str) -> dict:
    containers = {
        "RewardsCrawling": CRAWLING_REWARDS,
        "TrajectoryTrackingRewards": TRAJECTORY_TRACKING_REWARDS,
    }
    if name == "CoRLRewards":
        from ..tasks.corl_rewards import CORL_REWARDS
        return CORL_REWARDS
    return containers[name]
