"""The batched environment state (port of ``envs/state.py``).

Every per-env buffer of the reference env (``_init_buffers``, reference
legged_robot_trajectory_tracking.py:1169-1366) as one NamedTuple of
``(N, ...)`` tensors.  The JAX state's ``rng`` / ``global_rng`` keys have no
field here: the port's env owns a ``torch.Generator`` instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..actuation.actuators import ActuatorState
from ..physics.engine import PhysState


class EnvState(NamedTuple):
    phys: PhysState                 # batched physics state
    act: ActuatorState              # batched actuator memory (lag buffer, net history)

    # --- per-env domain randomization (reference :1329-1357) ---
    friction: torch.Tensor          # (N,)
    restitution: torch.Tensor       # (N,)
    payload: torch.Tensor           # (N,)
    com_displacement: torch.Tensor  # (N, 3)
    motor_strength: torch.Tensor    # (N, 12)
    motor_offset: torch.Tensor      # (N, 12)
    kp_factor: torch.Tensor         # (N, 12)
    kd_factor: torch.Tensor         # (N, 12)
    gravity_vec: torch.Tensor       # (3,) full world gravity incl. DR impulse (global)

    # --- episode bookkeeping ---
    episode_length: torch.Tensor    # (N,) int32
    common_step: torch.Tensor       # () int32

    # --- trajectory / commands ---
    trajectories: torch.Tensor      # (N, L, 6)
    curr_pose_index: torch.Tensor   # (N,) int32
    reached: torch.Tensor           # (N,) bool
    plan_buf: torch.Tensor          # (N,) bool
    replan: torch.Tensor            # (N,) bool
    plan_length: torch.Tensor       # (N,) int32
    local_target_poses: torch.Tensor  # (N, 6)
    collision_count: torch.Tensor   # (N,) int32
    commands: torch.Tensor          # (N, C)
    relative_linear: torch.Tensor   # (N, 3)
    relative_rotation: torch.Tensor  # (N, 3)
    local_relative_linear: torch.Tensor   # (N, 3)
    local_relative_rotation: torch.Tensor  # (N, 3)

    # --- action / velocity memory ---
    actions: torch.Tensor           # (N, 12)
    last_actions: torch.Tensor      # (N, 12)
    last_last_actions: torch.Tensor  # (N, 12)
    last_dof_vel: torch.Tensor      # (N, 12)
    last_joint_pos_target: torch.Tensor       # (N, 12)
    last_last_joint_pos_target: torch.Tensor  # (N, 12)

    # --- feet contact bookkeeping ---
    feet_air_time: torch.Tensor     # (N, 4)
    last_contacts: torch.Tensor     # (N, 4) bool
    contact_forces: torch.Tensor    # (N, R, 3) last step's report (for obs/extras)
    torques: torch.Tensor           # (N, 12) last applied torques

    # --- observation history, stored in bf16 and read as f32 by the policy ---
    obs_history: torch.Tensor       # (N, H * num_obs) bf16

    # --- dynamic (curriculum) scalars ---
    exploration_lin_scale: torch.Tensor  # () current decayed scale (incl. dt)
    exploration_yaw_scale: torch.Tensor  # ()
    target_dist: torch.Tensor            # () cl_fix_target current x_mean

    # --- episodic metric accumulators ---
    episode_sums: torch.Tensor      # (N, K) per active reward term + totals

    # --- velocity-task (walk-these-ways) fields; None for the tunnel task ---
    gait_indices: torch.Tensor | None = None            # (N,)
    clock_inputs: torch.Tensor | None = None            # (N, 4)
    desired_contact_states: torch.Tensor | None = None  # (N, 4)
    foot_phase: torch.Tensor | None = None              # (N, 4) unwarped gait phase
    foot_positions: torch.Tensor | None = None          # (N, 4, 3) world
    foot_velocities: torch.Tensor | None = None         # (N, 4, 3) world
    env_command_bins: torch.Tensor | None = None        # (N,) int32 curriculum bin
    env_command_categories: torch.Tensor | None = None  # (N,) int32 gait category
    curriculum_weights: torch.Tensor | None = None      # (num_categories, n_bins)
    command_sums: torch.Tensor | None = None            # (N, 4) tracking-term sums

    # --- the height scan the local planner reads (None without the
    # planner): the previous step's post-reset scan, so each step pays one
    # scan (the JAX package's EnvState.measured_heights) ---
    measured_heights: torch.Tensor | None = None  # (N, 2, nx, ny)
