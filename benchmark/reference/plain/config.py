"""Configuration tree of the PyTorch port (numpy only).

A copy of ``legged_tracking_tpu/config.py`` so that the port imports nothing
of the JAX package: the same ``Cfg`` taxonomy (mirroring the reference
``go1_gym/envs/base/legged_robot_trajectory_tracking_config.py``), the same
defaults, ``config_go1`` and ``parse()``.  Scripts mutate a fresh ``Cfg()``
before the environment is built; the env reads it once at construction.

The ``SimCfg`` layout knobs of the JAX package (lane engine, fused sampling,
granule / layer / interleaved gathers, Pallas scan) are kept so that one
config object drives both packages, but the port has a single path and
ignores them: its contact sampler always cuts the granule window of
``patch_x`` x ``patch_y`` cells, and its height scan is always the CUDA
kernel of ``terrain/scan.py``.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


def _f(x):
    return field(default_factory=lambda: copy.deepcopy(x))


@dataclass
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 235
    num_scalar_observations: int = 42
    num_privileged_obs: int = 6
    num_actions: int = 12
    num_observation_history: int = 15
    episode_length_s: float = 20.0
    send_timeouts: bool = True
    env_spacing: float = 3.0
    num_eval_envs: int = 0          # reference BaseTask eval split (unused by
                                    # the shipped training scripts)

    observe_heights: bool = True
    observe_vel: bool = True
    observe_only_ang_vel: bool = False
    observe_only_lin_vel: bool = False
    observe_yaw: bool = False
    observe_contact_states: bool = False
    observe_command: bool = True
    observe_height_command: bool = True
    observe_gait_commands: bool = False
    observe_timing_parameter: bool = False
    observe_clock_inputs: bool = False
    observe_two_prev_actions: bool = False
    observe_imu: bool = False
    timestep_in_obs: bool = False

    priv_observe_friction: bool = True
    priv_observe_restitution: bool = True
    priv_observe_base_mass: bool = True
    priv_observe_com_displacement: bool = True
    priv_observe_motor_strength: bool = False
    priv_observe_motor_offset: bool = False
    priv_observe_Kp_factor: bool = True
    priv_observe_Kd_factor: bool = True
    priv_observe_gravity: bool = False
    priv_observe_contact_forces: bool = False
    priv_observe_body_velocity: bool = False
    priv_observe_body_height: bool = False
    priv_observe_clock_inputs: bool = False
    priv_observe_desired_contact_states: bool = False
    priv_observe_ground_friction: bool = False

    terminate_end_of_trajectory: bool = False
    use_terminal_body_rotation: bool = False
    camera_zero: bool = True
    rotate_camera: bool = False
    command_xy_only: bool = True
    command_type: str = "xy"  # in ["xy", "xy_norm", "6dof"]
    record_video: bool = False
    num_recording_envs: int = 1
    recording_width_px: int = 360
    recording_height_px: int = 240
    # filled by _parse_cfg equivalents:
    max_episode_length: int = 0


@dataclass
class TunnelTopBottomCfg:
    pyramid_num_x: int = 3
    pyramid_num_y: int = 5
    pyramid_var_x: float = 0.5
    pyramid_var_y: float = 0.3
    pyramid_length_min: float = 0.2
    pyramid_length_max: float = 0.4
    pyramid_height_min: float = 0.2
    pyramid_height_max: float = 0.4


@dataclass
class TerrainCfg:
    mesh_type: str = "trimesh"  # none/plane/heightfield/trimesh
    terrain_type: str = "random_pyramid"  # random|random_pyramid|single_path|narrow_path|multi_path
    valid_tunnel_only: bool = False
    ceiling_height: float = 0.5
    start_loc: float = 0.4

    x_init_range: float = 0.0
    y_init_range: float = 0.0
    x_init_offset: float = 0.0
    y_init_offset: float = 0.0
    yaw_init_range: float = 0.0

    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0

    terrain_ratio_x: float = 0.5
    terrain_ratio_y: float = 0.5
    terrain_length: float = 8.0
    terrain_width: float = 3.6
    terrain_border_ratio_x: float = 0.9
    terrain_border_ratio_y: float = 0.5

    num_rows: int = 1
    num_cols: int = 1

    horizontal_scale: float = 0.05
    vertical_scale: float = 0.005

    measured_points_x: np.ndarray = _f(np.linspace(-1, 1, 21))
    measured_points_y: np.ndarray = _f(np.linspace(-0.5, 0.5, 11))
    measure_front_half: bool = True
    measure_heights: bool = True

    # tunnel-generator probabilities (single_path / narrow_path)
    p_flat: float = 0.9
    p_double: float = 0.6

    top: TunnelTopBottomCfg = _f(TunnelTopBottomCfg())
    bottom: TunnelTopBottomCfg = _f(TunnelTopBottomCfg())

    # velocity-task (legged_gym style) knobs
    curriculum: bool = False
    max_init_terrain_level: int = 5
    terrain_smoothness: float = 0.005
    terrain_noise_magnitude: float = 0.1
    terrain_proportions: List[float] = _f([0.1, 0.1, 0.35, 0.25, 0.2])
    slope_treshold: float = 0.75
    border_size: float = 0.0
    teleport_robots: bool = False
    teleport_thresh: float = 2.0


@dataclass
class CommandsCfg:
    switch_upon_reach: bool = True
    switch_interval: float = 0.5
    traj_function: str = "fixed_target"
    traj_length: int = 1
    num_interpolation: int = 1
    base_x: float = 5.0
    base_y: float = 0.0
    base_z: float = 0.34
    base_roll: float = 0.0
    base_pitch: float = 0.0
    base_yaw: float = 0.0
    x_range: float = 0.5
    y_range: float = 0.5
    z_range: float = 0.1
    roll_range: float = 30 * np.pi / 180
    pitch_range: float = 30 * np.pi / 180
    yaw_range: float = np.pi
    x_mean: float = 3.6
    y_mean: float = 3.6
    global_reference: bool = False
    switch_dist: float = 0.05
    switch_yaw: float = 0.5

    sampling_based_planning: bool = False
    plan_interval: int = 10
    # A/B knob: re-scan heights pre-reset for the planner (the reference's
    # double _get_heights per step) instead of reading the stored scan from
    # the previous step (EnvState.measured_heights). Only for measuring the
    # single-scan win; keep False.
    planner_rescan: bool = False
    # candidate collision scoring as a precomputed quadratic form: the
    # candidates' rotations are yaw-only, so |Rz(-yaw)(p-c)/s|^2 collapses
    # to f(p)·w_c with f = [x²,y²,z²,xy,x,y,z,1] and w_c host-precomputed —
    # one f32 matmul per candidate chunk instead of materializing
    # (N, chunk, 2P, 3) difference tensors. False restores the direct form.
    planner_quadform: bool = True
    candidate_target_poses: np.ndarray = _f(
        np.stack(
            np.meshgrid(
                np.linspace(0.5, 0.5, 1),
                np.array([0, -0.15, 0.15, -0.3, 0.3, -0.45, 0.45]),
                np.array([0.29, 0.27, 0.31, 0.25, 0.23]),
                np.array([0, -15, 15]) * np.pi / 180,
                np.array([0, -15, 15]) * np.pi / 180,
                np.array([0, -22.5, 22.5, -45, 45]) * np.pi / 180,
            ),
            axis=-1,
        ).reshape(-1, 6)
    )

    # ---- velocity-tracking (walk-these-ways) command space ----
    num_commands: int = 3
    resampling_time: float = 10.0
    command_curriculum: bool = False
    lin_vel_x: List[float] = _f([-1.0, 1.0])
    lin_vel_y: List[float] = _f([-1.0, 1.0])
    ang_vel_yaw: List[float] = _f([-1.0, 1.0])
    body_height_cmd: List[float] = _f([-0.05, 0.05])
    gait_frequency_cmd_range: List[float] = _f([2.0, 4.0])
    gait_phase_cmd_range: List[float] = _f([0.0, 1.0])
    gait_offset_cmd_range: List[float] = _f([0.0, 1.0])
    gait_bound_cmd_range: List[float] = _f([0.0, 1.0])
    gait_duration_cmd_range: List[float] = _f([0.5, 0.5])
    footswing_height_range: List[float] = _f([0.06, 0.06])
    body_pitch_range: List[float] = _f([0.0, 0.0])
    body_roll_range: List[float] = _f([0.0, 0.0])
    stance_width_range: List[float] = _f([0.0, 0.0])
    stance_length_range: List[float] = _f([0.0, 0.0])
    aux_reward_coef_range: List[float] = _f([0.0, 0.0])
    limit_vel_x: List[float] = _f([-10.0, 10.0])
    limit_vel_y: List[float] = _f([-0.6, 0.6])
    limit_vel_yaw: List[float] = _f([-10.0, 10.0])
    limit_body_height: List[float] = _f([-0.05, 0.05])
    limit_gait_frequency: List[float] = _f([2.0, 4.0])
    limit_gait_phase: List[float] = _f([0.0, 1.0])
    limit_gait_offset: List[float] = _f([0.0, 1.0])
    limit_gait_bound: List[float] = _f([0.0, 1.0])
    limit_gait_duration: List[float] = _f([0.5, 0.5])
    limit_footswing_height: List[float] = _f([0.06, 0.06])
    limit_body_pitch: List[float] = _f([0.0, 0.0])
    limit_body_roll: List[float] = _f([0.0, 0.0])
    limit_stance_width: List[float] = _f([0.0, 0.0])
    limit_stance_length: List[float] = _f([0.0, 0.0])
    limit_aux_reward_coef: List[float] = _f([0.0, 0.0])
    num_bins_vel_x: int = 25
    num_bins_vel_y: int = 3
    num_bins_vel_yaw: int = 25
    num_bins_body_height: int = 1
    num_bins_gait_frequency: int = 1
    num_bins_gait_phase: int = 1
    num_bins_gait_offset: int = 1
    num_bins_gait_bound: int = 1
    num_bins_gait_duration: int = 1
    num_bins_footswing_height: int = 1
    num_bins_body_pitch: int = 1
    num_bins_body_roll: int = 1
    num_bins_stance_width: int = 1
    num_bins_stance_length: int = 1
    num_bins_aux_reward_coef: int = 1
    heading_command: bool = False
    gaitwise_curricula: bool = True
    exclusive_phase_offset: bool = False
    balance_gait_distribution: bool = False
    binary_phases: bool = False
    pacing_offset: bool = False
    exclusive_command_sampling: bool = False
    distributional_commands: bool = False
    curriculum_seed: int = 100
    heading: List[float] = _f([-3.14, 3.14])


@dataclass
class CurriculumThresholdsCfg:
    cl_fix_target: bool = False
    cl_start_target_dist: float = 0.5
    cl_goal_target_dist: float = 3.6
    cl_switch_delta: float = 0.5
    cl_switch_threshold: float = 1.0
    # beyond-reference safety: step the target BACK by cl_switch_delta when
    # the 4000-episode reach window falls below this (0 = off).  Prevents
    # the sparse-reward frontier collapse observed on long goal runs
    # (docs/TRAINING_NOTES.md): when success at the current distance decays,
    # the value signal vanishes and PPO degrades to passive standing.
    cl_downstep_threshold: float = 0.0
    # beyond-reference: fraction of TRAIN envs that rehearse at a uniformly
    # sampled distance in [cl_start_target_dist, target_dist] instead of the
    # frontier distance (0 = reference semantics).  Fixes the abstention
    # economics of the sparse frontier (docs/TRAINING_NOTES.md round 3):
    # short goals keep the expected return of attempting positive and retain
    # short-distance competence.  The curriculum window gates on the
    # FRONTIER slice only (metrics frontier_reached_mean), so rehearsal
    # success cannot advance the curriculum.
    cl_dist_mix: float = 0.0
    # beyond-reference (round 5): stagnation PROBE for the fix-target
    # curriculum.  If neither an advance nor a downstep has fired for this
    # many iterations and the reach window is healthy (>= the downstep
    # threshold), advance the frontier by cl_switch_delta anyway — the
    # downstep safety reverts it if the policy cannot hold the new
    # distance, and best-checkpoint tracking keeps the peak either way.
    # Kills the round-4 pathology of churning against the 0.8 advance
    # threshold at one distance for 7000 iterations
    # (docs/goal_r4_10k_metrics.jsonl).  0 = off.
    cl_stagnation_probe: int = 0
    # beyond-reference (round 5): retention at the curriculum wall.  When a
    # downstep fires (reach window collapsed below cl_downstep_threshold),
    # ALSO restore the best-scoring train_state snapshot (params + optimizer
    # moments + obs_rms) kept by the runner's best-checkpoint tracking,
    # instead of continuing to train the eroded policy at the easier
    # distance.  Every round-5 long run (both 10k goal runs and the
    # hierarchy stage-B continuation) died in the same mode: a failed
    # excursion at the frontier erodes the policy faster than the downstep
    # can re-train it (docs/TRAINING_NOTES.md).  Restoring the peak turns a
    # collapse into a retry-from-strength.  False = pre-round-5 behavior.
    cl_restore_best_on_downstep: bool = False
    # velocity-task thresholds (fraction of max reward per term)
    tracking_lin_vel: float = 0.8
    tracking_ang_vel: float = 0.7
    tracking_contacts_shaped_force: float = 0.9
    tracking_contacts_shaped_vel: float = 0.9


@dataclass
class InitStateCfg:
    pos: List[float] = _f([0.0, 0.0, 1.0])
    rot: List[float] = _f([0.0, 0.0, 0.0, 1.0])
    lin_vel: List[float] = _f([0.0, 0.0, 0.0])
    ang_vel: List[float] = _f([0.0, 0.0, 0.0])
    default_joint_angles: dict = _f({})


@dataclass
class ControlCfg:
    control_type: str = "actuator_net"  # P | actuator_net
    stiffness: float = 20.0
    damping: float = 0.5
    action_scale: float = 0.25
    hip_scale_reduction: float = 1.0
    decimation: int = 4


@dataclass
class AssetCfg:
    foot_name: str = "foot"
    penalize_contacts_on: List[str] = _f([])
    terminate_after_contacts_on: List[str] = _f([])
    fix_base_link: bool = False
    self_collisions: int = 0


@dataclass
class DomainRandCfg:
    rand_interval_s: float = 10.0
    randomize_rigids_after_start: bool = True
    randomize_friction: bool = True
    friction_range: List[float] = _f([0.5, 1.25])
    randomize_restitution: bool = False
    restitution_range: List[float] = _f([0.0, 1.0])
    restitution: float = 0.5
    randomize_base_mass: bool = False
    added_mass_range: List[float] = _f([-1.0, 1.0])
    randomize_com_displacement: bool = False
    com_displacement_range: List[float] = _f([-0.15, 0.15])
    randomize_motor_strength: bool = False
    motor_strength_range: List[float] = _f([0.9, 1.1])
    randomize_motor_offset: bool = True
    motor_offset_range: List[float] = _f([-0.02, 0.02])
    randomize_Kp_factor: bool = False
    Kp_factor_range: List[float] = _f([0.8, 1.3])
    randomize_Kd_factor: bool = False
    Kd_factor_range: List[float] = _f([0.5, 1.5])
    gravity_rand_interval_s: float = 7.0
    gravity_impulse_duration: float = 1.0
    randomize_gravity: bool = False
    gravity_range: List[float] = _f([-1.0, 1.0])
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0
    randomize_lag_timesteps: bool = True
    lag_timesteps: int = 6
    randomize_ground_friction: bool = False
    ground_friction_range: List[float] = _f([0.0, 0.0])


@dataclass
class RewardsCfg:
    only_positive_rewards: bool = True
    only_positive_rewards_ji22_style: bool = False
    # reference default (legged_robot_config.py); cold-start guidance for this
    # engine lives in docs/TRAINING_NOTES.md (staged sigma via the CLI flag)
    sigma_rew_neg: float = 0.02
    reward_container_name: str = "RewardsCrawling"
    target_lin_vel: float = 0.5
    lin_reaching_criterion: float = 0.1
    tracking_sigma_lin: float = 0.10
    target_ang_vel: float = np.pi / 2.0
    ang_reaching_criterion: float = np.pi / 20.0
    tracking_sigma_ang: float = 0.5
    use_terminal_body_height: bool = True
    terminal_body_height: float = 0.1
    base_height_target: float = 0.34
    soft_dof_pos_limit: float = 0.9
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    T_reach: int = 0
    lin_vel_form: str = "exp"
    small_vel_threshold: float = 0.1
    large_dist_threshold: float = 0.5
    exploration_steps: float = float("inf")
    # walk-these-ways terms
    tracking_sigma: float = 0.25
    tracking_sigma_yaw: float = 0.25
    gait_force_sigma: float = 100.0
    gait_vel_sigma: float = 10.0
    kappa_gait_probs: float = 0.07
    max_contact_force: float = 100.0
    terminal_body_ori: float = 0.5


@dataclass
class RewardScalesCfg:
    """Sparse mapping reward-name -> scale.  Zero scales are dropped at build
    time (mirrors ``_prepare_reward_function``, reference
    legged_robot_trajectory_tracking.py:1368-1397)."""

    torques: float = -0.00001
    dof_acc: float = -2.5e-7
    collision: float = -1.0
    action_rate: float = -0.01
    reaching_linear_vel: float = 0.0
    reaching_z: float = 0.0
    reaching_yaw: float = 0.0

    def items(self):
        d = {k: v for k, v in vars(self).items() if not k.startswith("_")}
        return d.items()

    def set(self, name, value):
        setattr(self, name, value)

    def as_dict(self):
        return dict(self.items())


@dataclass
class NormalizationCfg:
    clip_observations: float = 100.0
    clip_actions: float = 100.0
    friction_range: List[float] = _f([0.05, 4.5])
    ground_friction_range: List[float] = _f([0.05, 4.5])
    restitution_range: List[float] = _f([0.0, 1.0])
    added_mass_range: List[float] = _f([-1.0, 3.0])
    com_displacement_range: List[float] = _f([-0.1, 0.1])
    motor_strength_range: List[float] = _f([0.9, 1.1])
    motor_offset_range: List[float] = _f([-0.05, 0.05])
    Kp_factor_range: List[float] = _f([0.8, 1.3])
    Kd_factor_range: List[float] = _f([0.5, 1.5])
    joint_friction_range: List[float] = _f([0.0, 0.7])
    contact_force_range: List[float] = _f([0.0, 50.0])
    contact_state_range: List[float] = _f([0.0, 1.0])
    body_velocity_range: List[float] = _f([-6.0, 6.0])
    body_height_range: List[float] = _f([0.0, 0.60])
    gravity_range: List[float] = _f([-1.0, 1.0])


@dataclass
class ObsScalesCfg:
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    imu: float = 0.1
    height_measurements: float = 0.1
    body_height_cmd: float = 2.0
    gait_phase_cmd: float = 1.0
    gait_freq_cmd: float = 1.0
    footswing_height_cmd: float = 0.15
    body_pitch_cmd: float = 0.3
    body_roll_cmd: float = 0.3
    aux_reward_cmd: float = 1.0
    compliance_cmd: float = 1.0
    stance_width_cmd: float = 1.0
    stance_length_cmd: float = 1.0


@dataclass
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0


@dataclass
class NoiseScalesCfg:
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    imu: float = 0.1
    gravity: float = 0.05
    contact_states: float = 0.05
    height_measurements: float = 0.1


@dataclass
class SimCfg:
    dt: float = 0.005
    gravity: List[float] = _f([0.0, 0.0, -9.81])
    # soft-contact solver parameters (calibrated vs PhysX behavior)
    contact_stiffness: float = 12000.0
    contact_damping: float = 150.0
    friction_stiffness: float = 1.0  # slip-velocity regularization scale
    joint_limit_stiffness: float = 80.0
    joint_limit_damping: float = 2.0
    max_depenetration_velocity: float = 1.0
    # layout knobs of the JAX package (see the module docstring): the
    # port reads only patch_x / patch_y, the contact window in cells
    lane_engine: bool = True
    fused_sampling: bool = True
    patch_y: int = 16
    granule_gather: bool = True
    layer_gather: bool = False
    pallas_scan: bool = False
    patch_x: int = 24
    # EMA smoothing of the REPORTED contact forces (dynamics untouched):
    # report_t = (1-b)*raw_t + b*report_{t-1}; 0 disables (reference parity)
    contact_report_ema: float = 0.0
    interleaved_gather: bool = False


@dataclass
class Cfg:
    env: EnvCfg = _f(EnvCfg())
    terrain: TerrainCfg = _f(TerrainCfg())
    commands: CommandsCfg = _f(CommandsCfg())
    curriculum_thresholds: CurriculumThresholdsCfg = _f(CurriculumThresholdsCfg())
    init_state: InitStateCfg = _f(InitStateCfg())
    control: ControlCfg = _f(ControlCfg())
    asset: AssetCfg = _f(AssetCfg())
    domain_rand: DomainRandCfg = _f(DomainRandCfg())
    rewards: RewardsCfg = _f(RewardsCfg())
    reward_scales: RewardScalesCfg = _f(RewardScalesCfg())
    normalization: NormalizationCfg = _f(NormalizationCfg())
    obs_scales: ObsScalesCfg = _f(ObsScalesCfg())
    noise: NoiseCfg = _f(NoiseCfg())
    noise_scales: NoiseScalesCfg = _f(NoiseScalesCfg())
    sim: SimCfg = _f(SimCfg())
    seed: int = 11

    # derived (filled by parse())
    dt: float = 0.02

    def parse(self):
        """Derive timestep-dependent quantities (reference _parse_cfg,
        legged_robot_trajectory_tracking.py:1860-1877)."""
        self.dt = self.control.decimation * self.sim.dt
        self.env.max_episode_length = int(np.ceil(self.env.episode_length_s / self.dt))
        self.domain_rand.push_interval = int(np.ceil(self.domain_rand.push_interval_s / self.dt))
        self.domain_rand.rand_interval = int(np.ceil(self.domain_rand.rand_interval_s / self.dt))
        self.domain_rand.gravity_rand_interval = int(
            np.ceil(self.domain_rand.gravity_rand_interval_s / self.dt)
        )
        self.domain_rand.gravity_rand_duration = int(
            np.ceil(self.domain_rand.gravity_rand_interval * self.domain_rand.gravity_impulse_duration)
        )
        return self

    def copy(self) -> "Cfg":
        return copy.deepcopy(self)


def config_go1(cfg: Cfg) -> Cfg:
    """Go1 robot constants (reference go1_gym/envs/go1/go1_crawling.py:8-107)."""
    cfg.init_state.pos = [0.0, 0.0, 0.34]
    cfg.init_state.default_joint_angles = {
        "FL_hip_joint": 0.1, "RL_hip_joint": 0.1,
        "FR_hip_joint": -0.1, "RR_hip_joint": -0.1,
        "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0,
        "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
        "FL_calf_joint": -1.5, "RL_calf_joint": -1.5,
        "FR_calf_joint": -1.5, "RR_calf_joint": -1.5,
    }
    cfg.control.control_type = "P"
    cfg.control.stiffness = 20.0
    cfg.control.damping = 0.5
    cfg.control.action_scale = 0.25
    cfg.control.hip_scale_reduction = 0.5
    cfg.control.decimation = 4

    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on = ["thigh", "calf"]
    cfg.asset.terminate_after_contacts_on = ["base"]

    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 0.34

    cfg.reward_scales.torques = -0.0001
    cfg.reward_scales.set("action_rate", -0.01)
    cfg.reward_scales.set("dof_pos_limits", -10.0)
    cfg.reward_scales.set("orientation", -5.0)
    cfg.reward_scales.set("base_height", -30.0)

    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.measure_heights = False
    cfg.terrain.terrain_noise_magnitude = 0.0
    cfg.terrain.teleport_robots = True
    cfg.terrain.border_size = 50
    cfg.terrain.terrain_proportions = [0, 0, 0, 0, 0, 0, 0, 0, 1.0]
    cfg.terrain.curriculum = False

    cfg.env.num_observations = 42
    cfg.env.observe_vel = False
    cfg.env.num_envs = 4000

    cfg.commands.heading_command = False
    cfg.commands.resampling_time = 10.0
    cfg.commands.command_curriculum = True
    cfg.commands.lin_vel_x = [-0.6, 0.6]
    cfg.commands.lin_vel_y = [-0.6, 0.6]
    cfg.commands.ang_vel_yaw = [-1.0, 1.0]

    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [-1, 3]
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.max_push_vel_xy = 0.5
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = [0.05, 4.5]
    cfg.domain_rand.randomize_restitution = True
    cfg.domain_rand.restitution_range = [0.0, 1.0]
    cfg.domain_rand.restitution = 0.5
    cfg.domain_rand.randomize_com_displacement = True
    cfg.domain_rand.com_displacement_range = [-0.1, 0.1]
    cfg.domain_rand.randomize_motor_strength = True
    cfg.domain_rand.motor_strength_range = [0.9, 1.1]
    cfg.domain_rand.randomize_Kp_factor = False
    cfg.domain_rand.randomize_Kd_factor = False
    cfg.domain_rand.rand_interval_s = 6
    return cfg
