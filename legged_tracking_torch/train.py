"""Tunnel-crawling training entry of the port (counterpart of
``scripts/train.py``): builds the env, the policy, the Runner and the PPO
arguments from the same flags, then trains.

    python -m legged_tracking_torch.train --strategy goal \\
        --terrain random_pyramid --max_noise_std 1.0 \\
        --cl_goal_target_dist 3.8 --cl_downstep 0.5 --logdir runs/goal

It runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given, and never moves to the CPU by itself.  Every flag of
``scripts/train.py`` is ported but ``--distributed``/``--num_devices``,
which raise ``NotImplementedError`` naming the missing module.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_cfg(args):
    """The port's copy of ``scripts/train.py:build_cfg`` (reference
    train.py: obs dims :51-60, terrain wiring :127-170, strategy reward
    wiring :111-125, DR :187-241), for the flags :func:`check_supported`
    lets through."""
    from .config import Cfg, config_go1

    cfg = config_go1(Cfg())
    cfg.seed = args.seed
    cfg.env.observe_heights = True
    cfg.env.command_type = args.command_type
    cfg.terrain.measured_points_x = np.linspace(-1, 1, 21)
    cfg.terrain.measured_points_y = np.linspace(-0.5, 0.5, 11)
    cfg.env.num_observation_history = args.num_history
    cfg.env.terminate_end_of_trajectory = args.terminate_after_reach
    cfg.env.episode_length_s = 20
    cfg.env.camera_zero = args.camera_zero
    cfg.env.timestep_in_obs = args.timestep_in_obs
    cfg.terrain.measure_front_half = args.measure_front_half

    # penalize (not terminate) base contact (reference train.py:79-81)
    cfg.asset.penalize_contacts_on = ["thigh", "calf", "base"]
    cfg.asset.terminate_after_contacts_on = []

    # rewards (reference train.py:83-125)
    cfg.rewards.reward_container_name = "RewardsCrawling"
    cfg.rewards.small_vel_threshold = 0.1
    cfg.rewards.lin_reaching_criterion = 0.3
    cfg.rewards.ang_reaching_criterion = np.pi / 20.0
    cfg.rewards.only_positive_rewards = args.only_positive
    cfg.rewards.use_terminal_body_height = True
    cfg.rewards.terminal_body_height = args.terminal_body_height
    cfg.rewards.lin_vel_form = args.lin_vel_form
    cfg.rewards.exploration_steps = float("inf")
    cfg.rewards.tracking_sigma_lin = 0.05
    cfg.rewards.base_height_target = 0.28
    cfg.rewards.target_lin_vel = 0.25

    ps = args.penalty_scaler
    cfg.reward_scales.set("dof_acc", -2.5e-7 * ps)
    cfg.reward_scales.set("torques", -1e-5 * ps)
    cfg.reward_scales.set("action_rate", -1e-3 * ps)
    cfg.reward_scales.set("dof_pos_limits", -10.0 * ps)
    cfg.reward_scales.set("collision", -args.r_collision * ps)
    cfg.reward_scales.set("base_height", -args.r_base_height * ps)
    cfg.reward_scales.set("orientation", -args.r_orientation * ps)
    cfg.reward_scales.set("ang_vel_xy", -args.r_ang_vel * ps)
    cfg.reward_scales.set("large_vel", -args.r_large_vel * ps)
    cfg.reward_scales.set("reaching_z", 0.0)
    cfg.reward_scales.set("reaching_roll", 0.0)
    cfg.reward_scales.set("reaching_pitch", 0.0)
    cfg.reward_scales.set("e2e", 0.0)
    if args.strategy == "vel":
        cfg.rewards.T_reach = args.t_reach
        cfg.rewards.exploration_steps = 200000
    elif args.strategy == "e2e":
        cfg.reward_scales.set("e2e", args.r_task)
        cfg.rewards.T_reach = args.t_reach
        cfg.rewards.exploration_steps = args.exploration_steps
    cfg.reward_scales.set("exploration_lin", args.r_explore_lin)
    cfg.reward_scales.set("exploration_yaw", args.r_explore_yaw)

    # terrain (reference train.py:127-170)
    if args.num_envs is None:
        # the published goal run trained 4000 envs (run-20230904 config.yaml
        # num_envs); other strategies keep the reference train.py default
        args.num_envs = 4096 if args.strategy == "goal" else 1024
    cfg.env.num_envs = args.num_envs
    cfg.env.num_eval_envs = args.num_eval_envs
    cfg.terrain.num_cols = args.terrain_cols
    cfg.terrain.num_rows = args.terrain_rows
    if args.terrain == "plane":
        cfg.terrain.mesh_type = "plane"
    elif args.terrain == "single_path":
        cfg.terrain.mesh_type = "trimesh"
        cfg.terrain.terrain_type = "single_path"
        cfg.terrain.terrain_length = 4.0
        cfg.terrain.terrain_width = 2.0
        cfg.terrain.terrain_ratio_x = 0.9
        cfg.terrain.terrain_ratio_y = 0.5
        cfg.terrain.ceiling_height = 0.8
        cfg.terrain.start_loc = 0.32
        cfg.terrain.p_flat = 0.0 if args.empty_tunnel else 0.9
        cfg.terrain.p_double = 0.6
        cfg.env.episode_length_s = 10.0
        cfg.commands.sampling_based_planning = False
    elif args.terrain == "random_pyramid":
        # the published run-20230904 terrain: 2-layer pyramid-obstacle tunnel
        cfg.terrain.mesh_type = "trimesh"
        cfg.terrain.terrain_type = "random_pyramid"
        cfg.terrain.terrain_length = 5.0
        cfg.terrain.terrain_width = 1.6
        cfg.terrain.terrain_ratio_x = 0.5
        cfg.terrain.terrain_ratio_y = 1.0
        cfg.terrain.ceiling_height = 0.5
        cfg.terrain.start_loc = 0.4
        cfg.env.episode_length_s = 10.0
        cfg.commands.sampling_based_planning = False
    elif args.terrain == "multi_path":
        cfg.terrain.mesh_type = "trimesh"
        cfg.terrain.terrain_type = "multi_path"
        cfg.terrain.terrain_length = 3.0
        cfg.terrain.terrain_width = args.tunnel_width
        cfg.terrain.terrain_ratio_x = 0.9
        cfg.terrain.terrain_ratio_y = 0.25
        cfg.terrain.ceiling_height = 0.8
        cfg.env.episode_length_s = 8.0
        cfg.terrain.start_loc = 0.4
        cfg.commands.sampling_based_planning = True
        cfg.commands.plan_interval = 100

    if args.random_target:
        cfg.commands.traj_function = "random_target"
        cfg.commands.traj_length = 10
        cfg.commands.num_interpolation = 1
        cfg.commands.sampling_based_planning = False
    else:
        cfg.commands.traj_function = "fixed_target"
        cfg.commands.traj_length = 1
        cfg.commands.num_interpolation = 1
        cfg.commands.switch_dist = 0.3
        cfg.commands.base_x = cfg.terrain.terrain_length * cfg.terrain.terrain_ratio_x - 1.0

    if args.blind:
        cfg.env.observe_heights = False

    # domain randomization (reference train.py:187-241)
    en = not args.no_domain_rand
    cfg.domain_rand.lag_timesteps = 6
    cfg.domain_rand.randomize_lag_timesteps = True
    cfg.control.control_type = "actuator_net" if not args.pd_control else "P"
    cfg.domain_rand.randomize_rigids_after_start = False
    cfg.domain_rand.randomize_friction = en
    cfg.env.priv_observe_friction = True
    cfg.domain_rand.friction_range = [0.1, 3.0]
    cfg.domain_rand.randomize_restitution = en
    cfg.env.priv_observe_restitution = True
    cfg.domain_rand.restitution_range = [0.0, 0.4]
    cfg.domain_rand.randomize_base_mass = en
    cfg.env.priv_observe_base_mass = False
    cfg.domain_rand.added_mass_range = [-1.0, 3.0]
    cfg.domain_rand.randomize_gravity = en
    cfg.domain_rand.gravity_range = [-1.0, 1.0]
    cfg.domain_rand.gravity_rand_interval_s = 8.0
    cfg.domain_rand.gravity_impulse_duration = 0.99
    cfg.env.priv_observe_gravity = False
    cfg.domain_rand.randomize_com_displacement = False
    cfg.env.priv_observe_com_displacement = False
    cfg.domain_rand.randomize_motor_strength = en
    cfg.domain_rand.motor_strength_range = [0.9, 1.1]
    cfg.env.priv_observe_motor_strength = False
    cfg.domain_rand.randomize_motor_offset = en
    cfg.domain_rand.motor_offset_range = [-0.02, 0.02]
    cfg.env.priv_observe_motor_offset = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_Kp_factor = False
    cfg.env.priv_observe_Kp_factor = False
    cfg.domain_rand.randomize_Kd_factor = False
    cfg.env.priv_observe_Kd_factor = False
    cfg.env.priv_observe_body_velocity = False
    cfg.env.priv_observe_body_height = False

    cfg.normalization.friction_range = [0, 1]
    cfg.normalization.clip_actions = 10.0

    # the evaluation DR regimes as training ranges (reference train.py:183-186)
    if args.dr_profile:
        from .learn import domain_randomization_profiles as drp
        cfg = {"regular": drp.rand_regular, "large": drp.rand_large}[args.dr_profile](cfg)

    if args.strategy == "goal":
        _apply_goal_recipe(cfg)
        if args.cl_goal_target_dist is not None:
            cfg.curriculum_thresholds.cl_goal_target_dist = args.cl_goal_target_dist
        cfg.curriculum_thresholds.cl_downstep_threshold = args.cl_downstep
        cfg.curriculum_thresholds.cl_dist_mix = (
            0.25 if args.cl_dist_mix is None else args.cl_dist_mix)
        cfg.curriculum_thresholds.cl_stagnation_probe = args.cl_probe
        # restoring the peak snapshot on a downstep is a goal-strategy
        # default (--cl_restore_best 0 turns it off)
        cfg.curriculum_thresholds.cl_restore_best_on_downstep = bool(args.cl_restore_best)
        if args.max_noise_std is None:
            # the std ceiling is a goal-strategy default
            args.max_noise_std = 1.0
    if args.entropy_coef is None:
        # the published 0.01, for --strategy goal too
        args.entropy_coef = 0.01
    elif args.cl_dist_mix:
        cfg.curriculum_thresholds.cl_dist_mix = args.cl_dist_mix
    return cfg


def _apply_goal_recipe(cfg):
    """The reference's published reached=0.76 recipe (run-20230904_112307
    config.yaml): TrajectoryTrackingRewards (exploration + stalling +
    reach_goal) under a plain reward sum, valid_goal single-waypoint
    trajectories, and the fix-target curriculum growing the goal distance
    0.6 m -> 4.0 m at 80% reach rate over a 4000-episode window.  Applied
    last, so it overrides the generic strategy and DR wiring (the JAX
    package's ``scripts/train.py:_apply_goal_recipe`` lists what it leaves
    out of the reference)."""
    cfg.rewards.reward_container_name = "TrajectoryTrackingRewards"
    for name in ["base_height", "orientation", "ang_vel_xy", "large_vel",
                 "e2e", "exploration_lin", "exploration_yaw", "reaching_z",
                 "reaching_roll", "reaching_pitch"]:
        cfg.reward_scales.set(name, 0.0)
    cfg.reward_scales.set("torques", -2e-5)
    cfg.reward_scales.set("dof_acc", -5e-7)
    cfg.reward_scales.set("collision", -1.0)
    cfg.reward_scales.set("action_rate", -0.01)
    cfg.reward_scales.set("dof_pos_limits", -20.0)
    cfg.reward_scales.set("exploration", 1.0)
    cfg.reward_scales.set("stalling", 1.0)
    cfg.reward_scales.set("reach_goal", 200.0)
    cfg.rewards.only_positive_rewards = False
    cfg.rewards.only_positive_rewards_ji22_style = False
    cfg.rewards.target_lin_vel = 0.25
    cfg.rewards.lin_reaching_criterion = 0.01
    cfg.rewards.tracking_sigma_lin = 0.05
    cfg.rewards.target_ang_vel = np.pi / 2
    cfg.rewards.ang_reaching_criterion = np.pi / 20
    cfg.rewards.tracking_sigma_ang = 0.5
    cfg.rewards.T_reach = 200
    cfg.rewards.small_vel_threshold = 0.05
    cfg.rewards.large_dist_threshold = 0.5
    cfg.rewards.exploration_steps = 1_000_000
    cfg.rewards.base_height_target = 0.34
    cfg.rewards.use_terminal_body_height = False

    cfg.env.episode_length_s = 10.0
    cfg.env.terminate_end_of_trajectory = True
    cfg.env.camera_zero = False

    cfg.commands.traj_function = "valid_goal"
    cfg.commands.traj_length = 1
    cfg.commands.num_interpolation = 1
    cfg.commands.switch_upon_reach = True
    cfg.commands.switch_dist = 0.25
    cfg.commands.x_range = 0.4
    cfg.commands.y_range = 0.0
    cfg.commands.base_z = 0.34
    cfg.commands.sampling_based_planning = False

    ct = cfg.curriculum_thresholds
    ct.cl_fix_target = True
    ct.cl_start_target_dist = 0.6
    # the published 4.0; valid_goal targets past the obstacle window (about
    # 3.05 m from spawn) land on the sealed far border, where every opening
    # is zero (--cl_goal_target_dist overrides)
    ct.cl_goal_target_dist = 4.0
    ct.cl_switch_delta = 0.2
    ct.cl_switch_threshold = 0.8

    cfg.control.control_type = "P"
    cfg.control.stiffness = 20.0
    cfg.control.damping = 0.5
    cfg.control.action_scale = 0.25
    cfg.control.hip_scale_reduction = 0.5

    dr = cfg.domain_rand
    dr.randomize_friction = True
    dr.friction_range = [0.05, 4.5]
    dr.randomize_restitution = True
    dr.restitution_range = [0.0, 1.0]
    dr.randomize_base_mass = True
    dr.added_mass_range = [-1.0, 3.0]
    dr.randomize_com_displacement = True
    dr.com_displacement_range = [-0.1, 0.1]
    dr.randomize_motor_strength = True
    dr.motor_strength_range = [0.9, 1.1]
    dr.randomize_motor_offset = True
    dr.motor_offset_range = [-0.02, 0.02]
    dr.randomize_gravity = False
    dr.randomize_Kp_factor = False
    dr.randomize_Kd_factor = False
    dr.randomize_lag_timesteps = True
    dr.lag_timesteps = 6
    dr.push_robots = False
    # privileged obs: friction + restitution + payload + 3-dim COM = 6 dims
    # (the published run's num_privileged_obs)
    cfg.env.priv_observe_friction = True
    cfg.env.priv_observe_restitution = True
    cfg.env.priv_observe_base_mass = True
    cfg.env.priv_observe_com_displacement = True
    cfg.env.priv_observe_motor_strength = False
    cfg.env.priv_observe_motor_offset = False
    cfg.env.priv_observe_gravity = False
    cfg.normalization.friction_range = [0.05, 4.5]
    cfg.normalization.clip_actions = 100.0


def check_supported(args):
    """Raise NotImplementedError for a flag whose module is not ported."""
    if args.distributed or (args.num_devices or 1) > 1:
        raise NotImplementedError("--distributed/--num_devices need data parallelism "
                                  "(ROADMAP A13)")


def make_policy(args, cfg, env):
    """The policy of ``scripts/train.py:main`` (reference train.py:17-26,
    42-44): ``ActorCriticCNN`` with the MLP or conv height encoder and an
    optional GRU, or None (the runner's CSE MLP) with ``--old_ppo`` or
    without height observations."""
    from .learn.actor_critic_cnn import ACCnnArgs, ActorCriticCNN

    if args.old_ppo or not cfg.env.observe_heights:
        return None
    nx = len(cfg.terrain.measured_points_x)
    ny = len(cfg.terrain.measured_points_y)
    if cfg.terrain.measure_front_half:
        nx = nx - (nx // 2 + 1)
    return ActorCriticCNN(
        num_obs=env.num_obs, num_privileged_obs=env.num_privileged_obs,
        num_obs_history=env.num_obs_history, num_actions=env.num_actions,
        args=ACCnnArgs(use_cnn=args.cnn, use_gru=args.gru, height_map_shape=(2, nx, ny),
                       normalize_obs=args.normalize_obs,
                       critic_detach_encoder=args.critic_detach_encoder,
                       max_noise_std=args.max_noise_std))


def make_runner(args, cfg, env, **runner_kwargs):
    """The Runner that :func:`main` trains: the policy of
    :func:`make_policy` and the PPO and runner arguments of the flags
    (``runner_kwargs`` override RunnerArgs fields)."""
    from .learn.actor_critic import ACArgs
    from .learn.ppo import PPOArgs
    from .learn.runner import Runner, RunnerArgs

    ppo_args = PPOArgs(learning_rate=args.learning_rate, gamma=args.gamma,
                       num_steps_per_env=args.num_steps_per_env,
                       max_adaptive_lr=args.max_adaptive_lr,
                       entropy_coef=args.entropy_coef,
                       value_loss_coef=args.value_loss_coef,
                       max_grad_norm=args.max_grad_norm,
                       clip_param=args.clip_param)
    runner_args = RunnerArgs(**{"num_steps_per_env": args.num_steps_per_env,
                                "resume": args.resume,
                                "save_video_interval": args.save_video_interval,
                                "critic_warmup_iters": args.critic_warmup, **runner_kwargs})
    return Runner(env, runner_args=runner_args, ppo_args=ppo_args,
                  ac_args=ACArgs(normalize_obs=args.normalize_obs,
                                 max_noise_std=args.max_noise_std),
                  logdir=args.logdir, log_wandb=args.wandb, seed=args.seed,
                  ac=make_policy(args, cfg, env))


def main(args):
    from .envs import LeggedEnv

    check_supported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(--device cpu trains on the CPU)")
    cfg = build_cfg(args)
    env = LeggedEnv(cfg, device=device)
    print(f"env: {env.num_envs} envs | obs {env.num_obs} | priv {env.num_privileged_obs} "
          f"| rewards {env.reward_names} | device {device}")
    if args.wandb:
        import wandb
        wandb.init(project="legged_tracking_torch", config=vars(args),
                   name=args.name, dir=args.logdir)
    runner = make_runner(args, cfg, env)
    if args.reset_action_std is not None:
        # deflate an entropy-inflated policy std on resume (the mean and the
        # Adam moments resume as they were)
        with torch.no_grad():
            runner.train_state.params["std"].fill_(args.reset_action_std)
    return runner.learn(num_learning_iterations=args.iterations,
                        profile_dir=args.profile_dir,
                        update_model=not args.freeze_model)


def parse_args(argv=None):
    """The flags of ``scripts/train.py`` that the ported path reads, with
    ``--device`` for ``--cpu``."""
    p = argparse.ArgumentParser()
    p.add_argument("--name", type=str, default="trajectory_tracking")
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--strategy", default="vel", choices=["e2e", "pms", "vel", "goal"],
                   help="'goal' = the published run-20230904 recipe "
                        "(TrajectoryTrackingRewards + valid_goal + fix-target "
                        "curriculum); pair with --terrain random_pyramid")
    p.add_argument("--old_ppo", action="store_true",
                   help="the CSE MLP policy instead of ActorCriticCNN")
    p.add_argument("--cnn", action="store_true")
    p.add_argument("--gru", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for a CPU run)")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--iterations", type=int, default=10000)

    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--max_adaptive_lr", type=float, default=1e-2,
                   help="ceiling of the adaptive-KL learning rate")
    p.add_argument("--critic_warmup", type=int, default=0,
                   help="critic-only warmup iterations after --resume")
    p.add_argument("--critic_detach_encoder", action="store_true",
                   help="stop the value gradient at the shared height-map "
                        "encoder (CNN/GRU policies)")
    p.add_argument("--max_noise_std", type=float, default=None,
                   help="ceiling on the learned exploration std (None: no "
                        "ceiling; 1.0 for --strategy goal)")
    p.add_argument("--reset_action_std", type=float, default=None,
                   help="on resume, reset the policy std parameter to this value")
    p.add_argument("--entropy_coef", type=float, default=None,
                   help="entropy bonus (default: the published 0.01)")
    p.add_argument("--cl_goal_target_dist", type=float, default=None,
                   help="override the fix-target curriculum cap (published 4.0)")
    p.add_argument("--cl_downstep", type=float, default=0.5,
                   help="step the goal distance back when the reach window "
                        "falls below this (0 = off); only --strategy goal reads it")
    p.add_argument("--cl_dist_mix", type=float, default=None,
                   help="fraction of train envs rehearsing at easier goal "
                        "distances (default 0.25 for --strategy goal, else 0)")
    p.add_argument("--cl_probe", type=int, default=600,
                   help="stagnation probe: advance the frontier after this many "
                        "iterations without a curriculum switch while the reach "
                        "window is healthy (0 = off); only --strategy goal reads it")
    p.add_argument("--cl_restore_best", type=int, default=1,
                   help="on a downstep, restore the best-score snapshot (0 = off); "
                        "only --strategy goal reads it")
    p.add_argument("--dr_profile", choices=["regular", "large"], default="")
    p.add_argument("--value_loss_coef", type=float, default=1.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--clip_param", type=float, default=0.2)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--exploration_steps", type=int, default=2500)
    p.add_argument("--num_steps_per_env", type=int, default=24)
    p.add_argument("--normalize_obs", action="store_true")

    p.add_argument("--command_type", default="xy", choices=["xy", "6dof", "xy_norm"])
    p.add_argument("--timestep_in_obs", action="store_true")
    p.add_argument("--num_history", type=int, default=1)
    p.add_argument("--measure_front_half", action="store_true", default=True)
    p.add_argument("--no_measure_front_half", dest="measure_front_half", action="store_false")
    p.add_argument("--camera_zero", action="store_true", default=True)
    p.add_argument("--blind", action="store_true")
    p.add_argument("--pd_control", action="store_true")
    p.add_argument("--terminal_body_height", type=float, default=0.0)
    p.add_argument("--terrain", default="single_path",
                   choices=["single_path", "multi_path", "plane", "random_pyramid"])
    p.add_argument("--num_envs", type=int, default=None,
                   help="default 4096 for --strategy goal, else 1024 "
                        "(reference train.py:128)")
    p.add_argument("--num_eval_envs", type=int, default=0,
                   help="trailing held-out envs driven by the deterministic "
                        "policy, excluded from PPO updates")
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--freeze_model", action="store_true",
                   help="roll out without updating (reference scripts/train.py:278)")
    p.add_argument("--save_video_interval", type=int, default=0)
    p.add_argument("--terrain_rows", type=int, default=32)
    p.add_argument("--terrain_cols", type=int, default=32)
    p.add_argument("--tunnel_width", type=float, default=2.0)
    p.add_argument("--no_domain_rand", action="store_true")
    p.add_argument("--empty_tunnel", action="store_true")
    p.add_argument("--random_target", action="store_true")
    p.add_argument("--terminate_after_reach", action="store_true")

    p.add_argument("--lin_vel_form", default="exp", choices=["l1", "l2", "exp", "prod"])
    p.add_argument("--r_explore_lin", type=float, default=1.0)
    p.add_argument("--r_explore_yaw", type=float, default=0.4)
    p.add_argument("--penalty_scaler", type=float, default=1.0)
    p.add_argument("--only_positive", action="store_true")
    p.add_argument("--r_orientation", type=float, default=0.0)
    p.add_argument("--r_base_height", type=float, default=20.0)
    p.add_argument("--r_ang_vel", type=float, default=0.001)
    p.add_argument("--t_reach", type=int, default=0)
    p.add_argument("--r_task", type=float, default=1.0)
    p.add_argument("--r_collision", type=float, default=5.0)
    p.add_argument("--r_large_vel", type=float, default=0.0)
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
