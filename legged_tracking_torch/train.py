"""Tunnel-crawling training entry of the port (counterpart of
``scripts/train.py``): builds the env, the Runner and the PPO arguments
from the same flags, then trains.

    python -m legged_tracking_torch.train --old_ppo --strategy e2e \\
        --num_envs 4096 --iterations 1000 --logdir runs/e2e

It runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given, and never moves to the CPU by itself.  Ported: ``--strategy e2e``
and ``vel`` with ``--old_ppo`` (the CSE MLP policy).  Flags that need a
module the port does not have yet raise ``NotImplementedError`` naming it.
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
        args.num_envs = 1024        # reference train.py:128
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

    if args.entropy_coef is None:
        args.entropy_coef = 0.01
    elif args.cl_dist_mix:
        cfg.curriculum_thresholds.cl_dist_mix = args.cl_dist_mix
    return cfg


def check_supported(args):
    """Raise NotImplementedError for a flag whose module is not ported."""
    missing = [
        (not args.old_ppo, "the default policy (without --old_ppo) is ActorCriticCNN, "
                           "learn/actor_critic_cnn.py (ROADMAP A11)"),
        (args.cnn or args.gru, "--cnn/--gru need learn/actor_critic_cnn.py (ROADMAP A11)"),
        (args.strategy == "goal", "--strategy goal needs TrajectoryTrackingRewards and "
                                  "the valid_goal trajectories (ROADMAP A9)"),
        (args.strategy == "pms", "--strategy pms needs the sampling-based planner "
                                 "(ROADMAP A9)"),
        (args.terrain == "multi_path", "--terrain multi_path needs the sampling-based "
                                       "planner (ROADMAP A9)"),
        (args.random_target, "--random_target needs envs/trajectories.py random_target "
                             "(ROADMAP A9)"),
        (bool(args.dr_profile), "--dr_profile needs learn/domain_randomization_profiles.py "
                                "(ROADMAP A12)"),
        (args.distributed or (args.num_devices or 1) > 1,
         "--distributed/--num_devices need data parallelism (ROADMAP A13)"),
        (args.save_video_interval > 0, "--save_video_interval needs the training video "
                                       "(ROADMAP A12)"),
    ]
    for bad, why in missing:
        if bad:
            raise NotImplementedError(why)


def main(args):
    from .envs import LeggedEnv
    from .learn.actor_critic import ACArgs
    from .learn.ppo import PPOArgs
    from .learn.runner import Runner, RunnerArgs

    check_supported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(--device cpu trains on the CPU)")
    cfg = build_cfg(args)
    env = LeggedEnv(cfg, device=device)
    print(f"env: {env.num_envs} envs | obs {env.num_obs} | priv {env.num_privileged_obs} "
          f"| rewards {env.reward_names} | device {device}")

    ppo_args = PPOArgs(learning_rate=args.learning_rate, gamma=args.gamma,
                       num_steps_per_env=args.num_steps_per_env,
                       max_adaptive_lr=args.max_adaptive_lr,
                       entropy_coef=args.entropy_coef,
                       value_loss_coef=args.value_loss_coef,
                       max_grad_norm=args.max_grad_norm,
                       clip_param=args.clip_param)
    runner_args = RunnerArgs(num_steps_per_env=args.num_steps_per_env,
                             resume=args.resume,
                             save_video_interval=args.save_video_interval,
                             critic_warmup_iters=args.critic_warmup)
    if args.wandb:
        import wandb
        wandb.init(project="legged_tracking_torch", config=vars(args),
                   name=args.name, dir=args.logdir)
    runner = Runner(env, runner_args=runner_args, ppo_args=ppo_args,
                    ac_args=ACArgs(normalize_obs=args.normalize_obs,
                                   max_noise_std=args.max_noise_std),
                    logdir=args.logdir, log_wandb=args.wandb, seed=args.seed)
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
    p.add_argument("--strategy", default="vel", choices=["e2e", "pms", "vel", "goal"])
    p.add_argument("--old_ppo", action="store_true",
                   help="the CSE MLP policy (the only one ported)")
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
    p.add_argument("--max_noise_std", type=float, default=None,
                   help="ceiling on the learned exploration std (None: no ceiling)")
    p.add_argument("--reset_action_std", type=float, default=None,
                   help="on resume, reset the policy std parameter to this value")
    p.add_argument("--entropy_coef", type=float, default=None,
                   help="entropy bonus (default: the published 0.01)")
    p.add_argument("--cl_dist_mix", type=float, default=None,
                   help="fraction of train envs rehearsing at easier goal distances")
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
                   help="default 1024 (reference train.py:128)")
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
