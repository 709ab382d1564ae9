"""Walk-these-ways (MoB) velocity-tracking training entry of the port
(counterpart of ``scripts/train_velocity_tracking.py``): the 15-dim command
curriculum, gait-shaped CoRL rewards, ji22-style reward shaping, 30x30 tiles
of 5 m, a 70-dim obs with a 30-frame history, trained with the CSE policy.

    python -m legged_tracking_torch.train_velocity_tracking --logdir runs/vel

It runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given, and never moves to the CPU by itself.  ``--num_devices K`` trains
the envs sharded over K ranks spawned on this host (``--dist_backend`` as
for ``legged_tracking_torch.train``).
"""

from __future__ import annotations

import argparse

import torch


def build_cfg(args):
    """The port's copy of ``scripts/train_velocity_tracking.py:build_cfg``."""
    from .config import Cfg, config_go1

    cfg = config_go1(Cfg())
    cfg.seed = args.seed
    cfg.env.num_envs = args.num_envs

    # observation space (reference train_velocity_tracking.py:20-92)
    cfg.env.observe_heights = False
    cfg.terrain.measure_heights = False
    cfg.env.observe_vel = False
    cfg.env.num_observation_history = args.num_history
    cfg.env.observe_two_prev_actions = True
    cfg.env.observe_yaw = False
    cfg.env.observe_gait_commands = True
    cfg.env.observe_timing_parameter = False
    cfg.env.observe_clock_inputs = True
    cfg.commands.num_commands = 15

    cfg.domain_rand.lag_timesteps = 6
    cfg.domain_rand.randomize_lag_timesteps = True
    cfg.control.control_type = "actuator_net" if not args.pd_control else "P"
    cfg.domain_rand.randomize_rigids_after_start = False
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = [0.1, 3.0]
    cfg.env.priv_observe_friction = True
    cfg.domain_rand.randomize_restitution = True
    cfg.domain_rand.restitution_range = [0.0, 0.4]
    cfg.env.priv_observe_restitution = True
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [-1.0, 3.0]
    cfg.env.priv_observe_base_mass = False
    cfg.domain_rand.randomize_gravity = True
    cfg.domain_rand.gravity_range = [-1.0, 1.0]
    cfg.domain_rand.gravity_rand_interval_s = 8.0
    cfg.domain_rand.gravity_impulse_duration = 0.99
    cfg.env.priv_observe_gravity = False
    cfg.domain_rand.randomize_com_displacement = False
    cfg.env.priv_observe_com_displacement = False
    cfg.domain_rand.randomize_motor_strength = True
    cfg.domain_rand.motor_strength_range = [0.9, 1.1]
    cfg.env.priv_observe_motor_strength = False
    cfg.domain_rand.randomize_motor_offset = True
    cfg.domain_rand.motor_offset_range = [-0.02, 0.02]
    cfg.env.priv_observe_motor_offset = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_Kp_factor = False
    cfg.env.priv_observe_Kp_factor = False
    cfg.domain_rand.randomize_Kd_factor = False
    cfg.env.priv_observe_Kd_factor = False
    cfg.env.priv_observe_body_velocity = False
    cfg.env.priv_observe_body_height = False
    cfg.domain_rand.rand_interval_s = 4

    # terrain (reference :97-116)
    cfg.terrain.mesh_type = args.terrain
    cfg.terrain.num_cols = args.terrain_cols
    cfg.terrain.num_rows = args.terrain_rows
    cfg.terrain.terrain_width = 5.0
    cfg.terrain.terrain_length = 5.0
    cfg.terrain.x_init_range = 0.2
    cfg.terrain.y_init_range = 0.2
    cfg.terrain.yaw_init_range = 3.14
    cfg.terrain.teleport_robots = False
    cfg.terrain.horizontal_scale = 0.10
    cfg.terrain.terrain_proportions = [0.0] * 8 + [0.99, 0.0]
    cfg.terrain.terrain_noise_magnitude = 0.0
    cfg.terrain.curriculum = False

    # rewards (reference :112-153)
    cfg.rewards.use_terminal_body_height = True
    cfg.rewards.terminal_body_height = 0.05
    cfg.rewards.use_terminal_roll_pitch = True
    cfg.rewards.terminal_body_ori = 1.6
    cfg.rewards.base_height_target = 0.30
    cfg.rewards.kappa_gait_probs = 0.07
    cfg.rewards.gait_force_sigma = 100.0
    cfg.rewards.gait_vel_sigma = 10.0
    cfg.rewards.reward_container_name = "CoRLRewards"
    cfg.rewards.only_positive_rewards = args.only_positive
    cfg.rewards.only_positive_rewards_ji22_style = not args.only_positive
    cfg.rewards.sigma_rew_neg = args.sigma_rew_neg
    cfg.sim.contact_report_ema = args.contact_ema

    rs = cfg.reward_scales
    # zero out the tunnel task's defaults
    for k, _ in list(rs.items()):
        rs.set(k, 0.0)
    rs.set("tracking_lin_vel", 1.0)
    rs.set("tracking_ang_vel", 0.5)
    rs.set("lin_vel_z", -0.02)
    rs.set("ang_vel_xy", -0.001)
    rs.set("orientation", 0.0)
    rs.set("torques", -0.0001)
    rs.set("dof_acc", -2.5e-7)
    rs.set("collision", -5.0)
    rs.set("action_rate", -0.01)
    rs.set("dof_pos_limits", -10.0)
    rs.set("jump", 10.0)
    rs.set("tracking_contacts_shaped_force", 4.0)
    rs.set("tracking_contacts_shaped_vel", 4.0)
    rs.set("dof_vel", -1e-4)
    rs.set("action_smoothness_1", -0.1)
    rs.set("action_smoothness_2", -0.1)
    rs.set("feet_slip", -0.04)
    rs.set("feet_clearance_cmd_linear", -30.0)
    rs.set("feet_impact_vel", -0.0)
    rs.set("orientation_control", -5.0)
    rs.set("raibert_heuristic", -10.0)

    # command space (reference :155-208)
    c = cfg.commands
    c.command_curriculum = True
    c.resampling_time = 10.0
    c.lin_vel_x = [-1.0, 1.0]
    c.lin_vel_y = [-0.6, 0.6]
    c.ang_vel_yaw = [-1.0, 1.0]
    c.body_height_cmd = [-0.25, 0.15]
    c.gait_frequency_cmd_range = [2.0, 4.0]
    c.gait_phase_cmd_range = [0.0, 1.0]
    c.gait_offset_cmd_range = [0.0, 1.0]
    c.gait_bound_cmd_range = [0.0, 1.0]
    c.gait_duration_cmd_range = [0.5, 0.5]
    c.footswing_height_range = [0.03, 0.35]
    c.body_pitch_range = [-0.4, 0.4]
    c.body_roll_range = [-0.0, 0.0]
    c.stance_width_range = [0.10, 0.45]
    c.stance_length_range = [0.35, 0.45]
    c.limit_vel_x = [-5.0, 5.0]
    c.limit_vel_y = [-0.6, 0.6]
    c.limit_vel_yaw = [-5.0, 5.0]
    c.limit_body_height = [-0.25, 0.15]
    c.limit_gait_frequency = [2.0, 4.0]
    c.limit_gait_phase = [0.0, 1.0]
    c.limit_gait_offset = [0.0, 1.0]
    c.limit_gait_bound = [0.0, 1.0]
    c.limit_gait_duration = [0.5, 0.5]
    c.limit_footswing_height = [0.03, 0.35]
    c.limit_body_pitch = [-0.4, 0.4]
    c.limit_body_roll = [-0.0, 0.0]
    c.limit_stance_width = [0.10, 0.45]
    c.limit_stance_length = [0.35, 0.45]
    c.num_bins_vel_x = 21
    c.num_bins_vel_y = 1
    c.num_bins_vel_yaw = 21
    c.exclusive_phase_offset = False
    c.pacing_offset = False
    c.binary_phases = True
    c.gaitwise_curricula = True

    cfg.normalization.friction_range = [0, 1]
    cfg.normalization.clip_actions = 10.0
    cfg.env.episode_length_s = 20.0
    return cfg


def check_supported(args):
    """Raise for a flag value the entry cannot train with (every flag's
    module is ported)."""
    if args.num_devices is not None and args.num_devices < 1:
        raise ValueError(f"--num_devices {args.num_devices}: at least 1")


def make_runner(args, env, **runner_kwargs):
    """The Runner that :func:`main` trains (the CSE policy, the PPO and
    runner arguments of the flags; ``runner_kwargs`` override RunnerArgs
    fields), with the policy std reset to ``--reset_action_std`` if given."""
    from .learn.actor_critic import ACArgs
    from .learn.ppo import PPOArgs
    from .learn.runner import Runner, RunnerArgs

    ppo_args = PPOArgs(learning_rate=args.learning_rate, gamma=args.gamma,
                       num_steps_per_env=args.num_steps_per_env,
                       entropy_coef=args.entropy_coef,
                       max_adaptive_lr=args.max_adaptive_lr)
    runner = Runner(env, runner_args=RunnerArgs(**{"num_steps_per_env": args.num_steps_per_env,
                                                   "resume": args.resume, **runner_kwargs}),
                    ppo_args=ppo_args, ac_args=ACArgs(max_noise_std=args.max_noise_std),
                    logdir=args.logdir, log_wandb=args.wandb, seed=args.seed,
                    num_devices=args.num_devices)
    if args.reset_action_std is not None:
        with torch.no_grad():
            runner.train_state.params["std"].fill_(args.reset_action_std)
    return runner


def main(args):
    """Train as the flags say, in one process or in ``--num_devices``
    ranks; returns the Runner's history (None from the parent of spawned
    ranks)."""
    from .parallel import run_ranks

    check_supported(args)
    return run_ranks(train_rank, args)


def train_rank(args):
    """The training of one process (a rank's, in a process group)."""
    from .envs.velocity_env import VelocityTrackingEnv
    from .parallel import entry_device, is_rank0

    device = entry_device(args.device)
    cfg = build_cfg(args)
    env = VelocityTrackingEnv(cfg, device=device)
    if is_rank0():
        print(f"env: {env.num_envs} envs | obs {env.num_obs} | priv {env.num_privileged_obs} "
              f"| rewards {env.reward_names} | device {device}")
    if args.wandb and is_rank0():
        import wandb
        wandb.init(project="legged_tracking_torch", config=vars(args), dir=args.logdir)
    runner = make_runner(args, env)
    return runner.learn(num_learning_iterations=args.iterations, profile_dir=args.profile_dir)


def parse_args(argv=None):
    """The flags of ``scripts/train_velocity_tracking.py``, with ``--device``
    for ``--cpu``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for a CPU run)")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--num_steps_per_env", type=int, default=24)
    p.add_argument("--num_history", type=int, default=30)
    p.add_argument("--num_envs", type=int, default=4000)
    p.add_argument("--num_devices", type=int, default=None,
                   help="spawn this many ranks on this host, the envs sharded over them")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="collective backend (default nccl on CUDA, gloo on the CPU)")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--terrain", default="trimesh", choices=["plane", "trimesh"])
    p.add_argument("--terrain_rows", type=int, default=30)
    p.add_argument("--terrain_cols", type=int, default=30)
    p.add_argument("--pd_control", action="store_true")
    # ji22 shaping knobs (the reference velocity config's defaults)
    p.add_argument("--sigma_rew_neg", type=float, default=0.02)
    p.add_argument("--contact_ema", type=float, default=0.0,
                   help="EMA smoothing of reported contact forces "
                        "(SimCfg.contact_report_ema)")
    p.add_argument("--entropy_coef", type=float, default=0.01)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--reset_action_std", type=float, default=None)
    p.add_argument("--max_noise_std", type=float, default=None,
                   help="ceiling on the learned exploration std")
    p.add_argument("--max_adaptive_lr", type=float, default=1e-2)
    p.add_argument("--only_positive", action="store_true")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
