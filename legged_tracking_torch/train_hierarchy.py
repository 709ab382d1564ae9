"""Hierarchical waypoint-tracking training of the port, the planner (pms)
stack (counterpart of ``scripts/train_hierarchy.py``): terminate-on-reach
tracking over random_pyramid tunnels with the TrajectoryTrackingRewards
container and the batched sampling-based local planner.

    python -m legged_tracking_torch.train_hierarchy --logdir runs/hierarchy

It runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given.  ``--num_devices K`` trains the envs sharded over K ranks spawned
on this host (``--dist_backend`` as for ``legged_tracking_torch.train``).
"""

from __future__ import annotations

import argparse

import numpy as np


def build_cfg(args):
    """The port's copy of ``scripts/train_hierarchy.py:build_cfg``
    (reference eval_scripts/train_hierarchy_2.py)."""
    from .config import Cfg, config_go1

    cfg = config_go1(Cfg())
    cfg.seed = args.seed
    cfg.terrain.measured_points_x = np.linspace(-1, 1, 21)
    cfg.terrain.measured_points_y = np.linspace(-0.5, 0.5, 11)
    cfg.env.observe_heights = True
    cfg.env.num_envs = args.num_envs
    cfg.env.command_type = "xy"
    cfg.env.num_observation_history = 1
    cfg.env.terminate_end_of_trajectory = True
    cfg.env.episode_length_s = 20
    cfg.terrain.measure_front_half = True

    cfg.asset.penalize_contacts_on = ["thigh", "calf", "base"]
    cfg.asset.terminate_after_contacts_on = []

    # rewards (reference train_hierarchy_2.py:64-88)
    cfg.rewards.reward_container_name = "TrajectoryTrackingRewards"
    cfg.rewards.T_reach = 200
    cfg.rewards.small_vel_threshold = 0.1
    cfg.rewards.large_dist_threshold = 0.5
    cfg.rewards.only_positive_rewards = False
    cfg.rewards.use_terminal_body_height = False
    cfg.rewards.exploration_steps = float("inf")

    rs = cfg.reward_scales
    for k, _ in list(rs.items()):
        rs.set(k, 0.0)
    rs.set("stalling", args.r_stalling)
    rs.set("reaching_local_goal", 100.0)
    rs.set("reach_goal", 100.0)
    rs.set("exploration", args.r_explore)
    rs.set("dof_acc", -2.5e-7 * 2)
    rs.set("torques", -1e-5 * 2)
    rs.set("dof_pos_limits", -10.0 * 2)
    rs.set("collision", -1.0)
    rs.set("action_rate", -0.01)

    # terrain: random_pyramid tunnels (reference :90-115)
    if args.no_tunnel:
        cfg.terrain.mesh_type = "plane"
    else:
        t = cfg.terrain
        t.mesh_type = "trimesh"
        t.terrain_type = "random_pyramid"
        t.num_cols = args.terrain_cols
        t.num_rows = args.terrain_rows
        t.terrain_length = [3.0, 4.0, 5.0][min(args.difficulty_level, 2)]
        t.terrain_width = 1.6
        t.terrain_ratio_x = 0.5
        t.terrain_ratio_y = 1.0
        t.ceiling_height = 0.8
        for layer in (t.top, t.bottom):
            layer.pyramid_num_x = 3
            layer.pyramid_num_y = 5
            layer.pyramid_var_x = 0.3
            layer.pyramid_var_y = 0.3
            layer.pyramid_height_min = 0.15
            layer.pyramid_height_max = 0.35

    # hierarchical planning over candidate local goals (reference
    # train_hierarchy_2.py:117-139: fixed_target at 3.5 m ± 0.4,
    # plan_interval 100, switch_dist 0.20, base_z 0.29)
    c = cfg.commands
    c.traj_function = "fixed_target"
    c.traj_length = 1
    c.num_interpolation = 1
    c.x_mean = 3.5
    c.base_x = 3.5
    c.y_mean = 0.0
    c.x_range = 0.4
    c.y_range = 0.0
    c.base_z = 0.29
    c.switch_dist = 0.20
    c.sampling_based_planning = not args.no_planner
    c.plan_interval = args.plan_interval

    # fix-target curriculum over the goal distance, bootstrapped at 0.6 m
    # (the JAX script explains each value; --no_curriculum restores the
    # reference's fixed 3.5 m goals)
    if not args.no_curriculum:
        ct = cfg.curriculum_thresholds
        ct.cl_fix_target = True
        ct.cl_start_target_dist = 0.6
        ct.cl_goal_target_dist = 3.2
        ct.cl_switch_delta = 0.2
        ct.cl_switch_threshold = 0.6
        ct.cl_downstep_threshold = 0.3
        ct.cl_dist_mix = 0.25
        ct.cl_stagnation_probe = 600
        ct.cl_restore_best_on_downstep = True

    cfg.control.control_type = "actuator_net" if not args.pd_control else "P"
    cfg.domain_rand.randomize_lag_timesteps = True
    cfg.normalization.clip_actions = 10.0
    return cfg


def make_runner(args, env, **runner_kwargs):
    """The Runner that :func:`main` trains (``runner_kwargs`` override
    RunnerArgs fields): the CSE policy with the std ceiling and zero
    entropy, the goal task's lessons (the JAX script)."""
    from .learn.actor_critic import ACArgs
    from .learn.ppo import PPOArgs
    from .learn.runner import Runner, RunnerArgs

    return Runner(env,
                  runner_args=RunnerArgs(**{"resume": args.resume,
                                            "critic_warmup_iters": args.critic_warmup,
                                            **runner_kwargs}),
                  ppo_args=PPOArgs(learning_rate=args.learning_rate,
                                   entropy_coef=args.entropy_coef),
                  ac_args=ACArgs(max_noise_std=1.0), logdir=args.logdir,
                  seed=args.seed, num_devices=args.num_devices)


def main(args):
    """Train as the flags say, in one process or in ``--num_devices``
    ranks; returns the Runner's history (None from the parent of spawned
    ranks)."""
    from .parallel import run_ranks

    if args.num_devices is not None and args.num_devices < 1:
        raise ValueError(f"--num_devices {args.num_devices}: at least 1")
    return run_ranks(train_rank, args)


def train_rank(args):
    """The training of one process (a rank's, in a process group)."""
    from .envs import LeggedEnv
    from .parallel import entry_device, is_rank0

    device = entry_device(args.device)
    cfg = build_cfg(args)
    env = LeggedEnv(cfg, device=device)
    if is_rank0():
        print(f"env: {env.num_envs} envs | obs {env.num_obs} | rewards {env.reward_names} "
              f"| device {device}")
    return make_runner(args, env).learn(num_learning_iterations=args.iterations)


def parse_args(argv=None):
    """The flags of ``scripts/train_hierarchy.py``, with ``--device`` for
    ``--cpu``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for a CPU run)")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--num_envs", type=int, default=4000)
    p.add_argument("--terrain_rows", type=int, default=20)
    p.add_argument("--terrain_cols", type=int, default=20)
    p.add_argument("--difficulty_level", type=int, default=2)
    p.add_argument("--no_tunnel", action="store_true")
    p.add_argument("--no_planner", action="store_true")
    p.add_argument("--plan_interval", type=int, default=100,
                   help="replan every this many control steps "
                        "(reference train_hierarchy_2.py:131)")
    p.add_argument("--pd_control", action="store_true")
    # a positive scale: the stalling term is already -1 when stalling
    p.add_argument("--r_stalling", type=float, default=1.0)
    p.add_argument("--r_explore", type=float, default=1.0,
                   help="dense progress shaping toward the local goal")
    p.add_argument("--num_devices", type=int, default=None,
                   help="spawn this many ranks on this host, the envs sharded over them")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="collective backend (default nccl on CUDA, gloo on the CPU)")
    p.add_argument("--no_curriculum", action="store_true",
                   help="fixed 3.5 m goals, no fix-target curriculum")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint to resume (curriculum state included)")
    p.add_argument("--critic_warmup", type=int, default=0)
    p.add_argument("--entropy_coef", type=float, default=0.0)
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
