"""Hierarchical (planner-in-the-loop) rollout of a trained policy
(counterpart of ``scripts/play_hierarchical.py``).

    python -m legged_tracking_torch.play_hierarchical --logdir runs/hier [--device cpu]

Rebuilds the env from a run's parameters with ``sampling_based_planning``
on (the batched local planner picks an intermediate target pose among
``candidate_target_poses`` every ``plan_interval`` steps), rolls the policy
toward a fixed target 5 m ahead, prints the episodic reward sums and
writes ``hierarchical/output.mp4`` (reference
scripts_archived_1/deploy_hierarchical.py:115-180).  It runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_env(logdir, num_envs=1, plan_interval=100, device="cuda"):
    """The run's env with the planner in the loop, DR and noise off
    (reference deploy_hierarchical.py:83-128)."""
    from .envs import LeggedEnv
    from .eval import load_cfg

    cfg = load_cfg(logdir)
    cfg.env.num_envs = num_envs
    cfg.terrain.num_rows = max(int(np.sqrt(num_envs)), 1)
    cfg.terrain.num_cols = max(num_envs // cfg.terrain.num_rows, 1)
    for k in list(vars(cfg.domain_rand)):
        if k.startswith("randomize"):
            setattr(cfg.domain_rand, k, False)
    cfg.noise.add_noise = False
    cfg.commands.traj_function = "fixed_target"
    cfg.commands.traj_length = 1
    cfg.commands.num_interpolation = 1
    cfg.commands.base_x = 5.0
    cfg.commands.base_y = 0.0
    cfg.commands.sampling_based_planning = True
    cfg.commands.plan_interval = plan_interval
    cfg.commands.switch_dist = 0.25
    cfg.curriculum_thresholds.cl_fix_target = False
    cfg.parse()
    return LeggedEnv(cfg, device=device)


def play(env, policy, steps):
    """Reset, roll ``steps`` and return (episodic reward sums averaged over
    the envs, the recorded frames)."""
    from .io.render import record_rollout

    env.reset(randomize_ep_len=False)
    frames = record_rollout(env, policy, steps, env_ids=range(env.num_envs))
    sums = env.state.episode_sums.cpu().numpy()
    return {n: float(sums[:, i].mean()) for i, n in enumerate(env.metric_names)}, frames


def main(args):
    from .eval import check_device, load_policy
    from .io.render import render_frames, write_mp4

    env = load_env(args.logdir, args.num_envs, args.plan_interval, check_device(args.device))
    _, policy = load_policy(env, args.logdir)
    rec, frames = play(env, policy, args.steps)
    print({k: round(v, 3) for k, v in rec.items()
           if k in ("exploration", "reaching_local_goal", "total") or k.startswith("reach")})
    if not args.no_video:
        outdir = os.path.join(args.logdir, "hierarchical")
        os.makedirs(outdir, exist_ok=True)
        imgs = render_frames(frames, env.terrain, tile_idx=int(env.terrain.env_tile[0]))
        print(f"wrote {write_mp4(imgs, os.path.join(outdir, 'output.mp4'))}")
    return rec


def parse_args(argv=None):
    """The flags of ``scripts/play_hierarchical.py``, with ``--device`` for
    ``--cpu``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True)
    p.add_argument("--num_envs", type=int, default=1)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--plan_interval", type=int, default=100)
    p.add_argument("--no_video", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a CPU run)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
