"""Watch a training run's current policy: render its latest checkpoint on
demand, optionally following the run as new checkpoints land (counterpart
of ``scripts/watch.py``).

    python -m legged_tracking_torch.watch --logdir runs/goal --follow --device cpu

renders ``ac_weights_last.pkl`` to ``<logdir>/watch/latest.mp4`` whenever
the checkpoint file changes (the Runner saves it every ``save_interval``
iterations and at exit); without ``--follow`` it renders once and exits.
Like every entry of the port it runs on the card unless ``--device cpu``
is given: pass ``--device cpu`` to stay off the card while a run trains
there.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time


def render_once(args, device, tag=""):
    from .eval import load_env, load_policy, rollout_metrics
    from .io.render import render_frames, write_mp4

    env = load_env(args.logdir, num_envs=args.num_envs, device=device)
    alg, policy = load_policy(env, args.logdir)
    metrics, frames = rollout_metrics(env, alg, policy, args.steps)
    outdir = os.path.join(args.logdir, "watch")
    os.makedirs(outdir, exist_ok=True)
    tile = int(env.terrain.env_tile[args.env_id])
    imgs = render_frames(frames[:: args.every], env.terrain, env_id_pos=args.env_id,
                         tile_idx=tile)
    out = write_mp4(imgs, os.path.join(outdir, f"latest{tag}.mp4"))
    line = " | ".join(f"{k} {v:.3f}" for k, v in sorted(metrics.items()))
    print(f"wrote {out}  [{line}]", flush=True)
    return out


def main(args):
    from .eval import check_device

    device = check_device(args.device)
    ckpt = os.path.join(args.logdir, "ac_weights_last.pkl")
    if not os.path.exists(ckpt):
        sys.exit(f"no checkpoint yet at {ckpt}")
    if not args.follow:
        return render_once(args, device)
    last_mtime = 0.0
    while True:
        m = os.path.getmtime(ckpt)
        if m > last_mtime:
            last_mtime = m
            tag = f"_{time.strftime('%H%M%S')}" if args.keep_history else ""
            try:
                render_once(args, device, tag)
            except (EOFError, pickle.UnpicklingError):
                time.sleep(2.0)  # checkpoint mid-write; retry next poll
                last_mtime = 0.0
        time.sleep(args.poll_s)


def parse_args(argv=None):
    """The flags of ``scripts/watch.py``, and ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True)
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--num_envs", type=int, default=4)
    p.add_argument("--env_id", type=int, default=0)
    p.add_argument("--every", type=int, default=2, help="render every Nth control step")
    p.add_argument("--follow", action="store_true",
                   help="keep polling for new checkpoints and re-render")
    p.add_argument("--poll_s", type=float, default=30.0)
    p.add_argument("--keep_history", action="store_true",
                   help="timestamped mp4 per checkpoint instead of overwrite")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu to stay off the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
