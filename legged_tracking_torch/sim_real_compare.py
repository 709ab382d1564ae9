"""Sim-vs-real observation comparison (counterpart of
``scripts/sim_real_compare.py``).

    python -m legged_tracking_torch.sim_real_compare --logdir D --real_log deploy_log.pkl

Given a robot deployment log (the ``deploy_log.pkl`` list of dicts that
DeploymentRunner writes, entries with "t", "obs" and "action") and a
training run's directory, replays the logged actions through the port's sim
from a nominal reset and compares the observations channel by channel
(RMSE, and a plot of the traces).  A replay of a log the sim wrote itself
reproduces it to about zero RMSE.  It runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch


def compare(logdir: str, real_log: str, steps: int = 250, channels: int = 45,
            plot: bool = True, device="cuda"):
    """Replay the logged actions through the sim; return (rmse, sim, real)."""
    from .envs import LeggedEnv
    from .eval import load_cfg

    cfg = load_cfg(logdir)
    with open(real_log, "rb") as f:
        log = pickle.load(f)

    real_obs = np.stack([np.asarray(e["obs"]).reshape(-1) for e in log])
    actions = np.stack([np.asarray(e["action"]).reshape(-1) for e in log])
    T = min(len(real_obs), steps)

    cfg.env.num_envs = 1
    cfg.terrain.mesh_type = "plane"
    cfg.noise.add_noise = False
    for k in list(vars(cfg.domain_rand)):
        if k.startswith("randomize"):
            setattr(cfg.domain_rand, k, False)
    cfg.parse()
    env = LeggedEnv(cfg, device=device)
    env.reset(randomize_ep_len=False)

    sim_obs = []
    for t in range(T):
        od, _, _, _ = env.step(torch.as_tensor(actions[t][None], dtype=torch.float32,
                                               device=env.device))
        sim_obs.append(od["obs"][0])
    sim_obs = torch.stack(sim_obs).cpu().numpy()

    n = min(sim_obs.shape[1], real_obs.shape[1], channels)
    rmse = np.sqrt(np.mean((sim_obs[:T, :n] - real_obs[:T, :n]) ** 2, axis=0))

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        rows = int(np.ceil(n / 3))
        fig, axes = plt.subplots(rows, 3, figsize=(14, 2.2 * rows))
        for i in range(n):
            ax = axes.flat[i]
            ax.plot(real_obs[:T, i], label="real", lw=0.8)
            ax.plot(sim_obs[:T, i], label="sim", lw=0.8)
            ax.set_title(f"obs[{i}]", fontsize=8)
        axes.flat[0].legend()
        out = os.path.join(logdir, "sim_real_compare.png")
        fig.tight_layout()
        fig.savefig(out, dpi=100)
        plt.close(fig)
        print(f"wrote {out}")

    return rmse, sim_obs[:T, :n], real_obs[:T, :n]


def main(args):
    from .eval import check_device

    rmse, _, _ = compare(args.logdir, args.real_log, args.steps, args.channels,
                         device=check_device(args.device))
    print("per-channel RMSE (first 12):", np.round(rmse[:12], 4))
    return rmse


def parse_args(argv=None):
    """The flags of ``scripts/sim_real_compare.py``, with ``--device`` for
    ``--cpu``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True)
    p.add_argument("--real_log", required=True)
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--channels", type=int, default=45)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a CPU run)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
