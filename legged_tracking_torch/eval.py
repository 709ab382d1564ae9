"""Evaluation of a training run (counterpart of ``scripts/eval.py``): load a
checkpoint, roll the policy, write videos, plots and a metrics report.

    python -m legged_tracking_torch.eval --logdir runs/goal [--device cpu]

Rebuilds the env from the run's ``parameters.pkl`` (16 envs over a 4x4
terrain grid, DR and noise off), loads ``ac_weights_last.pkl`` into the
policy family its parameter tree names (CSE, CNN/GRU or RMA), rolls 500
steps and writes ``eval/env*.mp4``, ``eval/plots.png`` and
``eval/eval_report.json``: the nine metrics of ``learn/eval_metrics.py`` at
the rollout's final state, averaged over the envs, and the adaptation loss.
``--dr_profile`` evaluates under one of the DR regimes of
``learn/domain_randomization_profiles.py``, ``--dr_sweep`` under each.

Runs of either package load, without JAX (``io/checkpoint.load_pickle``).
It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .io.checkpoint import flax_params_to_state_dict, load_pickle
from .learn.domain_randomization_profiles import DR_PROFILES


def load_cfg(logdir):
    """The run's configuration (``parameters.pkl``), as the port's Cfg."""
    return load_pickle(os.path.join(logdir, "parameters.pkl"))


def load_env(logdir, num_envs=16, dr_profile=None, device="cuda"):
    """The run's env in the evaluation configuration: ``num_envs`` envs on a
    grid of at most 4x4 tiles that divides them, DR and noise off, then the
    DR profile (reference eval.py:81-106)."""
    from .envs import LeggedEnv
    from .envs.velocity_env import VelocityTrackingEnv

    cfg = load_cfg(logdir)
    cfg.env.num_envs = num_envs
    for k in list(vars(cfg.domain_rand)):
        if k.startswith("randomize"):
            setattr(cfg.domain_rand, k, False)
    cfg.noise.add_noise = False
    if dr_profile:
        cfg = DR_PROFILES[dr_profile](cfg)
    # the eval grid wins over a profile's rows and columns; it adapts so that
    # the env count stays divisible by the tile count
    g = 4
    while g > 1 and num_envs % (g * g):
        g -= 1
    cfg.terrain.num_rows = g
    cfg.terrain.num_cols = g
    cfg.terrain.teleport_robots = False
    cfg.parse()
    if cfg.env.command_type == "velocity":
        return VelocityTrackingEnv(cfg, device=device)
    return LeggedEnv(cfg, device=device)


def make_policy_module(env, params):
    """The policy family a checkpoint's flax tree names (reference
    eval.py:65-91): ActorCriticCNN (a ``height_map_encoder``; conv and GRU
    by their subtrees), ActorCriticRMA (an ``env_factor_encoder``), or None
    for the CSE MLP."""
    from .learn.actor_critic_cnn import ACCnnArgs, ActorCriticCNN
    from .learn.actor_critic_rma import ACRmaArgs, ActorCriticRMA

    top = params.get("params", {})
    dims = dict(num_obs=env.num_obs, num_privileged_obs=env.num_privileged_obs,
                num_obs_history=env.num_obs_history, num_actions=env.num_actions)
    if "height_map_encoder" in top:
        cfg = env.cfg
        nx = len(cfg.terrain.measured_points_x)
        ny = len(cfg.terrain.measured_points_y)
        if cfg.terrain.measure_front_half:
            nx = nx - (nx // 2 + 1)
        return ActorCriticCNN(**dims, args=ACCnnArgs(
            use_cnn="Conv_0" in top["height_map_encoder"], use_gru="gru" in top,
            height_map_shape=(2, nx, ny)))
    if "env_factor_encoder" in top:
        return ActorCriticRMA(**dims, args=ACRmaArgs())
    return None


def load_policy(env, logdir, ckpt="ac_weights_last.pkl"):
    """Returns (alg, policy): the PPO holding the checkpoint's parameters,
    and its student policy as a function of (obs, obs_history)."""
    from .learn.ppo import PPO, PPOArgs

    params = load_pickle(os.path.join(logdir, ckpt))["params"]
    alg = PPO(env, args=PPOArgs(), ac=make_policy_module(env, params))
    alg.ac.load_state_dict(flax_params_to_state_dict(params))
    return alg, lambda obs, hist: alg.act_inference(obs, hist.float())


def per_env_metrics(env, alg):
    """The nine metrics (the RMSDs only with commands) and the adaptation
    loss at the env's current state, each an (N,) tensor."""
    from .learn import eval_metrics

    out = {n: fn(env.state) for n, fn in eval_metrics.METRICS_FNS.items()
           if env.state.commands is not None or not n.endswith("rmsd")}
    out["adaptation_loss"] = eval_metrics.adaptation_loss(alg.ac, env.observe(env.state))
    return out


def rollout_metrics(env, alg, policy, steps, state=None):
    """Roll ``steps`` from a reset (or from ``state``) and return the
    metrics at the final state (reference eval.py:103-105), averaged over
    the envs, with the adaptation loss, and the recorded frames of every
    env.  The per-env values come to the host in one copy."""
    from .io.render import record_rollout

    if state is None:
        env.reset(randomize_ep_len=False)
    else:
        env.state = state
    frames = record_rollout(env, policy, steps, env_ids=range(env.num_envs))
    per_env = per_env_metrics(env, alg)
    values = torch.stack(list(per_env.values())).cpu().numpy()
    return {n: float(v.mean()) for n, v in zip(per_env, values)}, frames


def plot(frames, path):
    """Base x/z, roll/pitch and reward of every env over the rollout
    (reference eval.py:176-196)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .utils import quat as qt
    base = np.stack([f["base_pos"] for f in frames])   # (T, N, 3)
    quat = np.stack([f["base_quat"] for f in frames])
    rew = np.stack([f["rew"] for f in frames])
    rpy = qt.quaternion_to_roll_pitch_yaw(torch.as_tensor(quat)).numpy()
    fig, axes = plt.subplots(3, 1, figsize=(8, 8))
    for i in range(base.shape[1]):
        axes[0].plot(base[:, i, 0], alpha=0.4)
        axes[0].plot(base[:, i, 2], alpha=0.4)
        axes[1].plot(rpy[:, i, 0], alpha=0.4)
        axes[1].plot(rpy[:, i, 1], alpha=0.4)
        axes[2].plot(rew[:, i], alpha=0.4)
    axes[0].set_title("base x/z (all envs)")
    axes[1].set_title("roll/pitch")
    axes[2].set_title("reward")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def check_device(device):
    """The torch device of an entry's ``--device``; a CUDA device must
    exist (nothing moves to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(--device cpu runs on the CPU)")
    return device


def main(args):
    from .io.render import render_frames, write_mp4

    device = check_device(args.device)
    outdir = os.path.join(args.logdir, "eval")
    os.makedirs(outdir, exist_ok=True)
    report = {}

    env = load_env(args.logdir, args.num_envs, dr_profile=args.dr_profile, device=device)
    alg, policy = load_policy(env, args.logdir)
    m, frames = rollout_metrics(env, alg, policy, args.steps)
    report[args.dr_profile or "nominal"] = m
    print({k: round(v, 4) for k, v in m.items()})

    # per-env videos (reference eval.py:133-196 writes all 16 envs)
    if not args.no_video:
        n_vid = min(args.video_envs, env.num_envs)
        tiles = env.terrain.env_tile.cpu().numpy()
        for i in range(n_vid):
            imgs = render_frames(frames, env.terrain, env_id_pos=i, tile_idx=int(tiles[i]))
            write_mp4(imgs, os.path.join(outdir, f"env{i}.mp4"))
        print(f"wrote {outdir}/env[0-{n_vid - 1}].mp4")
    plot(frames, os.path.join(outdir, "plots.png"))
    print(f"wrote {outdir}/plots.png")

    # DR-profile sweep: metrics-only rollouts under each profile
    if args.dr_sweep:
        for name in DR_PROFILES:
            if name == "base_set":
                continue
            env_p = load_env(args.logdir, args.num_envs, dr_profile=name, device=device)
            alg_p, policy_p = load_policy(env_p, args.logdir)
            m_p, _ = rollout_metrics(env_p, alg_p, policy_p, args.sweep_steps)
            report[name] = m_p
            print(name, {k: round(v, 4) for k, v in m_p.items()})

    with open(os.path.join(outdir, "eval_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {outdir}/eval_report.json")
    return report


def parse_args(argv=None):
    """The flags of ``scripts/eval.py``, with ``--device`` for ``--cpu``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True)
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--sweep_steps", type=int, default=250)
    p.add_argument("--video_envs", type=int, default=16)
    p.add_argument("--no_video", action="store_true")
    p.add_argument("--dr_profile", default=None, choices=[None, *DR_PROFILES])
    p.add_argument("--dr_sweep", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a CPU run)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
