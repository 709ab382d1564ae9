"""Deterministic goal-reach evaluation of a trajectory-tracking checkpoint
(counterpart of ``scripts/eval_reached.py``).

    python -m legged_tracking_torch.eval_reached --logdir runs/goal [--device cpu]

Rolls the deterministic student policy under training conditions (DR and
noise on, unlike ``eval``) and reports the done-masked reached fraction:
the number the reference's wandb ``reached`` corresponds to, without the
action-sampling noise.  The episode, reach and length counts accumulate on
the device and are read once, at the end.  It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

# past this many steps a --target_dist run first burns in: the episodes begun
# at the configuration's start distance have all ended
BURN_IN_STEPS = 501


def rollout_counts(env, policy, state, obs, steps):
    """``steps`` steps of the policy from (state, obs): returns (state, obs,
    counts), counts an int64 device tensor of (episodes ended, of them
    reached, their summed lengths)."""
    counts = torch.zeros(3, dtype=torch.int64, device=env.device)
    for _ in range(steps):
        state, out = env.step_fn(state, policy(obs["obs"], obs["obs_history"]))
        obs = {"obs": out.obs, "obs_history": out.obs_history,
               "privileged_obs": out.privileged_obs}
        d = out.done
        counts += torch.stack([d.sum(), (d & out.info["reached"]).sum(),
                               (d * out.info["episode_length"]).sum()])
    return state, obs, counts


def load(logdir, num_envs=1024, ckpt=None, device="cuda"):
    """The run's env under its training conditions at ``num_envs`` envs,
    and the student policy of its checkpoint (``ckpt``, default the last)."""
    from .envs import LeggedEnv
    from .eval import load_cfg, load_policy

    cfg = load_cfg(logdir)
    cfg.env.num_envs = num_envs
    cfg.parse()
    env = LeggedEnv(cfg, device=device)
    _, policy = load_policy(env, logdir, ckpt or "ac_weights_last.pkl")
    return env, policy


def evaluate(env, policy, steps=1200, seed=7, target_dist=None):
    """The reached fraction of ``policy`` over ``steps`` steps from a reset
    seeded by ``seed``, with the episode count and mean episode length."""
    env.generator.manual_seed(seed)
    state = env.reset_fn(True)
    if target_dist is not None:
        # the curriculum distance of the state only: the trajectories drawn
        # at reset keep the configuration's start distance
        state = state._replace(target_dist=torch.tensor(target_dist, dtype=torch.float32,
                                                        device=env.device))
    obs = env.observe(state)
    state, obs, counts = rollout_counts(env, policy, state, obs, steps)
    if target_dist is not None and steps > BURN_IN_STEPS:
        # the first window was burn-in: count a fresh one at the distance
        state, obs, counts = rollout_counts(env, policy, state, obs, steps)
    n_done, n_reached, ep_len_sum = (int(x) for x in counts.cpu())
    return {"episodes": n_done, "reached": n_reached / max(n_done, 1),
            "mean_ep_len": ep_len_sum / max(n_done, 1),
            "target_dist": target_dist or "cfg-start"}


def main(args):
    from .eval import check_device

    env, policy = load(args.logdir, args.num_envs, args.ckpt, check_device(args.device))
    rec = evaluate(env, policy, args.steps, args.seed, args.target_dist)
    print({**rec, "reached": round(rec["reached"], 4),
           "mean_ep_len": round(rec["mean_ep_len"], 1), "ckpt": args.ckpt or "last"})
    return rec["reached"]


def parse_args(argv=None):
    """The flags of ``scripts/eval_reached.py``, with ``--device`` for
    ``--cpu``."""
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint filename inside logdir (default: last)")
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--target_dist", type=float, default=None,
                   help="evaluate at this curriculum goal distance")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a CPU run)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
