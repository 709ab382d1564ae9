"""The reference's learner: the rollout, GAE and the PPO update of the
walk-these-ways PPO (ppo_cse/ppo.py, rollout_storage.py) written as their
formulas in plain PyTorch, for any policy of ``plain/learn`` (it calls
``action_dist``, ``evaluate`` and ``adapt``).  Adam is optax's, step by
step: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr (m
/ (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.  The adaptive learning
rate is a Python float, stepped by each minibatch's KL.

It covers the configurations' PPO: no held-out eval envs, no observation
normalization, no windowed histories, ``randperm`` shuffling.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

FIELDS = ("obs", "privileged_obs", "obs_history", "actions", "rewards", "dones", "values",
          "log_prob", "mu", "sigma")


class Adam(NamedTuple):
    count: int
    m: dict
    v: dict


def adam_init(params: dict) -> Adam:
    return Adam(0, {k: torch.zeros_like(p) for k, p in params.items()},
                {k: torch.zeros_like(p) for k, p in params.items()})


@torch.no_grad()
def adam_step(params: dict, grads: dict, s: Adam, lr: float, b1=0.9, b2=0.999,
              eps=1e-8) -> Adam:
    t = s.count + 1
    m, v = {}, {}
    for k, p in params.items():
        g = grads[k]
        m[k] = b1 * s.m[k] + (1 - b1) * g
        v[k] = b2 * s.v[k] + (1 - b2) * g * g
        p -= lr * (m[k] / (1 - b1 ** t)) / (torch.sqrt(v[k] / (1 - b2 ** t)) + eps)
    return Adam(t, m, v)


def log_prob(mean, std, a):
    return torch.sum(-0.5 * ((a - mean) / std) ** 2 - torch.log(std)
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def policy(ac, o, p, h):
    """Action mean, std (expanded) and value of the policy."""
    mean, std = ac.action_dist(o, p, h)
    return mean, std.expand_as(mean), ac.evaluate(o, p, h)


def grads_of(loss, params: dict) -> dict:
    g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if x is None else x
            for (k, p), x in zip(params.items(), g)}


@torch.no_grad()
def rollout(env, ac, gen, state, obs, T: int, gamma: float, record: list | None = None):
    """T steps of act -> ``env.step_fn`` -> store, the timeout bootstrap
    ``r + gamma V(s) time_out`` in the stored reward.  ``record`` (a list)
    takes each step's input state, the env generator's state, and the raw
    reward and time-outs.  Returns (state, last obs, the trajectory as a
    dict of (T, N, ...) tensors)."""
    traj = {k: [] for k in FIELDS}
    for _ in range(T):
        o, p, h16 = obs["obs"], obs["privileged_obs"], obs["obs_history"]
        mean, std, value = policy(ac, o, p, h16.float())
        eps = torch.randn(mean.shape, generator=gen, device=mean.device)
        actions = mean + std * eps
        gen_state = env.generator.get_state()
        new, out = env.step_fn(state, actions)
        if record is not None:
            record.append({"state": state, "gen": gen_state, "rew": out.rew,
                           "time_outs": out.info["time_outs"]})
        state = new
        for k, x in zip(FIELDS, (o, p, h16, actions,
                                 out.rew + gamma * value * out.info["time_outs"], out.done,
                                 value, log_prob(mean, std, actions), mean, std)):
            traj[k].append(x)
        obs = {"obs": out.obs, "privileged_obs": out.privileged_obs,
               "obs_history": out.obs_history}
    return state, obs, {k: torch.stack(v) for k, v in traj.items()}


@torch.no_grad()
def gae(rewards, dones, values, last_values, gamma: float, lam: float):
    """Returns and the advantages normalized over the whole buffer:
    ``delta_t = r_t + gamma (1 - d_t) V_{t+1} - V_t``, ``A_t = delta_t +
    gamma lam (1 - d_t) A_{t+1}``, ``R_t = A_t + V_t``."""
    T = rewards.shape[0]
    nxt = torch.cat([values[1:], last_values[None]])
    keep = 1.0 - dones.to(values.dtype)
    adv = torch.zeros_like(values)
    a = torch.zeros_like(last_values)
    for t in reversed(range(T)):
        a = rewards[t] + gamma * keep[t] * nxt[t] - values[t] + gamma * lam * keep[t] * a
        adv[t] = a
    returns = adv + values
    return returns, (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)


class Learner(NamedTuple):
    lr: float
    opt: Adam
    adapt_opt: Adam


def update(ac, args, learner: Learner, traj: dict, returns, advantages, perm,
           steps: int | None = None):
    """``num_learning_epochs`` passes over the (T, N) samples in
    ``num_mini_batches`` minibatches of one permutation.  Each minibatch:
    the clipped surrogate, the clipped value loss and the entropy bonus;
    the learning rate stepped by the minibatch's KL; the gradient clipped
    to ``max_grad_norm`` and one Adam step; then one Adam step of the
    adaptation module on its loss over the first four fifths of the
    minibatch, against the privileged observation.  ``steps``: stop after
    that many minibatch steps.  Returns the learner, each step's loss
    (value loss plus surrogate loss) and the PPO optimizer's first moment
    after the first step."""
    params = dict(ac.named_parameters())
    flat = {k: traj[k].reshape((-1,) + traj[k].shape[2:]) for k in traj}
    flat["returns"], flat["advantages"] = returns.reshape(-1), advantages.reshape(-1)
    nm = args["num_mini_batches"]
    mb = flat["actions"].shape[0] // nm
    c = args["clip_param"]
    lr, opt, adapt_opt = learner
    losses, m1 = [], None
    order = [i for _ in range(args["num_learning_epochs"]) for i in range(nm)]
    for i in order[:steps]:
        b = {k: x[perm[i * mb:(i + 1) * mb]] for k, x in flat.items()}
        h = b["obs_history"].float()
        mean, std, value = policy(ac, b["obs"], b["privileged_obs"], h)
        ratio = torch.exp(log_prob(mean, std, b["actions"]) - b["log_prob"])
        A = b["advantages"]
        surrogate = torch.mean(torch.maximum(-A * ratio, -A * torch.clamp(ratio, 1 - c, 1 + c)))
        v_clip = b["values"] + torch.clamp(value - b["values"], -c, c)
        v_loss = torch.mean(torch.maximum((value - b["returns"]) ** 2,
                                          (v_clip - b["returns"]) ** 2))
        entropy = torch.sum(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std[0]))
        loss = surrogate + args["value_loss_coef"] * v_loss - args["entropy_coef"] * entropy
        g = grads_of(loss, params)
        with torch.no_grad():
            s1, s2 = b["sigma"], std
            kl = float(torch.mean(torch.sum(
                torch.log(s2 / s1 + 1e-5) + (s1 ** 2 + (b["mu"] - mean) ** 2) / (2 * s2 ** 2)
                - 0.5, dim=-1)))
        if kl > 2 * args["desired_kl"]:
            lr = max(lr / 1.5, args["min_adaptive_lr"])
        elif 0 < kl < args["desired_kl"] / 2:
            lr = min(lr * 1.5, args["max_adaptive_lr"])
        norm = math.sqrt(sum(float(torch.sum(x.double() ** 2)) for x in g.values()))
        scale = 1.0 if norm < args["max_grad_norm"] else args["max_grad_norm"] / norm
        opt = adam_step(params, {k: x * scale for k, x in g.items()}, opt, lr)
        n = h.shape[0] // 5 * 4
        for _ in range(args["num_adaptation_module_substeps"]):
            ad_loss = torch.mean((ac.adapt(h)[:n] - b["privileged_obs"][:n]) ** 2)
            adapt_opt = adam_step(params, grads_of(ad_loss, params), adapt_opt,
                                  args["adaptation_module_learning_rate"])
        losses.append(float(v_loss.detach() + surrogate.detach()))
        if m1 is None:
            m1 = {k: x.clone() for k, x in opt.m.items()}
    return Learner(lr, opt, adapt_opt), losses, m1


def supported(args: dict, ac_args: dict, cfg) -> None:
    """Raise where the configuration asks for what this learner or the plain
    policies leave out."""
    off = {"cheap_shuffle": args["cheap_shuffle"], "windowed_history": args["windowed_history"],
           "normalize_obs": ac_args["normalize_obs"],
           "use_decoder": ac_args.get("use_decoder", False),
           "critic_detach_encoder": ac_args.get("critic_detach_encoder", False),
           "num_eval_envs": int(getattr(cfg.env, "num_eval_envs", 0) or 0),
           "schedule!=adaptive": args["schedule"] != "adaptive",
           "clipped value loss off": not args["use_clipped_value_loss"]}
    on = [k for k, v in off.items() if v]
    if on:
        raise ValueError(f"the reference learner does not cover {on}")
