"""The program's builder and the driver of its first train steps, which
record what the check compares; and the small tree helpers the reference
(``reference/``) shares.  The program's classes come in as
:class:`Modules` (``program.py``), so nothing here imports the program."""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from . import manifest


class Modules(NamedTuple):
    """The classes and functions a build takes from the program."""
    Cfg: type
    config_go1: object
    envs: dict          # env_class name in a configuration file -> class
    policies: dict      # policy name in a configuration file -> (argument class, class)
    PPO: type
    PPOArgs: type
    Shard: type


class Train(NamedTuple):
    env: object
    alg: object
    ts: object
    state: object
    obs: dict


def build(mods: Modules, config: dict, num_envs: int, seed: int, device,
          rank_world: tuple[int, int] | None = None, overrides: dict | None = None,
          ppo_overrides: dict | None = None) -> Train:
    """The env, PPO and train state of ``config`` at ``num_envs`` envs (the
    global count; ``rank_world`` makes the env that rank's shard), from
    ``seed`` split as :func:`manifest.seeds` says and used as the port's
    Runner uses its seeds: the policy (:func:`policy`) drawn under the CPU
    generator seeded with ``init``, the env generator reseeded with ``env``
    before the reset with randomized episode lengths, then one
    observation."""
    s = manifest.seeds(seed)
    cfg = manifest.apply_config(mods.config_go1(mods.Cfg()), config, overrides)
    cfg.env.num_envs = num_envs
    cfg.seed = s.terrain
    env = mods.envs[config["env_class"]](cfg, device=device)
    if rank_world is not None and rank_world[1] > 1:
        env.set_shard(mods.Shard(rank_world[0], rank_world[1], num_envs))
    check_widths(env, config)
    ppo = mods.PPOArgs(**{**config["ppo"], **(ppo_overrides or {})})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(s.init)
        alg = mods.PPO(env, args=ppo, ac=policy(mods.policies, config, env), seed=s.act)
    ts = alg.init()
    env.generator.manual_seed(s.env)
    state = env.reset_fn(True)
    return Train(env, alg, ts, state, env.observe(state))


def policy(table: dict, config: dict, env):
    """The policy the configuration names (:func:`manifest.policy_name`),
    from ``table`` (name -> (argument class, policy class)), at the env's
    widths with the file's ``ac`` arguments, on the CPU; its weights come
    from torch's global generator."""
    name = manifest.policy_name(config)
    if name not in table:
        raise ValueError(f"configuration {config['name']}: no policy {name!r}; one of "
                         f"{sorted(table)}")
    args, cls = table[name]
    return cls(env.num_obs, env.num_privileged_obs, env.num_obs_history, env.num_actions,
               args(**config["ac"]))


def check_widths(env, config: dict):
    """Raise unless ``env`` has the policy widths the configuration states."""
    widths = {"num_obs": env.num_obs, "num_privileged_obs": env.num_privileged_obs,
              "history_frames": env.num_obs_history // env.num_obs,
              "num_actions": env.num_actions}
    if widths != config["widths"]:
        raise ValueError(f"configuration {config['name']}: the env's widths {widths} are not "
                         f"the file's {config['widths']}")


def tree_map(fn, x):
    """``fn`` on every tensor of ``x``: a tensor, or a NamedTuple, dict,
    list or tuple of them (None and other leaves kept)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def to_cpu(x):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), x)


def to_device(x, device):
    return tree_map(lambda t: t.to(device), x)


class _Recorder:
    """Wraps an env's ``step_fn`` for one rollout: before each step, the
    input state and the env generator's state; after it, the raw reward
    and time-outs; all on the CPU."""

    def __init__(self, env):
        self.env, self.step_fn, self.steps = env, env.step_fn, []

    def __call__(self, state, actions):
        gen = self.env.generator.get_state()
        new, out = self.step_fn(state, actions)
        self.steps.append(to_cpu({"state": state, "gen": gen, "rew": out.rew,
                                  "time_outs": out.info["time_outs"]}))
        return new, out


def first_steps(train: Train, steps: int, update_steps: int) -> tuple[Train, dict]:
    """Run ``steps`` train iterations through ``PPO.train_iteration``, the
    call the measured window makes (they warm up every shape), and keep on
    the CPU what the check compares of the first: each env step of its
    rollout (the input state, the env generator's state, the raw reward and
    time-outs, and the state after the last step), the trajectory as
    ``PPO.rollout`` returns it and the observation after the last step, the
    parameters before the update, and over its first ``update_steps``
    minibatch steps each step's loss (value loss plus surrogate loss), the
    PPO optimizer's first moment after the first step and the parameters
    after the last; and each iteration's learning rate and seconds.
    Returns the advanced train and those readings."""
    env, alg, ts, state, obs = train
    readings = {"theta0": to_cpu(ts.params), "learning_rate": [], "iteration_s": [],
                "loss": []}
    rollout, minibatch = alg.rollout, alg._minibatch_update

    def kept(*args, **kwargs):
        out = rollout(*args, **kwargs)
        if "traj" not in readings:
            readings.update(traj=to_cpu(out[2]._asdict()), last_obs=to_cpu(out[1]),
                            final_state=to_cpu(out[0]))
        return out

    def stepped(ts, *args, **kwargs):
        ts, stats = minibatch(ts, *args, **kwargs)
        k = len(readings["loss"])
        if k < update_steps:
            readings["loss"].append(float(stats[0] + stats[1]))
            if k == 0:
                readings["mu1"] = to_cpu(ts.opt_state.mu)
            if k == update_steps - 1:
                readings["theta_k"] = to_cpu(ts.params)
        return ts, stats

    recorder = _Recorder(env)
    alg.rollout, alg._minibatch_update, env.step_fn = kept, stepped, recorder
    try:
        for i in range(steps):
            t = time.perf_counter()
            ts, state, obs, m = alg.train_iteration(ts, state, obs)
            readings["learning_rate"].append(float(m["learning_rate"]))
            readings["iteration_s"].append(time.perf_counter() - t)
            if i == 0:
                del env.step_fn, alg._minibatch_update
                readings["steps"] = recorder.steps
    finally:
        del alg.rollout
        vars(alg).pop("_minibatch_update", None)
        vars(env).pop("step_fn", None)
    return Train(env, alg, ts, state, obs), readings
