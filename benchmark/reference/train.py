"""The plain reference of a cell, and how it follows the program.

The reference is the env of ``plain/`` (its physics solved by the dense
rigid-body formulation, in float64) with the policy the configuration
names, from ``plain/learn`` (``POLICIES``), driven by :mod:`.learner`.  It
is built from the cell's configuration file and seed, and draws its own
terrain, weights and random numbers: it imports nothing of the program and
takes nothing the program made.

:func:`follow` checks the program's first train iteration against it:

1. the start, by itself: the initial weights and the first observation;
2. every env step of the first rollout, teacher-forced: from the program's
   env state before step t (and its env generator's state, so that resets
   draw the same numbers), the reference steps once with the program's
   actions, and its next state, observation, reward and done flags are held
   against the program's (``compare.step_gaps``).  Each step starts from
   the program's own state, because the physics is chaotic: two sound
   solvers drift apart over a rollout by their rounding alone;
3. the policy's action means and values on the program's observations;
4. GAE and the first minibatch steps of the update, run on the program's
   trajectory (its actions, its raw rewards, done flags and time-outs) with
   the reference's own policy outputs and its own minibatch permutation.

``tf32=True`` computes the reference one precision lower (the control):
TF32 matrix products and convolutions on the card (on the CPU, which has
no TF32, the policy's dense layers and convolutions on operands rounded to
TF32's 10-bit mantissa), and the physics solved in float32.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.nn import functional as F

from .. import build, compare, manifest
from . import learner
from .plain.physics import engine


class Ref(NamedTuple):
    env: object
    ac: torch.nn.Module
    gen: torch.Generator     # action noise and minibatch permutations
    state: object
    obs: dict
    args: dict               # the cell's PPO arguments


def _envs():
    from .plain.envs import LeggedEnv
    from .plain.envs.velocity_env import VelocityTrackingEnv
    return {"LeggedEnv": LeggedEnv, "VelocityTrackingEnv": VelocityTrackingEnv}


def build_ref(config: dict, num_envs: int, seed: int, device, overrides: dict | None = None,
              ppo_overrides: dict | None = None) -> Ref:
    """The reference's env, policy and generator from ``config`` and
    ``seed``, split into streams as :func:`benchmark.manifest.seeds` says
    and used as the program's build uses them (:func:`benchmark.build.build`)."""
    from .plain.config import Cfg, config_go1
    from .plain.learn import POLICIES

    device = torch.device(device)
    s = manifest.seeds(seed)
    cfg = manifest.apply_config(config_go1(Cfg()), config, overrides)
    cfg.env.num_envs = num_envs
    cfg.seed = s.terrain
    env = _envs()[config["env_class"]](cfg, device=device)
    build.check_widths(env, config)
    args = {**config["ppo"], **(ppo_overrides or {})}
    learner.supported(args, config["ac"], cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(s.init)
        ac = build.policy(POLICIES, config, env).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(s.act)
    env.generator.manual_seed(s.env)
    state = env.reset_fn(True)
    return Ref(env, ac, gen, state, env.observe(state), args)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (8 exponent bits, 10 mantissa bits), with the
    gradient passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


@contextlib.contextmanager
def precision(tf32: bool, ac: torch.nn.Module, device: torch.device):
    """float32 matrix products and convolutions and a float64 physics
    solve, or with ``tf32`` the control: TF32 products and convolutions and
    a float32 solve."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    solve = engine.SOLVE_DTYPE
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    engine.SOLVE_DTYPE = torch.float32 if tf32 else torch.float64
    emulated = []
    if tf32 and device.type != "cuda":
        for layer in ac.modules():
            if isinstance(layer, torch.nn.Linear):
                layer.forward = (lambda x, l=layer:
                                 F.linear(tf32_round(x), tf32_round(l.weight), l.bias))
            elif isinstance(layer, torch.nn.Conv2d):
                layer.forward = (lambda x, l=layer:
                                 F.conv2d(tf32_round(x), tf32_round(l.weight), l.bias, l.stride,
                                          l.padding, l.dilation, l.groups))
            else:
                continue
            emulated.append(layer)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        engine.SOLVE_DTYPE = solve
        for layer in emulated:
            del layer.forward


def _permutation(ref: Ref, num_envs: int) -> torch.Tensor:
    """The minibatch permutation of the first update, drawn from the
    generator after the rollout's T action noises, as the program draws
    it."""
    T, nm = ref.args["num_steps_per_env"], ref.args["num_mini_batches"]
    for _ in range(T):
        torch.randn((num_envs, ref.env.num_actions), generator=ref.gen, device=ref.env.device)
    mb = T * num_envs // nm
    return torch.randperm(nm * mb, generator=ref.gen, device=ref.env.device)


def drive(config: dict, num_envs: int, seed: int, device, overrides: dict | None = None,
          ppo_overrides: dict | None = None, tf32: bool = False) -> dict:
    """The reference in the program's place for the rollout and the first
    minibatch steps of the update (``compare.UPDATE_STEPS``), one precision
    lower with ``tf32`` (the control).  Returns readings in the form of
    :func:`benchmark.build.first_steps`'s."""
    device = torch.device(device)
    ref = build_ref(config, num_envs, seed, device, overrides, ppo_overrides)
    a, ac = ref.args, ref.ac
    params = dict(ac.named_parameters())
    out = {"theta0": build.to_cpu(params)}
    record = []
    with precision(tf32, ac, device):
        state, last, traj = learner.rollout(ref.env, ac, ref.gen, ref.state, ref.obs,
                                            a["num_steps_per_env"], a["gamma"], record)
        with torch.no_grad():
            last_v = ac.evaluate(last["obs"], last["privileged_obs"], last["obs_history"].float())
        returns, adv = learner.gae(traj["rewards"], traj["dones"], traj["values"], last_v,
                                   a["gamma"], a["lam"])
        perm = torch.randperm(traj["actions"].numel() // traj["actions"].shape[-1]
                              // a["num_mini_batches"] * a["num_mini_batches"],
                              generator=ref.gen, device=device)
        lrn, losses, m1 = learner.update(
            ac, a, learner.Learner(a["learning_rate"], learner.adam_init(params),
                                   learner.adam_init(params)), traj, returns, adv, perm,
            steps=compare.UPDATE_STEPS)
    out.update(traj=build.to_cpu(traj), last_obs=build.to_cpu(last),
               steps=[build.to_cpu(r) for r in record], final_state=build.to_cpu(state),
               loss=losses, mu1=build.to_cpu(m1), theta_k=build.to_cpu(params),
               learning_rate=[lrn.lr])
    return out


def follow(config: dict, num_envs: int, seed: int, device, prog: dict,
           overrides: dict | None = None, ppo_overrides: dict | None = None) -> dict:
    """The reference's readings against the program's ``prog`` (the
    readings of :func:`benchmark.build.first_steps`), in the precision the
    configuration states: the start, the teacher-forced steps' gaps
    (``step_gaps``, worked out here one step at a time), the policy on the
    program's observations, and the first minibatch steps of the update
    (``compare.UPDATE_STEPS``) on the program's trajectory."""
    device = torch.device(device)
    ref = build_ref(config, num_envs, seed, device, overrides, ppo_overrides)
    env, ac, a = ref.env, ref.ac, ref.args
    params = dict(ac.named_parameters())
    out = {"theta0": build.to_cpu(params), "obs0": build.to_cpu(ref.obs)}
    tr = {k: v.to(device) for k, v in prog["traj"].items()}
    last = {k: v.to(device) for k, v in prog["last_obs"].items()}
    T = tr["actions"].shape[0]
    if len(prog["steps"]) != T:
        raise ValueError(f"{len(prog['steps'])} recorded steps for a rollout of {T}")
    gaps = []
    with precision(False, ac, device):
        for t, rec in enumerate(prog["steps"]):
            env.generator.set_state(rec["gen"])
            new, o = env.step_fn(build.to_device(rec["state"], device), tr["actions"][t])
            nxt = prog["steps"][t + 1]["state"] if t + 1 < T else prog["final_state"]
            p_obs = ({k: tr[k][t + 1] for k in ("obs", "privileged_obs", "obs_history")}
                     if t + 1 < T else last)
            gaps.append(compare.step_gaps(
                {"state": build.to_device(nxt, device), "obs": p_obs,
                 "rew": rec["rew"].to(device), "done": tr["dones"][t],
                 "time_outs": rec["time_outs"].to(device)},
                {"state": new, "obs": {"obs": o.obs, "privileged_obs": o.privileged_obs,
                                       "obs_history": o.obs_history},
                 "rew": o.rew, "done": o.done, "time_outs": o.info["time_outs"]}))
            del new, o
        out["steps"] = gaps

        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        with torch.no_grad():
            mean, std, value = learner.policy(ac, flat(tr["obs"]), flat(tr["privileged_obs"]),
                                              flat(tr["obs_history"]).float())
            shaped = lambda x: x.reshape(tr["actions"].shape[:2] + x.shape[1:])
            mean, std, value = shaped(mean), shaped(std), shaped(value)
            last_v = ac.evaluate(last["obs"], last["privileged_obs"], last["obs_history"].float())
        out["policy"] = {"mu": mean.to("cpu"), "values": value.to("cpu")}
        rec_rew = torch.stack([r["rew"] for r in prog["steps"]]).to(device)
        rec_to = torch.stack([r["time_outs"] for r in prog["steps"]]).to(device)
        traj = {**tr, "values": value, "mu": mean, "sigma": std,
                "log_prob": learner.log_prob(mean, std, tr["actions"]),
                "rewards": rec_rew + a["gamma"] * value * rec_to}
        returns, adv = learner.gae(traj["rewards"], tr["dones"], value, last_v,
                                   a["gamma"], a["lam"])
        lrn, losses, m1 = learner.update(
            ac, a, learner.Learner(a["learning_rate"], learner.adam_init(params),
                                   learner.adam_init(params)),
            traj, returns, adv, _permutation(ref, tr["actions"].shape[1]),
            steps=compare.UPDATE_STEPS)
    out.update(loss=losses, mu1=build.to_cpu(m1), theta_k=build.to_cpu(params),
               learning_rate=[lrn.lr])
    return out
