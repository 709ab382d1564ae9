"""The comparison that decides ``correct``: the program's first train
iteration against the plain reference (``reference/train.py``), from the
same configuration file and seed.

The physics is chaotic: two sound solvers drift apart over a rollout by
their rounding alone.  So each env step is checked from the program's own
state before it (``reference.train.follow``), and the update runs on the
program's own trajectory.  The adaptive learning rate is not smooth: from
the second iteration on, a rounding-level difference in one minibatch's KL
can step it by 1.5, and the clipped objective's kinks turn rounding into
jumps as the two sides' parameters part over the minibatches.  So the
update is compared over the first minibatch steps of the first iteration
(PERF.md gives the readings).  Eight numbers, each with a limit in the
cell's file (``limits``):

- ``start``: the start, by itself: the initial parameters and the first
  observation (with kernel B1's height scan on the tunnel), the largest
  ``||x_prog - x_ref|| / ||x_ref||`` of its tensors;
- ``step``, ``env_off``, ``reset_off``: every env step of the first rollout
  (physics with contact, the actuator net, rewards, resets and
  terminations, observations with the height scan, the velocity task's
  curriculum).  An env's gap at a step is the largest over the floating
  fields of its next state and observation of its ``||p_e - r_e||`` over
  the larger of its own norm and the median env's, and of its reward gap
  over the rewards' root mean square; it is off above :data:`STEP_OFF`, or
  where an integer or boolean entry (episode length, contacts, done,
  time-out, curriculum bin) differs.  ``step`` is the largest over the
  steps of the median env's gap: what moves every env, such as a lower
  precision.  ``env_off`` is the most steps that one env is off: a fault in
  one env is off at every step.  ``reset_off`` counts the env steps off
  among those done on either side: resets and terminations.  No largest
  gap, because the soft contact's damping switches on with the contact and
  contact counts switch at a threshold: a sphere within rounding of the
  surface is in contact on one side only, and that env's step differs by
  tens of percent.  A sound rollout of 4,096 envs has some hundreds of such
  env steps, scattered one or two to an env;
- ``policy``: the action means and values the program's first rollout acted
  on, against the reference's policy on the same observations, the larger
  ``||x_prog - x_ref|| / ||x_ref||``;
- ``loss``: the first :data:`UPDATE_STEPS` minibatch steps of the first
  update, each step's loss (value loss plus surrogate loss), the largest
  ``|L_prog - L_ref| / |L_ref|``;
- ``grad``: the first gradient as the PPO optimizer holds it (its first
  moment after the first step, the clipped gradient times ``1 - b1``), by
  the worst leaf: ``| ||m_prog|| - ||m_ref|| |`` over the larger of
  ``||m_ref||`` and the median leaf's;
- ``change``: the parameters' change over those steps, ``||theta_k -
  theta_0||`` per leaf, by the worst leaf in the same way, over the leaves
  whose reference gradient is at least a thousandth of the median leaf's (a
  leaf with no gradient moves under Adam by round-off alone).
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("start", "step", "env_off", "reset_off", "policy", "loss", "grad", "change")
# the minibatch steps of the first update that are compared
UPDATE_STEPS = 3
# an env step whose gap (``step_gaps``) is above this is off
STEP_OFF = 1e-3
# leaves whose reference gradient is below this share of the median leaf's
# take no part in ``change``
QUIET_LEAF = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def rel(p: torch.Tensor, r: torch.Tensor) -> float:
    """``||p - r|| / ||r||`` (0 where both are 0)."""
    if p.shape != r.shape:
        raise ValueError(f"shape {tuple(p.shape)} against {tuple(r.shape)}")
    num, den = _norm(p.double() - r.double()), _norm(r)
    return _finite(num / den) if den else (0.0 if num == 0 else math.inf)


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _worst_leaf(prog: dict, ref: dict, keys) -> tuple[float, str]:
    med = _median([ref[k] for k in keys])
    worst, name = 0.0, ""
    for k in keys:
        gap = _finite(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
        if gap > worst or not name:
            worst, name = gap, k
    return worst, name


def _leaves(x, prefix=""):
    """(name, tensor) of every tensor in ``x`` (NamedTuples and dicts)."""
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k, v in zip(x._fields, x):
            yield from _leaves(v, f"{prefix}{k}.")


def per_env_gaps(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each env's ``||p_e - r_e||`` over the larger of ``||r_e||`` and the
    median env's (rows: the leading axis); inf where ``p_e`` is not finite."""
    if p.shape != r.shape:
        raise ValueError(f"shape {tuple(p.shape)} against {tuple(r.shape)}")
    p, r = p.double().reshape(p.shape[0], -1), r.double().reshape(r.shape[0], -1)
    d = torch.linalg.vector_norm(p - r, dim=1)
    n = torch.linalg.vector_norm(r, dim=1)
    gap = d / torch.clamp(torch.maximum(n, n.median()), min=1e-30)
    return torch.where(torch.isfinite(p).all(dim=1) & ~torch.isnan(gap), gap,
                       torch.full_like(gap, math.inf))


def step_gaps(prog: dict, ref: dict) -> dict:
    """One teacher-forced env step: ``prog`` and ``ref`` each hold the next
    ``state``, the observation dict ``obs``, the raw reward ``rew``, the
    ``done`` flags and ``time_outs``.  Returns each env's gap (``env``, on
    the CPU): the largest over the floating fields of
    :func:`per_env_gaps` (a field without an env axis counts for every env
    by its :func:`rel`) and of the reward gap over the rewards' root mean
    square, and inf where an integer or boolean entry of the env differs;
    the envs done on either side (``done``); and the field that set the
    largest gap (``field``)."""
    n = prog["rew"].shape[0]
    env = torch.zeros(n, dtype=torch.float64, device=prog["rew"].device)
    worst, field = -1.0, ""
    pairs = list(zip(_leaves(prog["state"], "state."), _leaves(ref["state"], "state.")))
    pairs += list(zip(_leaves(prog["obs"], "obs."), _leaves(ref["obs"], "obs.")))
    pairs += [(("rew", prog["rew"]), ("rew", ref["rew"])),
              (("done", prog["done"]), ("done", ref["done"])),
              (("time_outs", prog["time_outs"]), ("time_outs", ref["time_outs"]))]
    rms = float(ref["rew"].double().square().mean().sqrt())
    for (name, p), (name_r, r) in pairs:
        if name != name_r:
            raise ValueError(f"field {name} against {name_r}")
        per_env = p.ndim and p.shape[0] == n
        if not p.is_floating_point():
            off = (p != r).reshape(n, -1).any(dim=1) if per_env else (p != r).any()
            g = torch.where(off, math.inf, 0.0).to(env)
        elif name == "rew":
            g = (p.double() - r.double()).abs() / max(rms, 1e-30)
            g = torch.where(torch.isfinite(p), g, torch.full_like(g, math.inf))
        elif per_env:
            g = per_env_gaps(p, r)
        else:
            g = torch.tensor(rel(p, r), dtype=torch.float64, device=env.device)
        g = torch.nan_to_num(g.to(env).expand_as(env), nan=math.inf)
        top = float(g.max())
        if top > worst:
            worst, field = top, name
        env = torch.maximum(env, g)
    done = (prog["done"] | ref["done"]).cpu()
    return {"env": env.cpu(), "done": done, "field": field}


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers of the module docstring, with the worst leaves' names
    (``grad_leaf``, ``change_leaf``), the leaves ``change`` leaves out
    (``quiet_leaves``) and the spread of the env steps' gaps
    (``step_parts``: the largest, the count above
    each of five levels, the envs with a step off, the env steps done, the
    envs by their count of steps off, and the worst step's index and
    field)."""
    if len(prog["loss"]) != len(ref["loss"]) or set(prog["mu1"]) != set(ref["mu1"]):
        raise ValueError("the program and the reference ran different steps or leaves")
    traj = prog["traj"]
    start = max([rel(prog["theta0"][k], ref["theta0"][k]) for k in ref["theta0"]]
                + [rel(traj[k][0], ref["obs0"][k])
                   for k in ("obs", "privileged_obs", "obs_history")])
    env = torch.stack([s["env"] for s in ref["steps"]])          # (T, N)
    done = torch.stack([s["done"] for s in ref["steps"]])
    off = env > STEP_OFF
    step = float(env.median(dim=1).values.max())
    env_off = int(off.sum(dim=0).max())
    reset_off = int((off & done).sum())
    t_worst = int(env.max(dim=1).values.argmax())
    step_parts = {"max": float(env.max()),
                  "above": {f"{x:g}": int((env > x).sum()) for x in (1e-5, 1e-4, 1e-3, 1e-2,
                                                                      1e-1)},
                  "off_envs": int(off.any(dim=0).sum()), "done": int(done.sum()),
                  "envs_by_steps_off": torch.bincount(off.sum(dim=0), minlength=2)[1:].tolist(),
                  "worst": [t_worst, ref["steps"][t_worst]["field"]]}
    policy = max(rel(traj["mu"], ref["policy"]["mu"]),
                 rel(traj["values"], ref["policy"]["values"]))
    loss = max((_finite(abs(p - r) / abs(r)) if r else (0.0 if p == r else math.inf))
               for p, r in zip(prog["loss"], ref["loss"]))
    if not all(math.isfinite(p) for p in prog["loss"]):
        loss = math.inf
    norms = lambda d: {k: _norm(v) for k, v in d.items()}
    g_p, g_r = norms(prog["mu1"]), norms(ref["mu1"])
    grad, grad_leaf = _worst_leaf(g_p, g_r, list(g_r))
    med = _median(list(g_r.values()))
    moving = [k for k in g_r if g_r[k] >= QUIET_LEAF * med]
    d = lambda r: {k: r["theta_k"][k] - r["theta0"][k] for k in moving}
    change, change_leaf = _worst_leaf(norms(d(prog)), norms(d(ref)), moving)
    return {"start": start, "step": step, "env_off": env_off, "reset_off": reset_off,
            "policy": policy, "loss": loss, "grad": grad,
            "change": change, "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "quiet_leaves": [k for k in g_r if k not in moving], "step_parts": step_parts}


def verdict(g: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [[name, number, limit], ...]): correct when every number
    is at or under its limit (a NaN is over)."""
    rows = [[k, g[k], float(limits[k])] for k in NUMBERS]
    return all(v <= lim for _, v, lim in rows), rows
