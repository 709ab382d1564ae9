"""Carry-over between the JAX package's values and the port's.

Every function here takes or returns numpy leaves, never JAX objects: the
caller turns a JAX pytree into numpy first (``jax.tree.map(np.asarray, x)``,
with PRNG keys left out) and back.

- flax ``ActorCriticCSE`` and ``ActorCriticCNN`` params -> the torch
  module's ``state_dict``, and back (both ways are the checkpoints' and the
  export's, :mod:`.io.checkpoint`, re-exported here);
- optax Adam states (the PPO chain and the plain Adam) -> the port's
  :class:`~.learn.optim.AdamState`, and back; a whole ``TrainState`` both
  ways;
- the actuator-net npz -> :class:`~.actuation.actuators.ActuatorNet`;
- ``EnvState`` / ``TerrainArrays`` numpy leaves -> the port's, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from .actuation.actuators import ActuatorNet, ActuatorState
from .envs.state import EnvState
from .io.checkpoint import (adam_from_checkpoint, flax_params_to_state_dict,
                            state_dict_to_flax_params)
from .learn.optim import AdamState
from .learn.ppo import TrainState
from .learn.utils import RunningMeanStd
from .physics.engine import PhysState
from .terrain.heightfield import TerrainArrays


def _fields(obj) -> dict:
    """Field dict of a NamedTuple or a mapping."""
    return dict(obj._asdict()) if hasattr(obj, "_asdict") else dict(obj)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # numpy holds bf16 only as an extension type
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, order="C"), device=device)   # a writable copy


def _numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 comes back as float32 (exact: bf16 values are float32 values)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# --------------------------------------------------------------- optimizer
# an optax Adam state as numpy leaves -> AdamState: io.checkpoint's
# adam_from_checkpoint, which reads the JAX package's checkpoints too
def adam_state_to_optax(state: AdamState, like, learning_rate=None):
    """:class:`AdamState` -> ``like`` (the same optax state as numpy leaves)
    with its count and moments replaced; an ``inject_hyperparams`` node gets
    the same count and, when given, ``learning_rate``."""
    fields = set(getattr(like, "_fields", ()))
    count = lambda: np.asarray(state.count, np.asarray(like.count).dtype)
    if {"count", "mu", "nu"} <= fields:
        return like._replace(count=count(), mu=state_dict_to_flax_params(state.mu),
                             nu=state_dict_to_flax_params(state.nu))
    if "inner_state" in fields:
        hyper = dict(like.hyperparams)
        if learning_rate is not None:
            hyper["learning_rate"] = np.asarray(learning_rate, np.float32)
        return like._replace(count=count(), hyperparams=hyper,
                             inner_state=adam_state_to_optax(state, like.inner_state,
                                                             learning_rate))
    if type(like) is tuple:         # a chain's state
        return tuple(adam_state_to_optax(state, c, learning_rate) for c in like)
    return like                     # a stateless node (optax EmptyState)


def train_state_from_numpy(ts, ppo, device="cuda") -> TrainState:
    """A JAX ``TrainState`` as numpy leaves -> the port's.  Its parameters
    are loaded into ``ppo.ac``, whose parameters the returned state holds."""
    ppo.ac.load_state_dict(flax_params_to_state_dict(ts.params))
    rms = None
    if ts.obs_rms is not None:
        rms = RunningMeanStd(*(torch.as_tensor(np.array(x, np.float32), device=device)
                               for x in (ts.obs_rms.mean, ts.obs_rms.var, ts.obs_rms.count)))
    return TrainState(
        params=dict(ppo.ac.named_parameters()),
        opt_state=adam_from_checkpoint(ts.opt_state, device),
        adapt_opt_state=adam_from_checkpoint(ts.adapt_opt_state, device),
        learning_rate=torch.tensor(np.float32(ts.learning_rate), device=device),
        iteration=int(ts.iteration), obs_rms=rms)


def train_state_to_numpy(ts: TrainState, like):
    """The port's ``TrainState`` -> ``like`` (a JAX ``TrainState`` as numpy
    leaves) with every field replaced by the port's values."""
    lr = np.float32(ts.learning_rate.item())
    out = like._replace(
        params=state_dict_to_flax_params(ts.params),
        opt_state=adam_state_to_optax(ts.opt_state, like.opt_state, lr),
        adapt_opt_state=adam_state_to_optax(ts.adapt_opt_state, like.adapt_opt_state),
        learning_rate=lr, iteration=np.int32(ts.iteration))
    if ts.obs_rms is not None:
        out = out._replace(obs_rms=like.obs_rms._replace(
            **{k: _numpy(v) for k, v in ts.obs_rms._asdict().items()}))
    return out


# --------------------------------------------------------------- actuators
def actuator_net_from_npz(path: str, device="cuda") -> ActuatorNet:
    """The actuator-net npz (w0, b0, w1, b1, w2, b2) -> module."""
    d = np.load(path)
    return ActuatorNet.from_arrays({k: d[k] for k in ("w0", "b0", "w1", "b1", "w2", "b2")},
                                   device=device)


# ----------------------------------------------------------------- terrain
def terrain_from_numpy(terrain, device="cuda") -> TerrainArrays:
    f = _fields(terrain)
    return TerrainArrays(
        tiles=_tensor(f["tiles"], device).float(),
        env_tile=_tensor(f["env_tile"], device).to(torch.int32),
        env_origin=_tensor(f["env_origin"], device).float(),
        env_terrain_origin=_tensor(f["env_terrain_origin"], device).float(),
        horizontal_scale=float(f["horizontal_scale"]),
        is_plane=bool(f["is_plane"]),
        ceiling_top=float(f.get("ceiling_top", 1e3)),
    )


def terrain_to_numpy(terrain: TerrainArrays) -> dict:
    return {k: (_numpy(v) if torch.is_tensor(v) else v) for k, v in terrain._asdict().items()}


# --------------------------------------------------------------- env state
def env_state_from_numpy(state, device="cuda") -> EnvState:
    """JAX ``EnvState`` numpy leaves -> the port's EnvState.  The PRNG keys
    are ignored; a task's optional fields (the velocity task's, the
    planner's scan) come across when they are set, and stay None when not."""
    f = _fields(state)
    out = {}
    for name in EnvState._fields:
        if name == "phys":
            out[name] = PhysState(**{k: _tensor(v, device)
                                     for k, v in _fields(f[name]).items()})
        elif name == "act":
            out[name] = ActuatorState(**{k: _tensor(v, device)
                                         for k, v in _fields(f[name]).items()})
        elif f.get(name) is None and name in EnvState._field_defaults:
            out[name] = None            # a field of another task
        else:
            out[name] = _tensor(f[name], device)
    out["obs_history"] = out["obs_history"].to(torch.bfloat16)
    return EnvState(**out)


def env_state_to_numpy(state: EnvState) -> dict:
    """The port's EnvState -> nested dict of numpy arrays under the JAX field
    names (phys and act as dicts); obs_history comes back as float32.  A
    field that is None (another task's, or measured_heights without the
    planner) is left out."""
    out = {}
    for name, v in state._asdict().items():
        if v is None:
            continue
        if name in ("phys", "act"):
            out[name] = {k: _numpy(x) for k, x in v._asdict().items()}
        else:
            out[name] = _numpy(v)
    return out
