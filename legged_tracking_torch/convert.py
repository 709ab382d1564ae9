"""Carry-over between the JAX package's values and the port's.

Every function here takes or returns numpy leaves, never JAX objects: the
caller turns a JAX pytree into numpy first (``jax.tree.map(np.asarray, x)``,
with PRNG keys left out) and back.

- flax ``ActorCriticCSE`` params -> the torch module's ``state_dict``;
- the actuator-net npz -> :class:`~.actuation.actuators.ActuatorNet`;
- ``EnvState`` / ``TerrainArrays`` numpy leaves -> the port's, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from .actuation.actuators import ActuatorNet, ActuatorState
from .envs.state import EnvState
from .physics.engine import PhysState
from .terrain.heightfield import TerrainArrays

_AC_BRANCHES = ("adaptation_module", "actor_body", "critic_body")


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


# ------------------------------------------------------------------ policy
def flax_params_to_state_dict(params) -> dict:
    """flax ``ActorCriticCSE`` params (nested dicts of numpy arrays, with or
    without the top-level "params" key) -> ``ActorCriticCSE.state_dict()``.
    Flax ``Dense`` kernels are (in, out); torch ``Linear`` weights (out, in)."""
    p = params.get("params", params)
    sd = {"std": torch.as_tensor(np.array(p["std"], np.float32))}
    for branch in _AC_BRANCHES:
        layers = p[branch]
        for i in range(len(layers)):
            dense = layers[f"Dense_{i}"]
            sd[f"{branch}.layers.{i}.weight"] = torch.as_tensor(
                np.array(np.asarray(dense["kernel"], np.float32).T, order="C"))
            sd[f"{branch}.layers.{i}.bias"] = torch.as_tensor(np.array(dense["bias"], np.float32))
    return sd


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
    """JAX ``EnvState`` numpy leaves -> the port's EnvState.  Fields the port
    has no use for (PRNG keys, velocity-task extensions) are ignored."""
    f = _fields(state)
    out = {}
    for name in EnvState._fields:
        if name == "phys":
            out[name] = PhysState(**{k: _tensor(v, device)
                                     for k, v in _fields(f[name]).items()})
        elif name == "act":
            out[name] = ActuatorState(**{k: _tensor(v, device)
                                         for k, v in _fields(f[name]).items()})
        else:
            out[name] = _tensor(f[name], device)
    out["obs_history"] = out["obs_history"].to(torch.bfloat16)
    return EnvState(**out)


def env_state_to_numpy(state: EnvState) -> dict:
    """The port's EnvState -> nested dict of numpy arrays under the JAX field
    names (phys and act as dicts); obs_history comes back as float32."""
    out = {}
    for name, v in state._asdict().items():
        if name in ("phys", "act"):
            out[name] = {k: _numpy(x) for k, x in v._asdict().items()}
        else:
            out[name] = _numpy(v)
    return out
