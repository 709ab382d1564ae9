"""The flax layout of the port's policies, and the policy export for
deployment (port of ``io/checkpoint.py``).

A policy's parameters cross between the packages, in checkpoints and in
``policy.npz``, under the flax tree names of the JAX modules:

- the MLP branches of the policies (``adaptation_module``, ``actor_body``,
  ``critic_body``, and the RMA policy's ``env_factor_encoder``): the port's
  ``<branch>.layers.<i>.weight`` (out, in) is ``<branch>/Dense_<i>/kernel``
  (in, out);
- every other submodule keeps its name, so ``ActorCriticCNN``'s
  ``height_map_encoder.Conv_0.weight`` (out, in, kh, kw) is
  ``height_map_encoder/Conv_0/kernel`` (kh, kw, in, out), and
  ``gru.ir.weight`` is ``gru/ir/kernel`` (in, out);
- ``std`` and the biases keep their shapes.

``export_policy_npz`` writes the same flat ``.npz`` as the JAX package
(``params/actor_body/Dense_0/kernel``, ``__meta__/<key>``), so the numpy
runtime on the robot (``deploy/policy_runtime.py``) loads either package's
export.  Training checkpoints are written by ``learn/runner.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..learn.optim import AdamState

# the MLP branches, under the same names in both packages and every policy
# (``env_factor_encoder``: the RMA policy's)
AC_BRANCHES = ("adaptation_module", "actor_body", "critic_body", "env_factor_encoder")


def state_dict_to_flax_params(sd) -> dict:
    """The flax tree of a policy's state dict (or of any dict under its
    names, such as Adam moments): ``{"params": {...}}`` of float32 numpy
    arrays."""
    tree = {}
    for name, t in sd.items():
        a = t.detach().float().cpu().numpy()
        path = name.split(".")
        if path[0] in AC_BRANCHES and path[1] == "layers":
            path = [path[0], f"Dense_{path[2]}", path[3]]
        if path[-1] == "weight":
            path[-1] = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": tree}


def flax_params_to_state_dict(params) -> dict:
    """A flax tree of policy parameters (nested dicts of numpy arrays, with
    or without the top-level "params" key) -> the port's state dict, as
    float32 CPU tensors."""
    sd = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + [k], v)
            return
        a = np.asarray(node, np.float32)
        if path[-1] == "kernel":
            path = path[:-1] + ["weight"]
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        if path[0] in AC_BRANCHES and path[1].startswith("Dense_"):
            path = [path[0], "layers", path[1][len("Dense_"):]] + path[2:]
        sd[".".join(path)] = torch.as_tensor(np.array(a, order="C"))

    walk([], params.get("params", params))
    return sd


def adam_to_checkpoint(state: AdamState) -> dict:
    """An Adam state as a checkpoint holds it: the count and both moments
    as flax trees."""
    return {"count": int(state.count), "mu": state_dict_to_flax_params(state.mu),
            "nu": state_dict_to_flax_params(state.nu)}


def _adam_node(state):
    """The node with count, mu and nu inside an optax chain's state (nested
    tuples of NamedTuples), as the JAX package's checkpoints hold it."""
    if hasattr(state, "_fields") and {"count", "mu", "nu"} <= set(state._fields):
        return state
    for child in (state if isinstance(state, tuple) else ()):
        found = _adam_node(child)
        if found is not None:
            return found
    return None


def adam_from_checkpoint(saved, device) -> AdamState:
    """:func:`adam_to_checkpoint`'s dict, or an optax chain state of numpy
    leaves (``clip_by_global_norm`` then ``inject_hyperparams(adam)``, or
    plain ``adam``) -> :class:`AdamState` on ``device``."""
    node = saved if isinstance(saved, dict) else _adam_node(saved)._asdict()
    moments = lambda tree: {k: v.to(device) for k, v in flax_params_to_state_dict(tree).items()}
    return AdamState(count=int(node["count"]), mu=moments(node["mu"]), nu=moments(node["nu"]))


def export_policy_npz(path: str, state_dict, meta: dict | None = None):
    """Flat .npz of the policy parameters in ``state_dict`` (reference
    ppo_cse/__init__.py:286-298)."""
    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(tree)

    walk("", state_dict_to_flax_params(state_dict))
    if meta:
        for k, v in meta.items():
            flat[f"__meta__/{k}"] = np.asarray(v)
    np.savez(path, **flat)
    return path
