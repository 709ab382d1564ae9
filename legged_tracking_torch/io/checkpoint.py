"""Policy export for deployment (port of ``io/checkpoint.py``).

``export_policy_npz`` writes the same flat ``.npz`` as the JAX package: the
flax layout of the parameters (``params/actor_body/Dense_0/kernel`` with
(in, out) kernels, ``params/std``) and ``__meta__/<key>`` entries, so that
the numpy runtime on the robot (``deploy/policy_runtime.py``) loads either
package's export.  Training checkpoints are written by ``learn/runner.py``.
"""

from __future__ import annotations

import numpy as np

# the MLP branches of ActorCriticCSE, under the same names in both packages
AC_BRANCHES = ("adaptation_module", "actor_body", "critic_body")


def state_dict_to_flax_params(sd) -> dict:
    """The flax layout of an ``ActorCriticCSE`` state dict (or of any dict
    under its names, such as Adam moments): ``{"params": {branch:
    {"Dense_i": {"kernel": (in, out), "bias"}}, "std"}}`` of float32 numpy
    arrays.  Torch ``Linear`` weights are (out, in), flax kernels (in, out)."""
    leaf = lambda t: t.detach().float().cpu().numpy()
    p = {"std": leaf(sd["std"])}
    for branch in AC_BRANCHES:
        n = sum(1 for k in sd if k.startswith(f"{branch}.layers.") and k.endswith(".weight"))
        p[branch] = {f"Dense_{i}": {"kernel": np.ascontiguousarray(
                                        leaf(sd[f"{branch}.layers.{i}.weight"]).T),
                                    "bias": leaf(sd[f"{branch}.layers.{i}.bias"])}
                     for i in range(n)}
    return {"params": p}


def export_policy_npz(path: str, state_dict, meta: dict | None = None):
    """Flat .npz of the ``ActorCriticCSE`` parameters in ``state_dict``
    (reference ppo_cse/__init__.py:286-298)."""
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
