"""Policy runtime for on-robot inference: :class:`PolicyRuntime`, a
``torch.nn.Module`` on an explicit device, and :class:`NumpyPolicyRuntime`,
the JAX package's pure-numpy runtime (``_elu``, :class:`MLPParams`), which
needs no torch to run the same export.

The reference deploys TorchScript modules (adaptation_module_latest.jit +
body_latest.jit, ppo_cse/__init__.py:286-298) on the Go1's Jetson, which has
a CUDA GPU.  Here the policy is the flat ``policy.npz`` that either package's
Runner exports (``params/<branch>/Dense_<i>/{kernel,bias}``, kernels
(in, out)), loaded into two MLPs with ELU between layers and none after the
last: ``act_student`` of the CSE family, actions = actor(obs_history ⊕
adaptation(obs_history)).  A CNN/GRU export has no ``adaptation_module``
and is refused with ``KeyError``, as the reference refuses it.

The module runs on ``device`` (the card unless the caller asks for the
CPU), in float32 with TF32 off (the package turns it off at import).  At
its boundary it takes and returns numpy, so that ``DeploymentRunner`` and
``LCMAgent`` stay host code: one host-to-device copy of the obs history
and one device-to-host copy of the action a call.  On a CUDA device it runs
there or raises; it never moves itself to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _dense_layers(flat: dict, prefix: str) -> list:
    """flax Dense params 'prefix/Dense_i/{kernel,bias}' in order, as
    (kernel (in, out), bias) pairs."""
    layers = []
    i = 0
    while f"{prefix}/Dense_{i}/kernel" in flat:
        layers.append((flat[f"{prefix}/Dense_{i}/kernel"], flat[f"{prefix}/Dense_{i}/bias"]))
        i += 1
    if not layers:
        raise KeyError(f"no Dense layers under {prefix}; keys: {list(flat)[:8]}")
    return layers


def _collect_mlp(flat: dict, prefix: str) -> nn.Sequential:
    """The Dense layers under ``prefix`` as Linear layers with ELU between them."""
    layers = []
    for kernel, bias in _dense_layers(flat, prefix):
        kernel = np.asarray(kernel, np.float32)
        lin = nn.Linear(*kernel.shape)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
            lin.bias.copy_(torch.from_numpy(np.asarray(bias, np.float32)))
        layers += [lin, nn.ELU()]
    return nn.Sequential(*layers[:-1])


class PolicyRuntime(nn.Module):
    """act_student equivalent: actions = actor(obs_history ⊕ adaptation(obs_history))."""

    def __init__(self, npz_path: str, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"PolicyRuntime on {self.device}: torch sees no CUDA device "
                               f"(pass device='cpu' to run on the CPU)")
        flat = dict(np.load(npz_path))
        root = "params"
        self.adaptation = _collect_mlp(flat, f"{root}/adaptation_module")
        self.actor = _collect_mlp(flat, f"{root}/actor_body")
        self.to(self.device).requires_grad_(False)

    def act_student(self, obs_history: torch.Tensor) -> torch.Tensor:
        latent = self.adaptation(obs_history)
        return self.actor(torch.cat([obs_history, latent], dim=-1))

    @torch.no_grad()
    def forward(self, obs_history: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(obs_history, dtype=np.float32))
        return self.act_student(x.to(self.device)).cpu().numpy()


# --------------------------------------------------------- the numpy runtime
def _elu(x):
    return np.where(x > 0, x, np.expm1(x))


class MLPParams:
    """An MLP as numpy (kernel (in, out), bias) pairs, ELU between layers."""

    def __init__(self, layers):
        self.layers = layers

    def __call__(self, x, act=_elu):
        for i, (w, b) in enumerate(self.layers):
            x = x @ w + b
            if i < len(self.layers) - 1:
                x = act(x)
        return x


class NumpyPolicyRuntime:
    """act_student with numpy alone (the JAX package's ``PolicyRuntime``):
    the same ``policy.npz`` as :class:`PolicyRuntime`, no torch at inference."""

    def __init__(self, npz_path: str):
        flat = dict(np.load(npz_path))
        self.adaptation = MLPParams(_dense_layers(flat, "params/adaptation_module"))
        self.actor = MLPParams(_dense_layers(flat, "params/actor_body"))

    def __call__(self, obs_history: np.ndarray) -> np.ndarray:
        latent = self.adaptation(obs_history)
        return self.actor(np.concatenate([obs_history, latent], axis=-1))
