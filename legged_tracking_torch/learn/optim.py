"""Adam and the global-norm clip in optax's arithmetic (counterpart of the
optax chains of ``learn/ppo.py``: ``clip_by_global_norm`` then
``inject_hyperparams(adam)`` for PPO, plain ``adam`` for the adaptation
module, ``clip_by_global_norm`` then ``adam`` for the critic warmup).

The state maps one to one onto optax's ``ScaleByAdamState``: a step count
and the first and second moments, one tensor per parameter, keyed by the
module's parameter names.  The operations run in optax's order, as
``torch._foreach_*`` calls over all parameters at once.  The learning rate
may be a float32 tensor on the device (the adaptive-KL rate), so that no
step waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    count: int          # steps taken (ScaleByAdamState.count)
    mu: dict            # name -> first moment
    nu: dict            # name -> second moment


def adam_init(params: dict) -> AdamState:
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
    return AdamState(count=0, mu=zeros(), nu=zeros())


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax ``clip_by_global_norm``: g while ||g|| < max_norm, else
    (g / ||g||) * max_norm.  (``torch.nn.utils.clip_grad_norm_`` divides
    by ||g|| + 1e-6 instead.)"""
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]


@torch.no_grad()
def adam_step(params: dict, grads: list, state: AdamState, lr, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8, injected: bool = False) -> AdamState:
    """One Adam step applied to ``params`` in place (``grads`` in the order
    of ``params``); returns the new state.

    ``injected``: the hyperparameters are float32 arrays, as
    ``inject_hyperparams`` stores them, so ``1 - b1`` is taken in float32;
    plain ``optax.adam`` takes it in double and rounds once.  The two
    differ in the last bits (0.100000024 against 0.1)."""
    f32 = np.float32
    if injected:
        c1, c2 = float(f32(1) - f32(b1)), float(f32(1) - f32(b2))
    else:
        c1, c2 = float(f32(1 - b1)), float(f32(1 - b2))
    count = state.count + 1
    bc1 = float(f32(1) - f32(b1) ** count)
    bc2 = float(f32(1) - f32(b2) ** count)
    p = list(params.values())
    # mu = (1 - b1) * g + b1 * mu ;  nu = (1 - b2) * g**2 + b2 * nu
    mu = torch._foreach_mul(grads, c1)
    torch._foreach_add_(mu, torch._foreach_mul([state.mu[k] for k in params], float(f32(b1))))
    nu = torch._foreach_mul(torch._foreach_mul(grads, grads), c2)
    torch._foreach_add_(nu, torch._foreach_mul([state.nu[k] for k in params], float(f32(b2))))
    # (mu / bc1) / (sqrt(nu / bc2) + eps) * -lr
    upd = torch._foreach_div(mu, bc1)
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, eps)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(p, upd)
    names = list(params)
    return AdamState(count=count, mu=dict(zip(names, mu)), nu=dict(zip(names, nu)))
