"""Actor-critic with concurrent state estimation (CSE), port of
``learn/actor_critic.py`` (the flax module) as an ``nn.Module``.

- ``adaptation_module``: MLP(obs_history) -> predicted privileged obs
- ``actor_body``: MLP(obs_history ⊕ latent) -> action mean
- ``critic_body``: MLP(obs_history ⊕ true privileged obs) -> value
- learned state-independent ``std`` (init 1.0)

Widths match AC_Args defaults ([512,256,128] actor/critic, [256,128]
adaptation, ELU).  The policy runs in float32: the JAX package's bf16 policy
matmuls are a TPU default, not a semantic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

_ACT = {
    "elu": nn.functional.elu, "relu": nn.functional.relu, "selu": nn.functional.selu,
    "crelu": nn.functional.relu, "lrelu": nn.functional.leaky_relu,
    "tanh": torch.tanh, "sigmoid": torch.sigmoid,
}


@dataclass
class ACArgs:
    """AC_Args parity (ppo_cse/actor_critic.py:10-20)."""
    init_noise_std: float = 1.0
    # optional exploration-noise ceiling (a deliberate divergence of the JAX
    # package from the reference); None preserves reference semantics
    max_noise_std: float | None = None
    actor_hidden_dims: Sequence[int] = (512, 256, 128)
    critic_hidden_dims: Sequence[int] = (512, 256, 128)
    activation: str = "elu"
    adaptation_module_branch_hidden_dims: Sequence[int] = (256, 128)
    normalize_obs: bool = False


def _lecun_normal_(linear: nn.Linear):
    """flax ``Dense`` initialisation: truncated-normal lecun kernel, zero bias."""
    std = math.sqrt(1.0 / linear.in_features) / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, std=std, a=-2.0 * std, b=2.0 * std)
    nn.init.zeros_(linear.bias)


class MLP(nn.Module):
    """Dense layers of ``hidden`` widths with ``activation``, then a linear
    output layer; ``layers[i]`` is flax's ``Dense_i``."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int, activation: str = "elu"):
        super().__init__()
        dims = [in_dim, *hidden, out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        for layer in self.layers:
            _lecun_normal_(layer)
        self.act = _ACT[activation]

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.layers[-1](x)


class ActorCriticCSE(nn.Module):
    def __init__(self, num_obs: int, num_privileged_obs: int, num_obs_history: int,
                 num_actions: int, args: ACArgs | None = None):
        super().__init__()
        a = args or ACArgs()
        self.args = a
        self.adaptation_module = MLP(num_obs_history, a.adaptation_module_branch_hidden_dims,
                                     num_privileged_obs, a.activation)
        self.actor_body = MLP(num_obs_history + num_privileged_obs, a.actor_hidden_dims,
                              num_actions, a.activation)
        self.critic_body = MLP(num_obs_history + num_privileged_obs, a.critic_hidden_dims,
                               1, a.activation)
        self.std = nn.Parameter(torch.full((num_actions,), float(a.init_noise_std)))

    def adapt(self, obs_history):
        return self.adaptation_module(obs_history)

    def adaptation_target(self, privileged_obs):
        """CSE supervises the privileged obs itself (ppo.py:164-185)."""
        return privileged_obs

    def action_dist(self, obs, privileged_obs, obs_history):
        """Student distribution (update_distribution, :121-124); obs and
        privileged_obs are unused (protocol shared with the RMA variant)."""
        latent = self.adaptation_module(obs_history)
        mean = self.actor_body(torch.cat([obs_history, latent], dim=-1))
        return mean, clamp_std(self.std, self.args)

    def action_dist_and_value(self, obs, privileged_obs, obs_history):
        """``action_dist`` then ``evaluate``: the heads share no pass."""
        return (*self.action_dist(obs, privileged_obs, obs_history),
                self.evaluate(obs, privileged_obs, obs_history))

    def act_student(self, obs, obs_history):
        """Deterministic deployment policy (act_student, :144-148)."""
        latent = self.adaptation_module(obs_history)
        return self.actor_body(torch.cat([obs_history, latent], dim=-1))

    def act_teacher(self, obs, privileged_obs, obs_history):
        return self.actor_body(torch.cat([obs_history, privileged_obs], dim=-1))

    def evaluate(self, obs, privileged_obs, obs_history):
        v = self.critic_body(torch.cat([obs_history, privileged_obs], dim=-1))
        return v[..., 0]


def clamp_std(std, args):
    """Floor (numerics) and optional ceiling (ACArgs.max_noise_std) for the
    learned state-independent exploration std.  ``maximum``/``minimum``, as
    in the JAX package, and not ``clamp``: at a tie (the initial std of 1.0
    under a ceiling of 1.0) they pass half the gradient, ``clamp`` all of it.
    The bounds are filled on the device (``full_like``): a tensor made from
    a host scalar is a copy the host waits for."""
    s = torch.abs(std)
    s = torch.maximum(s, torch.full_like(s, 1e-3))
    if getattr(args, "max_noise_std", None) is not None:
        s = torch.minimum(s, torch.full_like(s, args.max_noise_std))
    return s


def normal_log_prob(mean, std, actions):
    var = std * std
    return torch.sum(-0.5 * torch.square(actions - mean) / var
                     - torch.log(std) - 0.5 * math.log(2.0 * math.pi), dim=-1)


def normal_entropy(std):
    return torch.sum(0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(std), dim=-1)


def normal_kl(mu1, sigma1, mu2, sigma2):
    """The reference's KL(N1||N2) for the adaptive learning rate
    (ppo_cse/ppo.py:112-117), ``+ 1e-5`` inside the log included."""
    return torch.sum(
        torch.log(sigma2 / sigma1 + 1e-5)
        + (torch.square(sigma1) + torch.square(mu1 - mu2)) / (2.0 * torch.square(sigma2))
        - 0.5, dim=-1)
