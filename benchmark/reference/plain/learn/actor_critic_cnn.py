"""The conv + GRU actor-critic (the walk-these-ways ``ppo_cse_cnn`` policy,
as ``legged_tracking_torch/learn/actor_critic_cnn.py`` defines it) in plain
PyTorch, float32, for the reference.

Each history frame is ``scalars ⊕ heights``, the heights a flat
channel-major ``(c, h, w)`` block.  The block is read as ``(h, w, c)``
rows-columns-channels (the JAX module's NHWC reshape of the flat block) and
embedded:

- MLP encoder: ``act(D1(act(D0(block))))``, widths 256 and ``E``;
- conv encoder: 3 x 3 convolutions with zero padding, ``c -> 16`` and
  ``16 -> 32``, each followed by ReLU and a 2 x 2 max-pool, the result
  flattened rows-columns-channels, then a dense layer to ``E``.

With the GRU, ``x_t = scalars_t ⊕ embedding_t`` runs through flax's cell
from ``h_0 = 0``:
``r = σ(W_ir x + b_ir + W_hr h)``, ``z = σ(W_iz x + b_iz + W_hz h)``,
``n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn))``, ``h' = (1 - z) ⊙ n + z ⊙ h``;
the latent is the last ``h``.  Without it the latent is the last frame's
``scalars ⊕ embedding``.  The heads read ``pin = scalars_last ⊕ latent``:
the adaptation module ``pin -> privileged obs``, the actor ``pin ⊕
adaptation -> action mean`` and the critic ``pin ⊕ privileged obs ->
value``, with the learned state-independent std.

Weights are drawn in the port's order under its parameter names, so the
same seed gives the same initial weights: lecun-normal dense and conv
kernels with zero biases, orthogonal ``W_hr``, ``W_hz``, ``W_hn`` (no bias
on the first two).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .actor_critic import _ACT, MLP, _lecun_normal_, clamp_std


@dataclass
class ACCnnArgs:
    init_noise_std: float = 1.0
    max_noise_std: float | None = None
    actor_hidden_dims: Sequence[int] = (512, 256, 128)
    critic_hidden_dims: Sequence[int] = (512, 256, 128)
    activation: str = "elu"
    adaptation_module_branch_hidden_dims: Sequence[int] = (256, 128)
    use_decoder: bool = False
    use_cnn: bool = False
    use_gru: bool = False
    height_map_shape: Sequence[int] = (2, 21, 11)
    cnn_num_embedding: int = 256
    gru_num_embedding: int = 256
    normalize_obs: bool = False
    critic_detach_encoder: bool = False


def _lecun_(weight: torch.Tensor, fan_in: int):
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


class Encoder(nn.Module):
    """The height block of each frame -> its embedding (module docstring)."""

    def __init__(self, shape, embedding: int, use_cnn: bool, activation: str):
        super().__init__()
        self.c, self.h, self.w = (int(v) for v in shape)
        self.use_cnn, self.E = use_cnn, embedding
        # each layer is made and then drawn, in this order, as the port does
        if use_cnn:
            for name, cin, cout in (("Conv_0", self.c, 16), ("Conv_1", 16, 32)):
                conv = nn.Conv2d(cin, cout, 3, padding=1)
                _lecun_(conv.weight, cin * 9)
                nn.init.zeros_(conv.bias)
                self.add_module(name, conv)
            dense = (("Dense_0", 32 * (self.h // 4) * (self.w // 4), embedding),)
        else:
            dense = (("Dense_0", self.c * self.h * self.w, 256), ("Dense_1", 256, embedding))
            self.act = _ACT[activation]
        for name, n_in, n_out in dense:
            layer = nn.Linear(n_in, n_out)
            _lecun_normal_(layer)
            self.add_module(name, layer)

    def forward(self, block):
        lead = block.shape[:-1]
        x = block.reshape(-1, self.h, self.w, self.c)          # rows, columns, channels
        if self.use_cnn:
            y = x.permute(0, 3, 1, 2)                            # to conv2d's (n, c, h, w)
            y = F.max_pool2d(torch.relu(self.Conv_0(y)), 2)
            y = F.max_pool2d(torch.relu(self.Conv_1(y)), 2)
            e = self.Dense_0(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1))
        else:
            e = self.act(self.Dense_1(self.act(self.Dense_0(x.reshape(x.shape[0], -1)))))
        return e.reshape(*lead, self.E)


class GRU(nn.Module):
    """flax's GRU cell, as its equations (module docstring)."""

    def __init__(self, n_in: int, n: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            layer = nn.Linear(n_in, n)
            _lecun_normal_(layer)
            self.add_module(name, layer)
        for name in ("hr", "hz", "hn"):
            layer = nn.Linear(n, n, bias=name == "hn")
            nn.init.orthogonal_(layer.weight)
            if layer.bias is not None:
                nn.init.zeros_(layer.bias)
            self.add_module(name, layer)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class ActorCriticCNN(nn.Module):
    def __init__(self, num_obs: int, num_privileged_obs: int, num_obs_history: int,
                 num_actions: int, args: ACCnnArgs | None = None):
        super().__init__()
        a = args or ACCnnArgs()
        self.args, self.num_obs = a, num_obs
        self.S = num_obs - math.prod(int(v) for v in a.height_map_shape)
        latent = a.gru_num_embedding if a.use_gru else self.S + a.cnn_num_embedding
        pin = self.S + latent
        self.height_map_encoder = Encoder(a.height_map_shape, a.cnn_num_embedding, a.use_cnn,
                                          a.activation)
        if a.use_gru:
            self.gru = GRU(self.S + a.cnn_num_embedding, a.gru_num_embedding)
        self.adaptation_module = MLP(pin, a.adaptation_module_branch_hidden_dims,
                                     num_privileged_obs, a.activation)
        self.actor_body = MLP(pin + num_privileged_obs, a.actor_hidden_dims, num_actions,
                              a.activation)
        self.critic_body = MLP(pin + num_privileged_obs, a.critic_hidden_dims, 1, a.activation)
        self.std = nn.Parameter(torch.full((num_actions,), float(a.init_noise_std)))

    def process_obs_history(self, obs_history):
        """(B, frames * num_obs) -> ``pin``, (B, S + latent)."""
        frames = obs_history.reshape(obs_history.shape[0], -1, self.num_obs)
        scalars = frames[..., :self.S]
        seq = torch.cat([scalars, self.height_map_encoder(frames[..., self.S:])], dim=-1)
        if self.args.use_gru:
            h = seq.new_zeros(seq.shape[0], self.args.gru_num_embedding)
            for t in range(seq.shape[1]):
                h = self.gru(h, seq[:, t])
        else:
            h = seq[:, -1]
        return torch.cat([scalars[:, -1], h], dim=-1)

    def adapt(self, obs_history):
        return self.adaptation_module(self.process_obs_history(obs_history))

    def action_dist(self, obs, privileged_obs, obs_history):
        pin = self.process_obs_history(obs_history)
        mean = self.actor_body(torch.cat([pin, self.adaptation_module(pin)], dim=-1))
        return mean, clamp_std(self.std, self.args)

    def evaluate(self, obs, privileged_obs, obs_history):
        pin = self.process_obs_history(obs_history)
        return self.critic_body(torch.cat([pin, privileged_obs], dim=-1))[..., 0]
