"""CNN/GRU actor-critic over height-scan observations (port of
``learn/actor_critic_cnn.py``, the ppo_cse_cnn variant).

A ``HeightMapEncoder`` (an MLP by default, or conv 16 -> 32 with 2x2 max
pooling and a linear layer; the convs' weight gradients come from kernel
W1, :mod:`.conv3x3`) embeds the height block of each history frame;
an optional GRU runs over the (scalars ⊕ embedding) frames; the policy reads
the last frame's scalars ⊕ the last latent.  The adaptation, actor and critic
heads then match the CSE variant.

Two layouts follow the JAX package exactly, since its weights and
checkpoints cross over:

- the encoder reads the flat, channel-major ``(2, nx, ny)`` height block as
  ``(nx, ny, 2)`` rows-columns-channels (the JAX module's NHWC reshape), and
  the conv output is flattened in that order too;
- the GRU cell is flax's: biased input projections ``ir``/``iz``/``in``,
  unbiased ``hr``/``hz`` and a biased ``hn``.

Submodules carry the flax names (``height_map_encoder.Conv_0``,
``gru.ir``, ...) so that :mod:`..io.checkpoint` maps them by name.

Under the profiler, each call of :meth:`ActorCriticCNN.process_obs_history`
records two spans of the port's tracer (:mod:`..tracing`):
``policy.encoder`` around the height encoder (counter ``frames``: the B x H
frames it embeds) and, with the GRU, ``policy.gru`` around the recurrence
(counters ``steps``, H, and ``rows``, B).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
from torch import nn

from .. import tracing
from .actor_critic import _ACT, MLP, _lecun_normal_, clamp_std
from .conv3x3 import conv3x3


@dataclass
class ACCnnArgs:
    """The JAX package's ACCnnArgs."""
    init_noise_std: float = 1.0
    max_noise_std: float | None = None
    actor_hidden_dims: Sequence[int] = (512, 256, 128)
    critic_hidden_dims: Sequence[int] = (512, 256, 128)
    activation: str = "elu"
    adaptation_module_branch_hidden_dims: Sequence[int] = (256, 128)
    use_decoder: bool = False
    use_cnn: bool = False
    use_gru: bool = False
    height_map_shape: Tuple[int, int, int] = (2, 21, 11)
    cnn_num_embedding: int = 256
    gru_num_embedding: int = 256
    normalize_obs: bool = False
    # stop the value gradient at the shared height-map encoder (off by
    # default, the reference's semantics)
    critic_detach_encoder: bool = False


def _conv(cin: int, cout: int) -> nn.Conv2d:
    """flax ``Conv(cout, (3, 3), padding="SAME")``: lecun-normal kernel,
    zero bias."""
    conv = nn.Conv2d(cin, cout, 3, padding=1)
    std = math.sqrt(1.0 / (cin * 9)) / 0.87962566103423978
    nn.init.trunc_normal_(conv.weight, std=std, a=-2.0 * std, b=2.0 * std)
    nn.init.zeros_(conv.bias)
    return conv


def _linear(cin: int, cout: int, bias: bool = True, orthogonal: bool = False) -> nn.Linear:
    layer = nn.Linear(cin, cout, bias=bias)
    if orthogonal:
        nn.init.orthogonal_(layer.weight)
        if bias:
            nn.init.zeros_(layer.bias)
    elif bias:
        _lecun_normal_(layer)
    else:
        std = math.sqrt(1.0 / cin) / 0.87962566103423978
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std)
    return layer


class HeightMapEncoder(nn.Module):
    def __init__(self, height_map_shape, num_embedding: int = 128, use_cnn: bool = False,
                 activation: str = "elu"):
        super().__init__()
        self.shape = tuple(int(v) for v in height_map_shape)
        self.num_embedding = num_embedding
        self.use_cnn = use_cnn
        c, h, w = self.shape
        if use_cnn:
            self.Conv_0 = _conv(c, 16)
            self.Conv_1 = _conv(16, 32)
            self.Dense_0 = _linear(32 * (h // 2 // 2) * (w // 2 // 2), num_embedding)
        else:
            self.Dense_0 = _linear(c * h * w, 256)
            self.Dense_1 = _linear(256, num_embedding)
            self.act = _ACT[activation]

    def forward(self, x):
        lead = x.shape[:-1]
        c, h, w = self.shape
        if self.use_cnn:
            # the JAX module's NHWC reading of the channel-major block
            x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
            for conv in (self.Conv_0, self.Conv_1):
                x = nn.functional.max_pool2d(torch.relu(conv3x3(x, conv.weight, conv.bias)), 2, 2)
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # flattened as HWC
            x = self.Dense_0(x)
        else:
            x = x.reshape(-1, c * h * w)
            x = self.act(self.Dense_0(x))
            x = self.act(self.Dense_1(x))
        return x.reshape(lead + (self.num_embedding,))


class GRUCell(nn.Module):
    """flax's ``GRUCell``: r = σ(ir(x) + hr(h)), z = σ(iz(x) + hz(h)),
    n = tanh(in(x) + r ⊙ hn(h)), h' = (1 - z) ⊙ n + z ⊙ h."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for g in ("ir", "iz", "in"):
            self.add_module(g, _linear(in_features, features))
        for g in ("hr", "hz"):
            self.add_module(g, _linear(features, features, bias=False, orthogonal=True))
        self.add_module("hn", _linear(features, features, orthogonal=True))

    def forward(self, h, x):
        g = lambda name: getattr(self, name)
        r = torch.sigmoid(g("ir")(x) + g("hr")(h))
        z = torch.sigmoid(g("iz")(x) + g("hz")(h))
        n = torch.tanh(g("in")(x) + r * g("hn")(h))
        return (1.0 - z) * n + z * h


class ActorCriticCNN(nn.Module):
    def __init__(self, num_obs: int, num_privileged_obs: int, num_obs_history: int,
                 num_actions: int, args: ACCnnArgs | None = None):
        super().__init__()
        a = args or ACCnnArgs()
        self.args = a
        self.num_obs = num_obs
        self.scalar_size = num_obs - int(math.prod(a.height_map_shape))
        gru_input_dim = self.scalar_size + a.cnn_num_embedding
        gru_dim = a.gru_num_embedding if a.use_gru else gru_input_dim
        policy_input_dim = self.scalar_size + gru_dim
        self.height_map_encoder = HeightMapEncoder(a.height_map_shape, a.cnn_num_embedding,
                                                   a.use_cnn, a.activation)
        if a.use_gru:
            self.gru = GRUCell(gru_input_dim, a.gru_num_embedding)
        self.adaptation_module = MLP(policy_input_dim, a.adaptation_module_branch_hidden_dims,
                                     num_privileged_obs, a.activation)
        self.actor_body = MLP(policy_input_dim + num_privileged_obs, a.actor_hidden_dims,
                              num_actions, a.activation)
        self.critic_body = MLP(policy_input_dim + num_privileged_obs, a.critic_hidden_dims,
                               1, a.activation)
        self.std = nn.Parameter(torch.full((num_actions,), float(a.init_noise_std)))

    def process_obs_history(self, obs_history):
        """(B, H * num_obs) -> (B, policy_input_dim) (reference :179-198)."""
        B = obs_history.shape[0]
        frames = obs_history.reshape(B, -1, self.num_obs)
        H = frames.shape[1]
        scalars = frames[:, :, :self.scalar_size]
        with tracing.span("policy.encoder") as span:
            span.add("frames", B * H)
            emb = self.height_map_encoder(frames[:, :, self.scalar_size:])     # (B, H, E)
        seq = torch.cat([scalars, emb], dim=-1)
        if self.args.use_gru:
            with tracing.span("policy.gru") as span:
                span.add("steps", H)
                span.add("rows", B)
                latent = torch.zeros(B, self.args.gru_num_embedding, dtype=seq.dtype,
                                     device=seq.device)
                for t in range(H):
                    latent = self.gru(latent, seq[:, t])
        else:
            latent = seq[:, -1]
        return torch.cat([scalars[:, -1], latent], dim=-1)

    def adapt(self, obs_history):
        return self.adaptation_module(self.process_obs_history(obs_history))

    def adaptation_target(self, privileged_obs):
        return privileged_obs

    def action_dist(self, obs, privileged_obs, obs_history):
        pin = self.process_obs_history(obs_history)
        latent = self.adaptation_module(pin)
        mean = self.actor_body(torch.cat([pin, latent], dim=-1))
        return mean, clamp_std(self.std, self.args)

    def act_student(self, obs, obs_history):
        pin = self.process_obs_history(obs_history)
        latent = self.adaptation_module(pin)
        return self.actor_body(torch.cat([pin, latent], dim=-1))

    def act_teacher(self, obs, privileged_obs, obs_history):
        pin = self.process_obs_history(obs_history)
        return self.actor_body(torch.cat([pin, privileged_obs], dim=-1))

    def evaluate(self, obs, privileged_obs, obs_history):
        pin = self.process_obs_history(obs_history)
        if self.args.critic_detach_encoder:
            pin = pin.detach()
        v = self.critic_body(torch.cat([pin, privileged_obs], dim=-1))
        return v[..., 0]
