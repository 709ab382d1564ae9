"""The original RMA / walk-these-ways teacher-student actor-critic, port of
``learn/actor_critic_rma.py`` (the flax module) as an ``nn.Module``.

An ``env_factor_encoder`` maps the privileged obs to a latent (reference
go1_gym_learn/ppo/actor_critic.py:42-60), the ``adaptation_module`` maps the
obs history to the same latent space (:63-78), and actor and critic read
``obs ⊕ latent`` (:82-104, update_distribution :145-149).  Training drives
the actor with the TEACHER latent (the encoder of the true privileged obs);
the adaptation module regresses onto the teacher latent, without its
gradient (``adaptation_target``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from .actor_critic import MLP, clamp_std


@dataclass
class ACRmaArgs:
    """AC_Args parity (ppo/actor_critic.py:10-28)."""
    init_noise_std: float = 1.0
    max_noise_std: float | None = None   # see ACArgs.max_noise_std
    actor_hidden_dims: Sequence[int] = (512, 256, 128)
    critic_hidden_dims: Sequence[int] = (512, 256, 128)
    activation: str = "elu"
    env_factor_encoder_branch_hidden_dims: Sequence[int] = (256, 128)
    env_factor_encoder_latent_dim: int = 18
    adaptation_module_branch_hidden_dims: Sequence[int] = (256, 32)


class ActorCriticRMA(nn.Module):
    def __init__(self, num_obs: int, num_privileged_obs: int, num_obs_history: int,
                 num_actions: int, args: ACRmaArgs | None = None):
        super().__init__()
        a = args or ACRmaArgs()
        self.args = a
        latent = a.env_factor_encoder_latent_dim
        self.env_factor_encoder = MLP(num_privileged_obs, a.env_factor_encoder_branch_hidden_dims,
                                      latent, a.activation)
        self.adaptation_module = MLP(num_obs_history, a.adaptation_module_branch_hidden_dims,
                                     latent, a.activation)
        self.actor_body = MLP(num_obs + latent, a.actor_hidden_dims, num_actions, a.activation)
        self.critic_body = MLP(num_obs + latent, a.critic_hidden_dims, 1, a.activation)
        self.std = nn.Parameter(torch.full((num_actions,), float(a.init_noise_std)))

    def adapt(self, obs_history):
        return self.adaptation_module(obs_history)

    def adaptation_target(self, privileged_obs):
        return self.env_factor_encoder(privileged_obs)

    def action_dist(self, obs, privileged_obs, obs_history):
        """Teacher distribution (update_distribution, ppo/actor_critic.py:145-149)."""
        latent = self.env_factor_encoder(privileged_obs)
        mean = self.actor_body(torch.cat([obs, latent], dim=-1))
        return mean, clamp_std(self.std, self.args)

    def action_dist_and_value(self, obs, privileged_obs, obs_history):
        """``action_dist`` then ``evaluate``: the heads share no pass."""
        return (*self.action_dist(obs, privileged_obs, obs_history),
                self.evaluate(obs, privileged_obs, obs_history))

    def act_student(self, obs, obs_history):
        latent = self.adaptation_module(obs_history)
        return self.actor_body(torch.cat([obs, latent], dim=-1))

    def act_teacher(self, obs, privileged_obs, obs_history):
        latent = self.env_factor_encoder(privileged_obs)
        return self.actor_body(torch.cat([obs, latent], dim=-1))

    def evaluate(self, obs, privileged_obs, obs_history):
        latent = self.env_factor_encoder(privileged_obs)
        return self.critic_body(torch.cat([obs, latent], dim=-1))[..., 0]
