"""The reference's policies, by the name a configuration file gives in
``policy``: name -> (argument class, policy class)."""

from .actor_critic import ACArgs, ActorCriticCSE
from .actor_critic_cnn import ACCnnArgs, ActorCriticCNN

POLICIES = {"ActorCriticCSE": (ACArgs, ActorCriticCSE),
            "ActorCriticCNN": (ACCnnArgs, ActorCriticCNN)}
