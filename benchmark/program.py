"""The system under test: the modules of ``legged_tracking_torch`` that
:mod:`benchmark.build` builds a cell from.  The only file of the benchmark
that imports the program."""

from __future__ import annotations


def modules():
    """The port's :class:`benchmark.build.Modules` (importing the package
    switches TF32 off, as the configurations state)."""
    from legged_tracking_torch.config import Cfg, config_go1
    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv
    from legged_tracking_torch.learn.actor_critic import ACArgs, ActorCriticCSE
    from legged_tracking_torch.learn.actor_critic_cnn import ACCnnArgs, ActorCriticCNN
    from legged_tracking_torch.learn.ppo import PPO, PPOArgs
    from legged_tracking_torch.parallel import Shard

    from .build import Modules
    return Modules(Cfg, config_go1, {"LeggedEnv": LeggedEnv,
                                     "VelocityTrackingEnv": VelocityTrackingEnv},
                   {"ActorCriticCSE": (ACArgs, ActorCriticCSE),
                    "ActorCriticCNN": (ACCnnArgs, ActorCriticCNN)},
                   PPO, PPOArgs, Shard)


def fault_targets():
    """The port's ``learn/ppo.py`` module and env classes, where
    :func:`benchmark.faults.plant` plants a fault for the tests."""
    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv
    from legged_tracking_torch.learn import ppo

    return ppo, [LeggedEnv, VelocityTrackingEnv]
