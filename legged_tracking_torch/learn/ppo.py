"""PPO with concurrent state estimation: the acting half (port of
``learn/ppo.py`` ``rollout``).

``rollout`` runs T steps of act -> env.step_fn -> store, with the timeout
bootstrap of the reference (``rew += gamma * value * time_out``,
ppo_cse/ppo.py:86-89).  GAE, the minibatch update, Adam and the adaptation
loss are the next slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .actor_critic import ACArgs, ActorCriticCSE, normal_log_prob


@dataclass
class PPOArgs:
    """The fields of PPO_Args (ppo_cse/ppo.py:13-30) that the acting half
    reads; the update's fields come with the update."""
    gamma: float = 0.99
    num_steps_per_env: int = 24
    # trailing cfg.env.num_eval_envs envs act with the deterministic teacher
    # instead of the student
    eval_expert: bool = False


class Transition(NamedTuple):
    """One rollout step for all envs; ``rollout`` stacks T of them."""
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    obs_history: torch.Tensor      # bf16, as the env stores it
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_prob: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


class PPO:
    """Holds the policy of an env and drives its rollouts."""

    def __init__(self, env, ac_args: ACArgs | None = None, args: PPOArgs | None = None,
                 ac: ActorCriticCSE | None = None, seed: int = 0):
        self.env = env
        self.args = args or PPOArgs()
        ac_args = ac_args or ACArgs()
        if ac_args.normalize_obs:
            raise NotImplementedError("normalize_obs (RunningMeanStd) is not ported yet")
        self.ac = (ac if ac is not None else ActorCriticCSE(
            num_obs=env.num_obs, num_privileged_obs=env.num_privileged_obs,
            num_obs_history=env.num_obs_history, num_actions=env.num_actions,
            args=ac_args)).to(env.device)
        self.n_eval = int(getattr(env.cfg.env, "num_eval_envs", 0))
        self.n_train = env.num_envs - self.n_eval
        self.generator = torch.Generator(device=env.device)
        self.generator.manual_seed(seed)

    @torch.no_grad()
    def rollout(self, env_state, obs_dict, action_noise=None):
        """T steps of (act -> env.step_fn -> store) (Runner.learn inner loop,
        ppo_cse/__init__.py:137-178).  ``obs_dict`` is carried across
        iterations like the reference's persistent obs.

        ``action_noise`` (T, N, num_actions): the standard normals that
        perturb the policy mean; drawn from the PPO generator when None.
        Returns (env_state, last_obs_dict, traj, metrics), with traj a
        Transition of (T, N, ...) tensors and metrics a dict of (T, N, ...)."""
        T = self.args.num_steps_per_env
        ac = self.ac
        steps, metrics = [], []
        for t in range(T):
            o = obs_dict["obs"]
            h16 = obs_dict["obs_history"]
            p = obs_dict["privileged_obs"]
            h = h16.float()
            mean, std = ac.action_dist(o, p, h)
            std = std.expand_as(mean)
            eps = (action_noise[t] if action_noise is not None else
                   torch.randn(mean.shape, generator=self.generator, device=mean.device))
            actions = mean + std * eps
            if self.n_eval:
                # trailing eval envs act deterministically (Runner.learn,
                # ppo_cse/__init__.py:160-167)
                a_det = (ac.act_teacher(o, p, h) if self.args.eval_expert
                         else ac.act_student(o, h))
                is_eval = (torch.arange(actions.shape[0], device=actions.device)
                           >= self.n_train)[:, None]
                actions = torch.where(is_eval, a_det, actions)
            log_prob = normal_log_prob(mean, std, actions)
            value = ac.evaluate(o, p, h)
            env_state, out = self.env.step_fn(env_state, actions)
            # timeout bootstrap (ppo_cse/ppo.py:86-89)
            rew = out.rew + self.args.gamma * value * out.info["time_outs"]
            steps.append(Transition(obs=o, privileged_obs=p, obs_history=h16,
                                    actions=actions, rewards=rew, dones=out.done,
                                    values=value, log_prob=log_prob, mu=mean, sigma=std))
            metrics.append({k: out.info[k] for k in
                            ("done", "episode_sums", "episode_length", "reached",
                             "goal_distance")})
            obs_dict = {"obs": out.obs, "privileged_obs": out.privileged_obs,
                        "obs_history": out.obs_history}
        traj = Transition(*(torch.stack(field) for field in zip(*steps)))
        metrics = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
        return env_state, obs_dict, traj, metrics
