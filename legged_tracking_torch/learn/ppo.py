"""PPO with concurrent state estimation (port of ``learn/ppo.py``).

One ``train_iteration`` is a rollout of T steps (act -> env.step_fn ->
store, with the reference's timeout bootstrap ``rew += gamma * value *
time_out``, ppo_cse/ppo.py:86-89), GAE with the advantages normalized over
the whole buffer (rollout_storage.py:76-90), and the clipped-surrogate
update: one permutation shared by every epoch (rollout_storage.py:102), the
adaptive-KL learning rate per minibatch (ppo.py:112-124) and the
adaptation-module substep with its own Adam (ppo.py:164-185).

The module's parameters are the training state's ``params``: the update
changes them in place.  Histories are stored bf16, as the env keeps them,
and read as float32 by the policy, as flax promotes them.  The adaptive
learning rate stays a float32 tensor on the device and its branches are
``torch.where``, so a minibatch never waits for the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .actor_critic import (ACArgs, ActorCriticCSE, normal_entropy, normal_kl,
                           normal_log_prob)
from .optim import AdamState, adam_init, adam_step, clip_by_global_norm
from .utils import RunningMeanStd


@dataclass
class PPOArgs:
    """PPO_Args parity (ppo_cse/ppo.py:13-30)."""
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1e-3
    adaptation_module_learning_rate: float = 1e-3
    num_adaptation_module_substeps: int = 1
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    # clamp window of the adaptive-KL learning rate (the reference
    # hard-codes [1e-5, 1e-2], ppo.py:113-120)
    min_adaptive_lr: float = 1e-5
    max_adaptive_lr: float = 1e-2
    max_grad_norm: float = 1.0
    num_steps_per_env: int = 24
    # the JAX package's O(B) shuffle for sharded batches and its windowed
    # history storage (a TPU layout device with bitwise-equal histories);
    # neither is ported, both are off by default
    cheap_shuffle: bool = False
    windowed_history: bool = False
    # trailing cfg.env.num_eval_envs envs act with the deterministic teacher
    # instead of the student
    eval_expert: bool = False


class TrainState(NamedTuple):
    params: dict                    # name -> the module's parameter (live)
    opt_state: AdamState
    adapt_opt_state: AdamState
    learning_rate: torch.Tensor     # () float32 on the device (adaptive-KL)
    iteration: int
    obs_rms: RunningMeanStd | None = None   # over obs_history (normalize_obs)


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


def copy_state(ts: TrainState) -> TrainState:
    """A deep copy of every tensor of ``ts`` (a snapshot the update cannot
    change)."""
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}
    adam = lambda s: AdamState(s.count, clone(s.mu), clone(s.nu))
    return TrainState(
        params=clone(ts.params), opt_state=adam(ts.opt_state),
        adapt_opt_state=adam(ts.adapt_opt_state),
        learning_rate=ts.learning_rate.clone(), iteration=ts.iteration,
        obs_rms=(RunningMeanStd(*(t.clone() for t in ts.obs_rms))
                 if ts.obs_rms is not None else None))


class PPO:
    """Holds the policy of an env and runs its train iterations."""

    def __init__(self, env, ac_args: ACArgs | None = None, args: PPOArgs | None = None,
                 ac: torch.nn.Module | None = None, seed: int = 0):
        """``ac``: the policy (``ActorCriticCSE``, ``ActorCriticCNN`` or
        ``ActorCriticRMA``: any module with ``action_dist``, ``evaluate``,
        ``adapt``, ``adaptation_target``, ``act_student`` and
        ``act_teacher``); the CSE MLP of ``ac_args`` when None."""
        self.env = env
        self.args = args or PPOArgs()
        if self.args.cheap_shuffle:
            raise NotImplementedError("PPOArgs.cheap_shuffle is not ported (ROADMAP A13)")
        if self.args.windowed_history:
            raise NotImplementedError("PPOArgs.windowed_history, a TPU layout device, "
                                      "is not ported")
        ac_args = ac_args or ACArgs()
        self.ac = (ac if ac is not None else ActorCriticCSE(
            num_obs=env.num_obs, num_privileged_obs=env.num_privileged_obs,
            num_obs_history=env.num_obs_history, num_actions=env.num_actions,
            args=ac_args)).to(env.device)
        # a policy's args may lack normalize_obs (ACRmaArgs has none)
        self.normalize_obs = bool(getattr(getattr(self.ac, "args", None), "normalize_obs",
                                          False))
        self.device = env.device
        # the trailing num_eval_envs envs act deterministically and never
        # enter GAE or the update (reference BaseTask, base_task.py:44-49)
        self.n_eval = int(getattr(env.cfg.env, "num_eval_envs", 0))
        self.n_train = env.num_envs - self.n_eval
        # the leading n_mix train envs rehearse easier distances
        # (cl_dist_mix); the curriculum reads the frontier_* metrics
        ct = getattr(env.cfg, "curriculum_thresholds", None)
        mix = float(getattr(ct, "cl_dist_mix", 0.0)) if ct is not None else 0.0
        self.n_mix = int(round(mix * self.n_train))
        self.generator = torch.Generator(device=env.device)
        self.generator.manual_seed(seed)
        # record env0's frames for the training video (the Runner sets it)
        self.record_video = False

    def init(self) -> TrainState:
        params = dict(self.ac.named_parameters())
        return TrainState(
            params=params, opt_state=adam_init(params), adapt_opt_state=adam_init(params),
            learning_rate=torch.tensor(self.args.learning_rate, dtype=torch.float32,
                                       device=self.device),
            iteration=0,
            obs_rms=(RunningMeanStd.create((self.env.num_obs_history,), device=self.device)
                     if self.normalize_obs else None))

    def warmup_init(self) -> AdamState:
        """A fresh optimizer state for :meth:`warmup_iteration`."""
        return adam_init(dict(self.ac.named_parameters()))

    # ------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout(self, env_state, obs_dict, action_noise=None, obs_rms=None):
        """T steps of (act -> env.step_fn -> store) (Runner.learn inner loop,
        ppo_cse/__init__.py:137-178).  ``obs_dict`` is carried across
        iterations like the reference's persistent obs.

        ``action_noise`` (T, N, num_actions): the standard normals that
        perturb the policy mean; drawn from the PPO generator when None.
        With normalize_obs the history is whitened by ``obs_rms`` (then cast
        back to bf16), and the stats take in the raw history each step.
        Returns (env_state, last_obs_dict, traj, metrics, obs_rms), with
        traj a Transition of (T, N, ...) tensors and metrics a dict of
        (T, N, ...); with ``record_video``, ``metrics["video"]`` holds env0's
        (T, .) base_pos, base_quat and qj after each step."""
        T = self.args.num_steps_per_env
        ac = self.ac
        steps, metrics, frames = [], [], []
        for t in range(T):
            o = obs_dict["obs"]
            h16 = obs_dict["obs_history"]
            p = obs_dict["privileged_obs"]
            if self.normalize_obs:
                h16, obs_rms = (obs_rms.normalize(h16).to(h16.dtype),
                                obs_rms.update(obs_dict["obs_history"]))
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
            if self.record_video:
                # views of this step's state, stacked once after the loop
                phys = env_state.phys
                frames.append((phys.base_pos[0], phys.base_quat[0], phys.qj[0]))
            obs_dict = {"obs": out.obs, "privileged_obs": out.privileged_obs,
                        "obs_history": out.obs_history}
        traj = Transition(*(torch.stack(field) for field in zip(*steps)))
        metrics = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
        if frames:
            metrics["video"] = {k: torch.stack(v) for k, v in
                                zip(("base_pos", "base_quat", "qj"), zip(*frames))}
        return env_state, obs_dict, traj, metrics, obs_rms

    # ----------------------------------------------------------------- GAE
    @torch.no_grad()
    def compute_gae(self, traj: Transition, last_values):
        """(rollout_storage.compute_returns, :76-90): returns and the
        advantages normalized over the whole buffer (std with ddof 0)."""
        g, lam = self.args.gamma, self.args.lam
        T = traj.rewards.shape[0]
        dones = traj.dones.float()
        adv = torch.zeros_like(last_values)
        advs = [None] * T
        for t in reversed(range(T)):
            next_value = traj.values[t + 1] if t + 1 < T else last_values
            nonterm = 1.0 - dones[t]
            delta = traj.rewards[t] + nonterm * g * next_value - traj.values[t]
            adv = delta + nonterm * g * lam * adv
            advs[t] = adv
        advs = torch.stack(advs)
        returns = advs + traj.values
        norm_advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        return returns, norm_advs

    # -------------------------------------------------------------- update
    def _permuted(self, tensors, perm):
        """Gather (T, N, ...) tensors once into permuted order, grouped as
        (num_mini_batches, mb, ...): each minibatch is then a contiguous
        slice, and the same permutation serves every epoch."""
        nm = self.args.num_mini_batches
        T, N = tensors[0].shape[:2]
        B = T * N
        mb = B // nm
        if perm is None:
            perm = torch.randperm(nm * mb, generator=self.generator, device=self.device)
        perm = perm.to(self.device)
        return [x.reshape((B,) + x.shape[2:])[perm].reshape((nm, mb) + x.shape[2:])
                for x in tensors]

    def _value_loss(self, value, target_values, returns):
        """The value loss, clipped around the rollout's values by default."""
        a = self.args
        if not a.use_clipped_value_loss:
            return torch.mean(torch.square(returns - value))
        v_clipped = target_values + torch.clamp(value - target_values,
                                                -a.clip_param, a.clip_param)
        return torch.mean(torch.maximum(torch.square(value - returns),
                                        torch.square(v_clipped - returns)))

    def _minibatch_update(self, ts: TrainState, batch):
        a = self.args
        ac = self.ac
        params = ts.params
        o, h, p, actions, target_values, advantages, returns, old_lp, old_mu, old_sigma = batch
        h = h.float()

        mean, std = ac.action_dist(o, p, h)
        log_prob = normal_log_prob(mean, std, actions)
        value = ac.evaluate(o, p, h)
        entropy = normal_entropy(std)
        ratio = torch.exp(log_prob - old_lp)
        surr = -advantages * ratio
        surr_clipped = -advantages * torch.clamp(ratio, 1.0 - a.clip_param, 1.0 + a.clip_param)
        surrogate_loss = torch.mean(torch.maximum(surr, surr_clipped))
        v_loss = self._value_loss(value, target_values, returns)
        loss = surrogate_loss + a.value_loss_coef * v_loss - a.entropy_coef * torch.mean(entropy)
        # a parameter the loss does not read (the RMA policy's adaptation
        # module) takes a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)

        with torch.no_grad():
            kl = torch.mean(normal_kl(old_mu, old_sigma, mean, std))
            # adaptive-KL learning rate (ppo.py:110-124), from this
            # minibatch's KL, applied to this minibatch's step.  The JAX
            # package's lr / 1.5 compiles to a multiply by the float32
            # reciprocal of 1.5 (XLA folds the division by a constant)
            lr = ts.learning_rate
            if a.desired_kl is not None and a.schedule == "adaptive":
                lr = torch.where(kl > a.desired_kl * 2.0,
                                 torch.clamp(lr * (1.0 / 1.5), min=a.min_adaptive_lr), lr)
                lr = torch.where((kl < a.desired_kl / 2.0) & (kl > 0.0),
                                 torch.clamp(lr * 1.5, max=a.max_adaptive_lr), lr)
            opt_state = adam_step(params, clip_by_global_norm(grads, a.max_grad_norm),
                                  ts.opt_state, lr, injected=True)

        # adaptation-module substep (ppo.py:160-190) on the post-step
        # parameters: 80/20 train/test split; the target is the policy's
        # adaptation_target (the privileged obs, or the RMA encoder's
        # latent), without its gradient
        n_train = h.shape[0] // 5 * 4
        adapt_opt_state = ts.adapt_opt_state
        ad_loss = ad_test = torch.zeros((), device=self.device)
        for _ in range(a.num_adaptation_module_substeps):
            with torch.no_grad():
                target = ac.adaptation_target(p)
            pred = ac.adapt(h)
            ad_loss = torch.mean(torch.square(pred[:n_train] - target[:n_train]))
            ad_test = torch.mean(torch.square(pred[n_train:] - target[n_train:])).detach()
            ad_grads = torch.autograd.grad(ad_loss, list(params.values()),
                                           allow_unused=True, materialize_grads=True)
            adapt_opt_state = adam_step(params, ad_grads, adapt_opt_state,
                                        a.adaptation_module_learning_rate)
        stats = torch.stack([x.detach() for x in (v_loss, surrogate_loss, ad_loss, ad_test, kl)])
        return ts._replace(opt_state=opt_state, adapt_opt_state=adapt_opt_state,
                           learning_rate=lr), stats

    def update(self, ts: TrainState, traj: Transition, returns, advantages, perm=None):
        """``num_learning_epochs`` passes over the buffer in
        ``num_mini_batches`` minibatches.  ``perm``: the permutation of the
        flattened (T * N) samples; drawn from the PPO generator when None."""
        a = self.args
        data = self._permuted(
            (traj.obs, traj.obs_history, traj.privileged_obs, traj.actions, traj.values,
             advantages, returns, traj.log_prob, traj.mu, traj.sigma), perm)
        stats = []
        for _ in range(a.num_learning_epochs):
            for i in range(a.num_mini_batches):
                ts, s = self._minibatch_update(ts, [x[i] for x in data])
                stats.append(s)
        mean_stats = torch.stack(stats).mean(dim=0)
        metrics = {"value_loss": mean_stats[0], "surrogate_loss": mean_stats[1],
                   "adaptation_loss": mean_stats[2], "adaptation_test_loss": mean_stats[3],
                   "kl_mean": mean_stats[4], "learning_rate": ts.learning_rate}
        return ts._replace(iteration=ts.iteration + 1), metrics

    # ------------------------------------------------- critic-only warmup
    def warmup_iteration(self, ts: TrainState, env_state, obs_dict, warmup_opt_state,
                         action_noise=None, perm=None):
        """One rollout and value-loss-only updates that change only
        ``critic_body`` (resume-shock mitigation): every other gradient is
        zeroed and the warmup Adam starts fresh, so the policy stays
        bitwise frozen.  Returns (ts, env_state, last_obs, metrics,
        warmup_opt_state)."""
        a = self.args
        env_state, last_obs, traj, _, obs_rms = self.rollout(
            env_state, obs_dict, action_noise, ts.obs_rms)
        traj, last_values = self._train_part(traj, self._last_values(last_obs, obs_rms))
        returns, _ = self.compute_gae(traj, last_values)
        data = self._permuted((traj.obs, traj.obs_history, traj.privileged_obs,
                               traj.values, returns), perm)
        params = ts.params
        v_ls = []
        for _ in range(a.num_learning_epochs):
            for i in range(a.num_mini_batches):
                o, h, p, target_values, rets = (x[i] for x in data)
                v_l = self._value_loss(self.ac.evaluate(o, p, h.float()), target_values, rets)
                grads = torch.autograd.grad(v_l, list(params.values()),
                                            allow_unused=True, materialize_grads=True)
                grads = [g if k.startswith("critic_body.") else torch.zeros_like(g)
                         for k, g in zip(params, grads)]
                with torch.no_grad():
                    warmup_opt_state = adam_step(
                        params, clip_by_global_norm(grads, a.max_grad_norm),
                        warmup_opt_state, a.learning_rate)
                v_ls.append(v_l.detach())
        if self.normalize_obs:
            ts = ts._replace(obs_rms=obs_rms)
        metrics = {"value_loss": torch.stack(v_ls).mean()}
        return ts, env_state, last_obs, metrics, warmup_opt_state

    # ------------------------------------------------------- one iteration
    def _train_part(self, traj, last_values):
        """The train envs' share of a rollout: the held-out eval envs never
        enter GAE or the update (process_env_step slices [:num_train_envs],
        ppo_cse/__init__.py:177-178)."""
        if not self.n_eval:
            return traj, last_values
        return Transition(*(x[:, :self.n_train] for x in traj)), last_values[:self.n_train]

    @torch.no_grad()
    def _last_values(self, last_obs, obs_rms):
        h = last_obs["obs_history"]
        # whitened in float32 here, not cast back to bf16 (ppo.py:603)
        h = obs_rms.normalize(h) if self.normalize_obs else h.float()
        return self.ac.evaluate(last_obs["obs"], last_obs["privileged_obs"], h)

    def train_iteration(self, ts: TrainState, env_state, obs_dict, update_model: bool = True,
                        action_noise=None, perm=None):
        """One rollout, then the update unless ``update_model`` is False
        (the reference's --freeze_model data collection).  ``action_noise``
        and ``perm`` as for :meth:`rollout` and :meth:`update`.  Returns
        (ts, env_state, last_obs, metrics)."""
        env_state, last_obs, traj, roll_metrics, obs_rms = self.rollout(
            env_state, obs_dict, action_noise, ts.obs_rms)
        traj_train, last_values = self._train_part(traj, self._last_values(last_obs, obs_rms))
        if update_model:
            returns, advantages = self.compute_gae(traj_train, last_values)
            ts, metrics = self.update(ts, traj_train, returns, advantages, perm)
        else:
            z = torch.zeros((), device=self.device)
            metrics = {"value_loss": z, "surrogate_loss": z, "adaptation_loss": z,
                       "adaptation_test_loss": z, "kl_mean": z,
                       "learning_rate": ts.learning_rate}
        if self.normalize_obs:
            ts = ts._replace(obs_rms=obs_rms)

        # episodic metrics: done-masked means over the rollout window, the
        # train and eval populations apart (ppo_cse/__init__.py:137-140,200-214)
        def ep_metrics(sl, prefix=""):
            done = roll_metrics["done"][:, sl]                 # (T, n)
            n_done = torch.clamp(torch.sum(done), min=1)
            dmask = done.float()
            dmean = lambda x: torch.sum(x[:, sl] * dmask) / n_done
            ep_sums = roll_metrics["episode_sums"][:, sl]      # (T, n, K)
            metrics[prefix + "num_episodes"] = torch.sum(done)
            metrics[prefix + "episode_sums_mean"] = (
                torch.sum(ep_sums * dmask[..., None], dim=(0, 1)) / n_done)
            metrics[prefix + "episode_length_mean"] = dmean(
                roll_metrics["episode_length"].float())
            metrics[prefix + "reached_mean"] = dmean(roll_metrics["reached"].float())
            metrics[prefix + "goal_distance_mean"] = dmean(roll_metrics["goal_distance"])

        if "video" in roll_metrics:
            metrics["video"] = roll_metrics["video"]
        with torch.no_grad():
            metrics["mean_reward_per_step"] = torch.mean(traj_train.rewards)
            metrics["action_std_mean"] = torch.mean(traj.sigma[-1])
            ep_metrics(slice(0, self.n_train))
            if self.n_mix:
                ep_metrics(slice(self.n_mix, self.n_train), prefix="frontier_")
            if self.n_eval:
                ep_metrics(slice(self.n_train, None), prefix="eval_")
        return ts, env_state, last_obs, metrics

    # ------------------------------------------------------------ policies
    @torch.no_grad()
    def act_inference(self, obs, obs_history):
        """Student/deployment policy (act_student, actor_critic.py:144-148)."""
        return self.ac.act_student(obs, obs_history)

    @torch.no_grad()
    def act_teacher(self, obs, privileged_obs, obs_history):
        return self.ac.act_teacher(obs, privileged_obs, obs_history)
