"""PPO with concurrent state estimation (port of ``learn/ppo.py``).

One ``train_iteration`` is a rollout of T steps (act -> env.step_fn ->
store, with the reference's timeout bootstrap ``rew += gamma * value *
time_out``, ppo_cse/ppo.py:86-89), GAE with the advantages normalized over
the whole buffer (rollout_storage.py:76-90), and the clipped-surrogate
update: one permutation shared by every epoch (rollout_storage.py:102), the
adaptive-KL learning rate per minibatch (ppo.py:112-124) and the
adaptation-module substep with its own Adam (ppo.py:164-185).

With ``PPOArgs.windowed_history`` the rollout stores no history rows: each
env's history is one contiguous window of its frame stream (the window
shifts across an auto-reset with no done masking), so the update cuts every
minibatch's rows from that stream (:func:`frame_stream`,
:func:`stream_windows`) where the minibatch is used, bitwise the rows it
would have stored.  The buffer then holds each frame once instead of K
times.

The module's parameters are the training state's ``params``: the update
changes them in place.  Histories are stored bf16, as the env keeps them,
and read as float32 by the policy, as flax promotes them.  The adaptive
learning rate stays a float32 tensor on the device and its branches are
``torch.where``, so a minibatch never waits for the host.

Under data parallelism the env is a shard (:class:`..parallel.Shard`): rank r
holds the global envs ``[r n, (r + 1) n)`` and the same parameters as every
rank.  Random numbers are drawn at the global width from the generator every
rank seeds alike and sliced (the action noise), or drawn whole (the
minibatch permutation of the global ``t * N + n`` flat index, JAX's layout);
each minibatch keeps, on each rank, the positions whose sample lies in its
shard.  Every mean over the env axis is a local sum over the global count,
all-reduced: the advantage normalization (count, sum and sum of squares in
float64), the losses, KL and the adaptation module's 80/20 split (by the
sample's position in the global minibatch), the obs normalizer's batch
statistics and the logged episodic metrics.  Gradients are all-reduced in
one flat buffer before the global-norm clip, so every rank takes the same
Adam step and the same adaptive-rate decision.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import tracing
from ..parallel import all_reduce_sum
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
    # the JAX package's O(B) shuffle (cheap_perm) for large batches, and
    # windowed histories: the rollout keeps each frame once and the update
    # cuts the K-frame windows from the frame stream, bitwise the stored
    # rows (the knob for memory at large env counts or long histories).
    # Both off by default; windowed_history turns itself off under
    # normalize_obs, whose stored histories are whitened step by step
    cheap_shuffle: bool = False
    windowed_history: bool = False
    # trailing cfg.env.num_eval_envs envs act with the deterministic teacher
    # instead of the student
    eval_expert: bool = False


def cheap_perm(B: int, T: int, N: int, a0, c1, c2) -> torch.Tensor:
    """O(B) bijection of [0, B) (the JAX package's ``_cheap_perm``,
    ``learn/ppo.py:34``): affine -> (t, n) digit swap -> affine.  ``a0``:
    the two multipliers' starts, each moved to the first of the next 128
    integers coprime to B (1 if none is); ``c1``, ``c2``: the offsets.  The
    arithmetic is JAX's int32 arithmetic, wrapping included, taken exactly in
    int64."""
    device = c1.device
    i32 = lambda x: torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31

    def mult(a):
        cand = a.long() + torch.arange(128, device=device)
        ok = torch.gcd(cand, torch.full_like(cand, B)) == 1
        return torch.where(ok.any(), cand[torch.argmax(ok.int())], 1)

    a1, a2 = (mult(a) for a in a0)
    s = torch.arange(B, device=device)
    p = torch.remainder(i32(a1 * s + c1.long()), B)
    p = (p % N) * T + (p // N)          # digit swap: a bijection since B = T * N
    return torch.remainder(i32(a2 * p + c2.long()), B)


def frame_stream(h_first, s0, frames, K: int, num_obs: int) -> torch.Tensor:
    """The (N, 2K - 2 + T, num_obs) bf16 frame stream the histories of a
    rollout are cut from (the JAX package's ``_window_histories``,
    ``learn/ppo.py:318``):

        F = [ h_first (K frames) | s0 frames 1..K-1 | f_1 .. f_{T-1} ]

    ``h_first`` (N, K * num_obs): the history the policy acted on at step 0;
    ``s0`` (N, K * num_obs): the env state's history before the rollout;
    ``frames`` (T, N, num_obs): the rollout's float32 obs, cast to bf16 as
    the env casts the frame it appends.  After the Runner's ``observe``,
    ``h_first`` is a virtual row (observe appends f_0 without storing it in
    the state), so its f_0 never enters the stream that the steps extend;
    after a step, ``h_first`` is ``s0``.  Either way the history at step t
    is the window starting at 0 for t = 0 and at K + t - 1 after."""
    n = h_first.shape[0]
    return torch.cat([h_first.reshape(n, K, num_obs),
                      s0.reshape(n, K, num_obs)[:, 1:].to(h_first.dtype),
                      frames[1:].transpose(0, 1).to(h_first.dtype)], dim=1)


def stream_windows(F, t_idx, n_idx, K: int) -> torch.Tensor:
    """The (B, K * num_obs) history rows of the samples (t_idx, n_idx), each
    a window of K frames of env n_idx's stream ``F`` (:func:`frame_stream`),
    gathered by advanced indexing: a new tensor, no view of ``F``."""
    start = torch.where(t_idx == 0, 0, K + t_idx - 1)
    rows = start[:, None] + torch.arange(K, device=F.device)
    return F[n_idx[:, None], rows].reshape(t_idx.shape[0], -1)


def window_histories(h_first, s0, frames, t_idx, n_idx, K: int, num_obs: int) -> torch.Tensor:
    """The history rows of the samples (t_idx, n_idx) rebuilt from the frame
    stream: bitwise the rows the rollout would have stored."""
    return stream_windows(frame_stream(h_first, s0, frames, K, num_obs), t_idx, n_idx, K)


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
    obs_history: torch.Tensor      # bf16, as the env stores it; (N, 0) when windowed
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
        ac_args = ac_args or ACArgs()
        self.ac = (ac if ac is not None else ActorCriticCSE(
            num_obs=env.num_obs, num_privileged_obs=env.num_privileged_obs,
            num_obs_history=env.num_obs_history, num_actions=env.num_actions,
            args=ac_args)).to(env.device)
        # a policy's args may lack normalize_obs (ACRmaArgs has none)
        self.normalize_obs = bool(getattr(getattr(self.ac, "args", None), "normalize_obs",
                                          False))
        # windowed histories hold only where the stored rows are raw frames
        # (JAX, learn/ppo.py:159-162): off under normalize_obs
        self._window_history = self.args.windowed_history and not self.normalize_obs
        self._frames = env.num_obs_history // env.num_obs     # K, the history's frames
        self.device = env.device
        # a data-parallel rank's shard of the envs; n_eval, n_train and
        # n_mix count global envs
        self.shard = env.shard
        self.dp = self.shard is not None and self.shard.world > 1
        self.num_envs_global = env.num_envs_global
        # the trailing num_eval_envs envs act deterministically and never
        # enter GAE or the update (reference BaseTask, base_task.py:44-49)
        self.n_eval = int(getattr(env.cfg.env, "num_eval_envs", 0))
        self.n_train = self.num_envs_global - self.n_eval
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

    def _rows(self, lo: int, hi: int | None = None) -> slice:
        """The local rows of the global envs [lo, hi)."""
        return self.shard.local_slice(lo, hi) if self.shard is not None else slice(lo, hi)

    def _perm(self, B: int, T: int, N: int) -> torch.Tensor:
        """A permutation of [0, B) from the PPO generator (the same on every
        rank): ``randperm``, or with ``cheap_shuffle`` :func:`cheap_perm` of
        the (T, N) layout (of (1, B) where B is not T * N), its multiplier
        starts drawn in [2, amax) and its offsets in [0, B) as JAX's are."""
        if not self.args.cheap_shuffle:
            return torch.randperm(B, generator=self.generator, device=self.device)
        amax = max(3, min((2 ** 31 - 1 - B) // max(B, 1), 1 << 20))
        r = lambda lo, hi: torch.randint(lo, hi, (), generator=self.generator,
                                         device=self.device, dtype=torch.int32)
        draws = (r(2, amax), r(2, amax)), r(0, B), r(0, B)
        return cheap_perm(B, T, N, *draws) if B == T * N else cheap_perm(B, 1, B, *draws)

    def warmup_init(self) -> AdamState:
        """A fresh optimizer state for :meth:`warmup_iteration`."""
        return adam_init(dict(self.ac.named_parameters()))

    # ------------------------------------------------------------- rollout
    @torch.no_grad()
    @tracing.spanned("ppo.rollout")
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
        (T, .) base_pos, base_quat and qj after each step.  With windowed
        histories ``traj.obs_history`` is (T, N, 0): the update cuts the
        rows from the frame stream instead."""
        T = self.args.num_steps_per_env
        ac = self.ac
        steps, metrics, frames = [], [], []
        for t in range(T):
            with tracing.span("ppo.act"):
                o = obs_dict["obs"]
                h16 = obs_dict["obs_history"]
                p = obs_dict["privileged_obs"]
                if self.normalize_obs:
                    h16, obs_rms = (obs_rms.normalize(h16).to(h16.dtype),
                                    obs_rms.update(obs_dict["obs_history"],
                                                   all_reduce_sum if self.dp else None))
                h = h16.float()
                mean, std = ac.action_dist(o, p, h)
                std = std.expand_as(mean)
                if action_noise is not None:
                    eps = action_noise[t]
                else:
                    # at the global width, the shard's rows kept
                    eps = torch.randn((self.num_envs_global,) + mean.shape[1:],
                                      generator=self.generator, device=mean.device)
                    if self.shard is not None:
                        eps = self.shard.shard_rows(eps)
                actions = mean + std * eps
                if self.n_eval:
                    # trailing eval envs act deterministically (Runner.learn,
                    # ppo_cse/__init__.py:160-167)
                    a_det = (ac.act_teacher(o, p, h) if self.args.eval_expert
                             else ac.act_student(o, h))
                    is_eval = (self.env.env_ids() >= self.n_train)[:, None]
                    actions = torch.where(is_eval, a_det, actions)
                log_prob = normal_log_prob(mean, std, actions)
                value = ac.evaluate(o, p, h)
            env_state, out = self.env.step_fn(env_state, actions)
            # timeout bootstrap (ppo_cse/ppo.py:86-89)
            rew = out.rew + self.args.gamma * value * out.info["time_outs"]
            h_store = h16.new_empty((h16.shape[0], 0)) if self._window_history else h16
            steps.append(Transition(obs=o, privileged_obs=p, obs_history=h_store,
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
    @tracing.spanned("ppo.gae")
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
        if not self.dp:
            return returns, (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        a = advs.double()
        n, s, ss = all_reduce_sum([torch.full((), a.numel(), dtype=torch.float64,
                                              device=a.device), a.sum(), a.square().sum()])
        mean = s / n
        std = torch.sqrt(torch.clamp(ss / n - mean * mean, min=0.0))
        return returns, (advs - mean.float()) / (std.float() + 1e-8)

    # -------------------------------------------------------------- update
    def _permuted(self, tensors, perm):
        """The minibatches of (T, N, ...) tensors under one permutation of
        the flattened samples, which serves every epoch.

        One rank: minibatch i is the samples ``perm[i mb:(i + 1) mb]``.
        Under data parallelism: N is the rank's train envs, the permutation
        runs over the global ``t * N_global + n`` index, and minibatch i is
        the rank's samples among its positions, in order, with their
        positions in the global minibatch (the adaptation split reads them).
        A None among ``tensors`` (the history, when windowed) takes the
        samples' local (t, n) in its place, which :meth:`_with_windows`
        turns into rows.  Returns (mb, [(tensors_i, positions_i or None) for
        each minibatch])."""
        nm = self.args.num_mini_batches
        T, n = tensors[0].shape[:2]
        N = self.n_train if self.dp else n
        mb = T * N // nm
        if perm is None:
            perm = self._perm(nm * mb, T, N)
        perm = perm.to(self.device)
        flat = [None if x is None else x.reshape((T * n,) + x.shape[2:]) for x in tensors]
        if not self.dp:
            idx = [perm[i * mb:(i + 1) * mb] for i in range(nm)]
            pos = [None] * nm
        else:
            t, e = perm // N, perm % N - self.shard.start
            mine = (e >= 0) & (e < n)
            at = torch.arange(mb, device=self.device)
            sls = [slice(i * mb, (i + 1) * mb) for i in range(nm)]
            idx = [(t[sl] * n + e[sl])[mine[sl]] for sl in sls]
            pos = [at[mine[sl]] for sl in sls]
        take = lambda x, i: (i // n, i % n) if x is None else x[i]
        return mb, [([take(x, i) for x in flat], p) for i, p in zip(idx, pos)]

    def _stream(self, h0, frames):
        """The frame stream of the train envs' rollout (:func:`frame_stream`)
        from ``h0`` = (h_first, s0), or None without windowed histories."""
        if not self._window_history:
            return None
        return frame_stream(*h0, frames, self._frames, self.env.num_obs)

    def _with_windows(self, batch, stream):
        """A minibatch as the update reads it: with a frame ``stream``, the
        samples' (t, n) in the history's place become their rows, gathered
        here, so the update holds one minibatch of windows at a time."""
        if stream is None:
            return batch
        return [batch[0], stream_windows(stream, *batch[1], self._frames), *batch[2:]]

    def _mean(self, mb):
        """The minibatch mean: ``torch.mean`` on one rank; under data
        parallelism this rank's sum over the global count of the minibatch's
        elements, which the all-reduce completes."""
        if not self.dp:
            return torch.mean
        return lambda x: torch.sum(x) / (mb * math.prod(x.shape[1:]))

    def _value_loss(self, value, target_values, returns, mean=torch.mean):
        """The value loss, clipped around the rollout's values by default."""
        a = self.args
        if not a.use_clipped_value_loss:
            return mean(torch.square(returns - value))
        v_clipped = target_values + torch.clamp(value - target_values,
                                                -a.clip_param, a.clip_param)
        return mean(torch.maximum(torch.square(value - returns),
                                  torch.square(v_clipped - returns)))

    @tracing.spanned("ppo.minibatch")
    def _minibatch_update(self, ts: TrainState, batch, pos=None, mb=None):
        """One minibatch step.  ``pos``, ``mb``: under data parallelism the
        samples' positions in the global minibatch of ``mb``."""
        a = self.args
        ac = self.ac
        params = ts.params
        o, h, p, actions, target_values, advantages, returns, old_lp, old_mu, old_sigma = batch
        h = h.float()
        mean_ = self._mean(mb)

        mean, std = ac.action_dist(o, p, h)
        log_prob = normal_log_prob(mean, std, actions)
        value = ac.evaluate(o, p, h)
        # per sample under data parallelism, where the mean is a share
        entropy = normal_entropy(std.expand_as(mean) if self.dp else std)
        ratio = torch.exp(log_prob - old_lp)
        surr = -advantages * ratio
        surr_clipped = -advantages * torch.clamp(ratio, 1.0 - a.clip_param, 1.0 + a.clip_param)
        surrogate_loss = mean_(torch.maximum(surr, surr_clipped))
        v_loss = self._value_loss(value, target_values, returns, mean_)
        loss = surrogate_loss + a.value_loss_coef * v_loss - a.entropy_coef * mean_(entropy)
        # a parameter the loss does not read (the RMA policy's adaptation
        # module) takes a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)

        with torch.no_grad():
            kl = mean_(normal_kl(old_mu, old_sigma, mean, std))
            v_loss, surrogate_loss = v_loss.detach(), surrogate_loss.detach()
            if self.dp:
                *grads, kl, v_loss, surrogate_loss = all_reduce_sum(
                    list(grads) + [kl, v_loss, surrogate_loss])
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
        n_train = (mb if self.dp else h.shape[0]) // 5 * 4
        adapt_opt_state = ts.adapt_opt_state
        ad_loss = ad_test = torch.zeros((), device=self.device)
        with tracing.span("ppo.adapt"):
            for _ in range(a.num_adaptation_module_substeps):
                with torch.no_grad():
                    target = ac.adaptation_target(p)
                pred = ac.adapt(h)
                if self.dp:
                    # the split by the sample's position in the global minibatch
                    sq = torch.square(pred - target)
                    train = (pos < n_train).reshape((-1,) + (1,) * (sq.ndim - 1))
                    d = math.prod(sq.shape[1:])
                    ad_loss = torch.sum(sq * train) / (n_train * d)
                    ad_test = torch.sum(sq.detach() * ~train) / ((mb - n_train) * d)
                else:
                    ad_loss = torch.mean(torch.square(pred[:n_train] - target[:n_train]))
                    ad_test = torch.mean(torch.square(pred[n_train:] - target[n_train:])).detach()
                ad_grads = torch.autograd.grad(ad_loss, list(params.values()),
                                               allow_unused=True, materialize_grads=True)
                ad_loss = ad_loss.detach()
                if self.dp:
                    *ad_grads, ad_loss, ad_test = all_reduce_sum(
                        list(ad_grads) + [ad_loss, ad_test])
                adapt_opt_state = adam_step(params, ad_grads, adapt_opt_state,
                                            a.adaptation_module_learning_rate)
        stats = torch.stack([v_loss, surrogate_loss, ad_loss, ad_test, kl])
        return ts._replace(opt_state=opt_state, adapt_opt_state=adapt_opt_state,
                           learning_rate=lr), stats

    @tracing.spanned("ppo.update")
    def update(self, ts: TrainState, traj: Transition, returns, advantages, perm=None,
               h0=None):
        """``num_learning_epochs`` passes over the buffer in
        ``num_mini_batches`` minibatches.  ``perm``: the permutation of the
        flattened (T * N) samples; drawn from the PPO generator when None.
        ``h0``: with windowed histories, (h_first, s0) of ``traj``'s envs from
        before the rollout (:func:`frame_stream`)."""
        a = self.args
        stream = self._stream(h0, traj.obs)
        mb, batches = self._permuted(
            (traj.obs, None if stream is not None else traj.obs_history, traj.privileged_obs,
             traj.actions, traj.values, advantages, returns, traj.log_prob, traj.mu,
             traj.sigma), perm)
        stats = []
        for _ in range(a.num_learning_epochs):
            for batch, pos in batches:
                ts, s = self._minibatch_update(ts, self._with_windows(batch, stream), pos, mb)
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
        h0 = self._h0(env_state, obs_dict)
        env_state, last_obs, traj, _, obs_rms = self.rollout(
            env_state, obs_dict, action_noise, ts.obs_rms)
        traj, last_values = self._train_part(traj, self._last_values(last_obs, obs_rms))
        returns, _ = self.compute_gae(traj, last_values)
        stream = self._stream(h0, traj.obs)
        mb, batches = self._permuted(
            (traj.obs, None if stream is not None else traj.obs_history, traj.privileged_obs,
             traj.values, returns), perm)
        params = ts.params
        v_ls = []
        for _ in range(a.num_learning_epochs):
            for batch, _ in batches:
                o, h, p, target_values, rets = self._with_windows(batch, stream)
                v_l = self._value_loss(self.ac.evaluate(o, p, h.float()), target_values, rets,
                                       self._mean(mb))
                grads = torch.autograd.grad(v_l, list(params.values()),
                                            allow_unused=True, materialize_grads=True)
                grads = [g if k.startswith("critic_body.") else torch.zeros_like(g)
                         for k, g in zip(params, grads)]
                v_l = v_l.detach()
                if self.dp:
                    *grads, v_l = all_reduce_sum(grads + [v_l])
                with torch.no_grad():
                    warmup_opt_state = adam_step(
                        params, clip_by_global_norm(grads, a.max_grad_norm),
                        warmup_opt_state, a.learning_rate)
                v_ls.append(v_l)
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
        sl = self._rows(0, self.n_train)
        return Transition(*(x[:, sl] for x in traj)), last_values[sl]

    def _h0(self, env_state, obs_dict):
        """With windowed histories, the train envs' (h_first, s0) before a
        rollout: the history the policy acts on at step 0 and the env
        state's (JAX, learn/ppo.py:617-624); None without."""
        if not self._window_history:
            return None
        sl = self._rows(0, self.n_train)
        return obs_dict["obs_history"][sl], env_state.obs_history[sl]

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
        h0 = self._h0(env_state, obs_dict) if update_model else None
        env_state, last_obs, traj, roll_metrics, obs_rms = self.rollout(
            env_state, obs_dict, action_noise, ts.obs_rms)
        traj_train, last_values = self._train_part(traj, self._last_values(last_obs, obs_rms))
        if update_model:
            returns, advantages = self.compute_gae(traj_train, last_values)
            ts, metrics = self.update(ts, traj_train, returns, advantages, perm, h0)
        else:
            z = torch.zeros((), device=self.device)
            metrics = {"value_loss": z, "surrogate_loss": z, "adaptation_loss": z,
                       "adaptation_test_loss": z, "kl_mean": z,
                       "learning_rate": ts.learning_rate}
        if self.normalize_obs:
            ts = ts._replace(obs_rms=obs_rms)

        # episodic metrics: done-masked means over the rollout window, the
        # train and eval populations apart (ppo_cse/__init__.py:137-140,200-214);
        # sums first, all-reduced once under data parallelism, then divided
        def ep_sums(sl):
            done = roll_metrics["done"][:, sl]                 # (T, n)
            dmask = done.float()
            dsum = lambda x: torch.sum(x[:, sl] * dmask)
            return [torch.sum(done),
                    torch.sum(roll_metrics["episode_sums"][:, sl] * dmask[..., None], dim=(0, 1)),
                    dsum(roll_metrics["episode_length"].float()),
                    dsum(roll_metrics["reached"].float()), dsum(roll_metrics["goal_distance"])]

        if "video" in roll_metrics:
            metrics["video"] = roll_metrics["video"]
        with torch.no_grad():
            pops = [("", (0, self.n_train))]
            if self.n_mix:
                pops.append(("frontier_", (self.n_mix, self.n_train)))
            if self.n_eval:
                pops.append(("eval_", (self.n_train, None)))
            sums = [x for _, rows in pops for x in ep_sums(self._rows(*rows))]
            if self.dp:
                rew, std, *sums = all_reduce_sum(
                    [torch.sum(traj_train.rewards), torch.sum(traj.sigma[-1])] + sums)
                metrics["mean_reward_per_step"] = rew / (traj.rewards.shape[0] * self.n_train)
                metrics["action_std_mean"] = std / (self.num_envs_global * traj.sigma.shape[-1])
            else:
                metrics["mean_reward_per_step"] = torch.mean(traj_train.rewards)
                metrics["action_std_mean"] = torch.mean(traj.sigma[-1])
            for i, (prefix, _) in enumerate(pops):
                n_eps, ep_sum, length, reached, dist = sums[5 * i:5 * i + 5]
                n_done = torch.clamp(n_eps, min=1)
                metrics[prefix + "num_episodes"] = n_eps
                metrics[prefix + "episode_sums_mean"] = ep_sum / n_done
                metrics[prefix + "episode_length_mean"] = length / n_done
                metrics[prefix + "reached_mean"] = reached / n_done
                metrics[prefix + "goal_distance_mean"] = dist / n_done
        return ts, env_state, last_obs, metrics

    # ------------------------------------------------------------ policies
    @torch.no_grad()
    def act_inference(self, obs, obs_history):
        """Student/deployment policy (act_student, actor_critic.py:144-148)."""
        return self.ac.act_student(obs, obs_history)

    @torch.no_grad()
    def act_teacher(self, obs, privileged_obs, obs_history):
        return self.ac.act_teacher(obs, privileged_obs, obs_history)
