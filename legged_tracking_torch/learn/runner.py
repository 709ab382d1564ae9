"""Training runner: the host loop around ``PPO.train_iteration`` (port of
``learn/runner.py``, the single-device ``Runner``).

Mirrors the reference Runner (go1_gym_learn/ppo_cse/__init__.py:66-345):
``learn`` drives iterations, logs episodic metrics and fps to
``metrics.jsonl``, checkpoints every ``save_interval`` iterations, keeps a
best-score snapshot, and applies the fix-target curriculum
(update_curriculum, legged_robot_trajectory_tracking.py:186-196) from the
reached statistics of each iteration.

Checkpoints are pickles of numpy leaves only: the parameters as the JAX
package's checkpoints hold them (the flax tree, :mod:`..io.checkpoint`),
the learning rate, the iteration, the curriculum state and the obs
normalizer under the JAX keys, and both Adam states (moments as flax trees)
under keys of their own, ``adam_state`` and ``adapt_adam_state``.  So the
JAX Runner resumes a port checkpoint (with fresh Adam moments, its fallback
for a checkpoint without ``opt_state``), and the port resumes a JAX one,
its optax states included, without importing JAX.  ``policy.npz`` has
the JAX package's deployment layout.  With ``save_video_interval`` the
rollout records env0's frames and the runner renders them to
``videos/train_it*.mp4`` (:mod:`..io.render`).  The runner is held against the JAX package,
so it keeps that package's runner behaviour, the four faults ADVICE.md
lists included (ROADMAP.md §C).

Data parallelism (``num_devices`` K > 1, or ``distributed``) runs one Runner
per rank of an initialized process group (:mod:`..parallel.distributed`):
the env becomes the rank's shard of its envs, every rank builds the same
parameters from the shared seed (checked equal at start; a policy of the
caller's is given as a function that builds it, which the Runner calls
where it draws from that seed), PPO all-reduces
what it reduces, so the metrics and the curriculum decisions are global and
alike on every rank, and only rank 0 writes ``parameters.pkl``,
``metrics.jsonl``, checkpoints, the best snapshot and ``policy.npz`` (the
JAX runner's process 0).  The training video is off in such a run.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..io.checkpoint import (adam_from_checkpoint, adam_to_checkpoint, export_policy_npz,
                             flax_params_to_state_dict, load_pickle, state_dict_to_flax_params)
from .actor_critic import ACArgs
from ..parallel import Shard, check_replicated
from .metrics_caches import DistCache, SlotCache
from .ppo import PPO, PPOArgs, copy_state
from .utils import RunningMeanStd


@dataclass
class RunnerArgs:
    """RunnerArgs parity (ppo_cse/__init__.py:47-64)."""
    num_steps_per_env: int = 24
    save_interval: int = 400
    log_freq: int = 10
    resume: str = ""
    resume_curriculum: bool = True
    # training-time video of env0 every N iterations (reference
    # ppo_cse/__init__.py:58, :322-345); 0 disables
    save_video_interval: int = 0
    video_frames: int = 250
    # critic-only warmup iterations after a resume, before any policy
    # gradient flows (resume-shock mitigation); 0 disables
    critic_warmup_iters: int = 0


class Runner:
    def __init__(self, env, runner_args: RunnerArgs | None = None,
                 ppo_args: PPOArgs | None = None, ac_args: ACArgs | None = None,
                 logdir: str | None = None, log_wandb: bool = False, seed: int = 1,
                 ac=None, num_devices: int | None = None, distributed: bool = False):
        self.distributed = distributed or (num_devices is not None and num_devices > 1)
        self.rank = 0
        if self.distributed:
            self.rank = self._join_shard(env, None if distributed else num_devices)
            if self.rank != 0:
                # host-side artifacts are rank 0's (JAX runner.py:72-78)
                logdir, log_wandb = None, False
        self.env = env
        self.runner_args = runner_args or RunnerArgs()
        ppo_args = ppo_args or PPOArgs()
        ppo_args.num_steps_per_env = self.runner_args.num_steps_per_env
        self.device = env.device
        # one seed each for the parameters, the env's draws and the action
        # noise, as the JAX runner splits one key
        s_init, s_env, s_act = (int(s) for s in np.random.SeedSequence(seed).generate_state(3))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(s_init)
            if callable(ac) and not isinstance(ac, torch.nn.Module):
                ac = ac()       # a policy factory draws from the seed, as JAX's init key
            self.alg = PPO(env, ac_args=ac_args, args=ppo_args, ac=ac, seed=s_act)
        if self.distributed and dist.get_world_size() > 1:
            check_replicated(self.alg.ac.state_dict())
        # env0's frames are recorded only for the training video, which is
        # off under data parallelism (env0 is rank 0's; JAX runner.py:291-293)
        self.alg.record_video = (self.runner_args.save_video_interval > 0 and bool(logdir)
                                 and not self.distributed)
        self._video_buf = []
        self.logdir = logdir
        self.log_wandb = log_wandb
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            # config snapshot (parameters.pkl analogue, ppo_cse/__init__.py:81-84)
            with open(os.path.join(logdir, "parameters.pkl"), "wb") as f:
                pickle.dump(env.cfg, f)

        self.env_state = None
        self._pending_curriculum = self._pending_target_dist = None
        self.train_state = self.alg.init()
        if self.runner_args.resume:
            self.load(self.runner_args.resume)
        env.generator.manual_seed(s_env)
        self.env_state = env.reset_fn(True)
        if (self._pending_curriculum is not None
                and getattr(self.env_state, "curriculum_weights", None) is not None):
            self.env_state = self.env_state._replace(
                curriculum_weights=self._rep(self._pending_curriculum))
        if self._pending_target_dist is not None:
            # resume fix-target curriculum progress (goal distance)
            self.env_state = self.env_state._replace(
                target_dist=self._rep(self._pending_target_dist))
        self.obs_dict = env.observe(self.env_state)
        self.tot_timesteps = 0
        self._reached_window = deque(maxlen=4000)
        # curriculum telemetry caches (reference ppo/metrics_caches.py)
        self._dist_cache = DistCache()
        self._slot_cache = None
        cats = getattr(env, "category_names", None)
        if cats:
            self._slot_cache = SlotCache(len(cats))
        self.history = []
        # in-memory best-score snapshot (cl_restore_best_on_downstep and
        # ac_weights_best.pkl): a deep copy, since the update changes the
        # live parameters in place
        self._best_score = (-1.0, -1.0)
        self._best_train_state = None
        self._best_it = -1
        self._best_target_dist = 0.0
        self._best_dirty = False
        self._restore_count = 0
        self._its_since_switch = 0

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _join_shard(env, world: int | None) -> int:
        """Make ``env`` this rank's shard of its envs (unless it is one
        already) in the initialized process group, of world size ``world``
        when given; returns the rank."""
        if not dist.is_initialized():
            need = f"of world size {world}" if world else "(parallel.init_distributed)"
            raise RuntimeError(f"data parallelism needs a process group {need}; none is "
                               f"initialized")
        rank, size = dist.get_rank(), dist.get_world_size()
        if world is not None and size != world:
            raise RuntimeError(f"num_devices={world} needs a process group of world size "
                               f"{world}, not {size}")
        if env.shard is None:
            env.set_shard(Shard(rank, size, env.num_envs))
        elif (env.shard.rank, env.shard.world) != (rank, size):
            raise ValueError(f"the env is shard {env.shard.rank} of {env.shard.world}, the "
                             f"process is rank {rank} of {size}")
        return rank

    def _rep(self, x):
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def _restore(self, snapshot):
        """Make ``snapshot`` the training state: its parameters are copied
        into the module's, everything else is a fresh copy (the iteration
        goes back to the snapshot's, as in the JAX package)."""
        params = self.train_state.params
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(snapshot.params[k])
        self.train_state = copy_state(snapshot)._replace(params=params)

    # ------------------------------------------------------------------ io
    def save(self, path: str, train_state=None, target_dist=None):
        """Pickle a checkpoint of numpy leaves.  train_state/target_dist
        default to the current state; the best checkpoint passes its
        snapshot (and that snapshot's curriculum distance) instead."""
        ts = self.train_state if train_state is None else train_state
        if target_dist is None:
            target_dist = (float(self.env_state.target_dist)
                           if self.env_state is not None else 0.0)
        ckpt = {
            "params": state_dict_to_flax_params(ts.params),
            "adam_state": adam_to_checkpoint(ts.opt_state),
            "adapt_adam_state": adam_to_checkpoint(ts.adapt_opt_state),
            "learning_rate": float(ts.learning_rate),
            "iteration": int(ts.iteration),
            "target_dist": float(target_dist),
        }
        # command-curriculum state (reference ppo_cse/__init__.py:224-239)
        if getattr(self.env_state, "curriculum_weights", None) is not None:
            ckpt["curriculum_weights"] = self.env_state.curriculum_weights.cpu().numpy()
        if ts.obs_rms is not None:
            ckpt["obs_rms"] = {k: v.cpu().numpy() for k, v in ts.obs_rms._asdict().items()}
        with open(path, "wb") as f:
            pickle.dump(ckpt, f)

    def load(self, path: str):
        """Resume from a checkpoint of either package's Runner (read
        without JAX, :func:`..io.checkpoint.load_pickle`)."""
        ckpt = load_pickle(path)
        ts = self.train_state
        saved = flax_params_to_state_dict(ckpt["params"])
        with torch.no_grad():
            for k, p in ts.params.items():
                p.copy_(saved[k])
        ts = ts._replace(learning_rate=self._rep(ckpt["learning_rate"]),
                         iteration=int(ckpt["iteration"]))
        if "obs_rms" in ckpt and ts.obs_rms is not None:
            ts = ts._replace(obs_rms=RunningMeanStd(
                **{k: self._rep(v) for k, v in ckpt["obs_rms"].items()}))
        resume_cl = self.runner_args.resume_curriculum
        self._pending_curriculum = ckpt.get("curriculum_weights") if resume_cl else None
        self._pending_target_dist = ckpt.get("target_dist") if resume_cl else None
        # Adam moments and the adaptation optimizer resume too (reference
        # ppo_cse/__init__.py:97-104): the port's own, or the optax states of
        # a JAX checkpoint; checkpoints without them keep fresh ones
        for key, opt, adapt in (("adam_state", "opt_state", "adapt_opt_state"),
                                ("opt_state", "opt_state", "adapt_opt_state")):
            if key in ckpt:
                ts = ts._replace(**{opt: adam_from_checkpoint(ckpt[key], self.device),
                                    adapt: adam_from_checkpoint(ckpt["adapt_" + key],
                                                                self.device)})
                break
        self.train_state = ts

    # ----------------------------------------------------------------- loop
    def learn(self, num_learning_iterations: int, verbose: bool = True,
              profile_dir: str | None = None, update_model: bool = True):
        """Drive training iterations.

        profile_dir: a torch.profiler trace of iterations 10-12 is written
        there (``trace.json``, and the kernel table).  update_model=False
        rolls out without updating (reference --freeze_model): episodic
        metrics log as usual; the update, the curriculum and the periodic
        checkpoints are skipped."""
        env = self.env
        cfg = env.cfg
        ct = cfg.curriculum_thresholds
        t0 = time.time()
        # timesteps and fps count the global envs
        steps_per_iter = self.alg.num_envs_global * self.alg.args.num_steps_per_env
        verbose = verbose and self.rank == 0
        profile_dir = profile_dir if self.rank == 0 else None
        # critic-only warmup after a resume (resume-shock mitigation)
        wi = self.runner_args.critic_warmup_iters
        if wi > 0 and self.runner_args.resume:
            wopt = self.alg.warmup_init()
            for w in range(wi):
                (self.train_state, self.env_state, self.obs_dict, wm,
                 wopt) = self.alg.warmup_iteration(self.train_state, self.env_state,
                                                   self.obs_dict, wopt)
                self.tot_timesteps += steps_per_iter
                if verbose and (w % self.runner_args.log_freq == 0 or w == wi - 1):
                    print(f"warmup {w:4d} | vloss {float(wm['value_loss']):.4f}")
        prof = None
        for it in range(num_learning_iterations):
            if profile_dir and it == 10:
                prof = self._start_profile()
            if prof is not None and it == 13:
                self._stop_profile(prof, profile_dir)
                prof = None
            self.train_state, self.env_state, self.obs_dict, metrics = \
                self.alg.train_iteration(self.train_state, self.env_state, self.obs_dict,
                                         update_model=update_model)
            self.tot_timesteps += steps_per_iter

            video = metrics.pop("video", None)
            vint = self.runner_args.save_video_interval
            if vint and video is not None:
                # env0's (T, .) frames stay on the device until a video
                # iteration renders the trailing video_frames of them
                keep = max(self.runner_args.video_frames // self.alg.args.num_steps_per_env
                           + 1, 1)
                self._video_buf = (self._video_buf + [video])[-keep:]
                if it % vint == 0 and it > 0:
                    self._write_training_video(it)

            # fix-target curriculum (reference update_curriculum, :186-196),
            # fed every iteration: the reference pushes each episode's
            # outcome into a 4000-deep window at reset time
            if ct.cl_fix_target and update_model:
                # with rehearsal mixing (cl_dist_mix) the gate reads the
                # frontier slice only
                n_eps = int(metrics.get("frontier_num_episodes", metrics["num_episodes"]))
                reach = float(metrics.get("frontier_reached_mean", metrics["reached_mean"]))
                if n_eps > 0:
                    self._reached_window.extend([reach] * n_eps)
                    self._dist_cache.log(reached=reach, episodes_per_iter=float(n_eps))
                down = getattr(ct, "cl_downstep_threshold", 0.0)
                probe = int(getattr(ct, "cl_stagnation_probe", 0))
                self._its_since_switch += 1
                win_full = len(self._reached_window) >= 4000
                win_mean = np.mean(self._reached_window) if self._reached_window else 0.0
                if win_full and win_mean > ct.cl_switch_threshold:
                    new_dist = min(float(self.env_state.target_dist) + ct.cl_switch_delta,
                                   ct.cl_goal_target_dist)
                    self.env_state = self.env_state._replace(target_dist=self._rep(new_dist))
                    self._reached_window.clear()
                    self._its_since_switch = 0
                elif down > 0.0 and win_full and win_mean < down:
                    # ease the task before the sparse-reward signal dies
                    cur_dist = float(self.env_state.target_dist)
                    new_dist = max(cur_dist - ct.cl_switch_delta, ct.cl_start_target_dist)
                    self.env_state = self.env_state._replace(target_dist=self._rep(new_dist))
                    self._reached_window.clear()
                    self._its_since_switch = 0
                    # restore the best snapshot on a real downstep (the
                    # distance eased by more than the float32 round trip of
                    # the start distance, 1e-4) from a snapshot whose own
                    # window cleared the downstep bar
                    if (getattr(ct, "cl_restore_best_on_downstep", False)
                            and self._best_train_state is not None
                            and new_dist < cur_dist - 1e-4
                            and self._best_score[1] >= down):
                        self._restore(self._best_train_state)
                        self._restore_count += 1
                elif (probe > 0 and win_full
                      and win_mean >= max(down, ct.cl_switch_threshold - 0.1)
                      and self._its_since_switch >= probe):
                    # stagnation probe: advance anyway, from strength only
                    new_dist = min(float(self.env_state.target_dist) + ct.cl_switch_delta,
                                   ct.cl_goal_target_dist)
                    self.env_state = self.env_state._replace(target_dist=self._rep(new_dist))
                    self._reached_window.clear()
                    self._its_since_switch = 0

            if (it % self.runner_args.log_freq == 0) or it == num_learning_iterations - 1:
                self._log(it, metrics, t0, update_model, verbose)

            if (self.logdir and update_model
                    and (it % self.runner_args.save_interval == 0) and it > 0):
                self.save(os.path.join(self.logdir, f"ac_weights_{it:06d}.pkl"))
                self.save(os.path.join(self.logdir, "ac_weights_last.pkl"))
                # the best file holds the snapshot, which may be older than
                # the current state
                if self._best_dirty and self._best_train_state is not None:
                    self._best_dirty = False
                    self.save(os.path.join(self.logdir, "ac_weights_best.pkl"),
                              train_state=self._best_train_state,
                              target_dist=self._best_target_dist)
                    with open(os.path.join(self.logdir, "best.json"), "w") as f:
                        json.dump({"it": self._best_it,
                                   "target_dist": self._best_score[0],
                                   "window_reached": self._best_score[1],
                                   "restores": self._restore_count}, f)
        if prof is not None:
            self._stop_profile(prof, profile_dir)

        if self.logdir:
            self.save(os.path.join(self.logdir, "ac_weights_last.pkl"))
            # deployment export (policy.npz, the numpy runtime on the robot)
            export_policy_npz(os.path.join(self.logdir, "policy.npz"),
                              {k: v.detach() for k, v in self.train_state.params.items()})
        return self.history

    def _log(self, it, metrics, t0, update_model, verbose):
        """One metrics.jsonl record (the JAX runner's keys), and the
        best-score snapshot."""
        env = self.env
        m = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        fps = self.tot_timesteps / (time.time() - t0)
        ep_means = dict(zip(["rew_" + n for n in env.metric_names], m.pop("episode_sums_mean")))
        for prefix in ("eval_", "frontier_"):
            # the held-out eval population, and the frontier slice of a
            # rehearsal-mix run
            if prefix + "episode_sums_mean" in m:
                ep_means.update(zip([prefix + "rew_" + n for n in env.metric_names],
                                    m.pop(prefix + "episode_sums_mean")))
        rec = {k: float(v) for k, v in m.items()}
        rec.update({k: float(v) for k, v in ep_means.items()})
        rec.update({"it": it, "fps": fps, "timesteps": self.tot_timesteps})
        if env.cfg.curriculum_thresholds.cl_fix_target:
            rec["target_dist"] = float(self.env_state.target_dist)
            rec["restored_best_total"] = self._restore_count
        for k, v in self._dist_cache.get_summary().items():
            rec["window_" + k] = float(v)
        if getattr(self.env_state, "curriculum_weights", None) is not None:
            w = self.env_state.curriculum_weights.cpu().numpy()
            rec["curriculum_unlocked_frac"] = float((w > 0).mean())
            rec["curriculum_weight_mean"] = float(w.mean())
            if self._slot_cache is not None:
                self._slot_cache.log(unlocked_frac=(w > 0).mean(axis=1),
                                     weight_mean=w.mean(axis=1))
                for k, v in self._slot_cache.get_summary().items():
                    for ci, cname in enumerate(env.category_names):
                        rec[f"curriculum_{k}_{cname}"] = float(v[ci])
        self.history.append(rec)
        # best-score snapshot on every log; ranked by distance only once
        # the window clears 0.7
        if update_model:
            win = rec.get("window_reached", rec.get("reached_mean"))
            if win is not None:
                td = rec.get("target_dist", 0.0)
                score = (td if float(win) >= 0.7 else 0.0, float(win))
                if score > self._best_score:
                    self._best_score = score
                    self._best_train_state = copy_state(self.train_state)
                    self._best_it = it
                    self._best_target_dist = td
                    self._best_dirty = True
        if verbose:
            print(f"it {it:5d} | fps {fps:9.0f} | rew {rec.get('rew_total', 0):8.3f} | "
                  f"eplen {rec['episode_length_mean']:7.1f} | "
                  f"reached {rec['reached_mean']:.3f} | "
                  f"vloss {rec['value_loss']:.4f} | lr {rec['learning_rate']:.2e}")
        if self.log_wandb:
            import wandb
            wandb.log(rec, step=it)
        if self.logdir:
            with open(os.path.join(self.logdir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")

    # ---------------------------------------------------------------- video
    def _write_training_video(self, it: int):
        """Render the buffered env0 frames to ``videos/train_it*.mp4`` (the
        reference's training-time video, ppo_cse/__init__.py:322-345).  A
        failed render is printed and training goes on."""
        from ..io.render import render_frames, write_mp4
        buf = {k: torch.cat([c[k] for c in self._video_buf]).cpu().numpy()
               for k in ("base_pos", "base_quat", "qj")}
        frames = [{k: v[None, t] for k, v in buf.items()}
                  for t in range(len(buf["base_pos"]))][-self.runner_args.video_frames:]
        if not frames:
            return
        outdir = os.path.join(self.logdir, "videos")
        os.makedirs(outdir, exist_ok=True)
        tile = int(self.env.terrain.env_tile[0])
        try:
            path = write_mp4(render_frames(frames, self.env.terrain, tile_idx=tile),
                             os.path.join(outdir, f"train_it{it:06d}.mp4"))
            if self.log_wandb:
                import wandb
                wandb.log({"train_video": wandb.Video(path)}, step=it)
        except Exception as e:  # a training-run artifact: never stops training
            print(f"training-video render failed at it {it}: {e}")

    # --------------------------------------------------------------- export
    def get_inference_policy(self):
        """The student policy as a function of (obs, obs_history): a closure
        around ``act_inference``, which runs without gradients (reference
        learn/runner.py:535-538)."""
        alg = self.alg
        return lambda obs, obs_history: alg.act_inference(obs, obs_history.float())

    # ------------------------------------------------------------ profiling
    def _start_profile(self):
        from torch.profiler import ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, profile_dir):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        with open(os.path.join(profile_dir, "kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
        print(f"profiler trace written to {profile_dir}")

