"""The port's training entry points on the CPU: the critic warmup against
the JAX package, the policy export against the JAX export and the numpy
deploy runtime, the Runner's checkpoints and curriculum (the cases of
tests/test_runner.py), and ``python -m legged_tracking_torch.train``."""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_support import (JaxDraws, bench_cfg, install_jax_draws, params_errors, small_cfg,
                           to_numpy)

from legged_tracking_torch import convert
from legged_tracking_torch import train as t_train
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_torch.io.checkpoint import export_policy_npz, flax_params_to_state_dict
from legged_tracking_torch.learn import ppo as t_ppo
from legged_tracking_torch.learn.runner import Runner, RunnerArgs
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.deploy.policy_runtime import PolicyRuntime
from legged_tracking_tpu.envs import LeggedEnv as JEnv
from legged_tracking_tpu.io.checkpoint import export_policy_npz as j_export_policy_npz
from legged_tracking_tpu.learn import ppo as j_ppo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_warmup_iteration_matches():
    """A critic-only warmup iteration (4-step rollout, 2 epochs x 2
    minibatches) against the jitted JAX one, with the JAX env's draws,
    action normals and permutation: everything outside critic_body stays
    bitwise as it was, on both sides; the critic moves as JAX's does (read:
    rms error of each leaf within 8.1e-5 of the distance it moved, no
    element more than 1e-4 apart, the value loss within 1.5e-7 relative;
    limits 7 to 10 times that, and at most 2e-6 of the elements over
    1e-4)."""
    T, N = 4, 8
    jenv = JEnv(small_cfg(Cfg, config_go1, num_envs=N), seed=3)
    tenv = TEnv(small_cfg(TCfg, t_config_go1, num_envs=N), seed=3, device="cpu")
    args = dict(num_steps_per_env=T, num_mini_batches=2, num_learning_epochs=2)
    jalg = j_ppo.PPO(jenv, args=j_ppo.PPOArgs(**args))
    talg = t_ppo.PPO(tenv, args=t_ppo.PPOArgs(**args))
    jts = jalg.init(jax.random.key(0))
    jts_np = jax.tree.map(np.asarray, jts)
    tts = convert.train_state_from_numpy(jts_np, talg, device="cpu")
    key = jax.random.key(5)
    jstate = jenv._reset_jit(key, True)
    jobs = jenv._observe_jit(jstate)
    wkey = jax.random.key(7)
    k_roll, k_update = jax.random.split(wkey)
    noise = np.stack([np.asarray(jax.random.normal(k, (N, jenv.num_actions)))
                      for k in jax.random.split(k_roll, T)])
    perm = np.asarray(jax.random.permutation(k_update, T * N))

    install_jax_draws(tenv, JaxDraws(key, N))
    try:
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
        tts2, _, _, tm, _ = talg.warmup_iteration(
            tts, tstate, tenv.observe(tstate), talg.warmup_init(),
            action_noise=torch.as_tensor(noise), perm=torch.as_tensor(perm))
    finally:
        del tenv.draw, tenv.step_fn
    wopt = jax.tree.map(jax.numpy.asarray, jalg.warmup_tx.init(jts.params))
    jts2, _, _, jm, _ = jalg.warmup_iteration_jit(jts, jstate, jobs, wkey, wopt)

    got = convert.state_dict_to_flax_params(tts2.params)["params"]
    want = jax.tree.map(np.asarray, jts2.params)["params"]
    start = jts_np.params["params"]
    for name in got:
        if name != "critic_body":
            for a, b, c in zip(jax.tree.leaves(got[name]), jax.tree.leaves(want[name]),
                               jax.tree.leaves(start[name])):
                np.testing.assert_array_equal(a, c, err_msg=name)
                np.testing.assert_array_equal(b, c, err_msg=name)
    errs = params_errors(got["critic_body"], want["critic_body"], start["critic_body"])
    vl = float(jm["value_loss"])
    errs["value_loss"] = abs(float(tm["value_loss"]) - vl) / max(abs(vl), 1.0)
    tol = {"leaf_rms_rel": 1e-3, "frac_over_1e-4": 2e-6, "value_loss": 1e-6}
    assert all(errs[k] <= tol[k] for k in tol), errs


def test_export_policy_npz_matches_jax_and_runtime(tmp_path):
    """export_policy_npz writes the JAX export's keys, shapes and values
    for the same parameters, and deploy/policy_runtime.py run on the
    port's file gives the port's act_student actions (float32 numpy
    against torch: atol 1e-5)."""
    tenv = TEnv(bench_cfg(TCfg, t_config_go1), seed=3, device="cpu")
    talg = t_ppo.PPO(tenv)
    sd = {k: v.detach() for k, v in talg.ac.state_dict().items()}
    meta = {"num_obs": tenv.num_obs, "num_actions": tenv.num_actions}
    ours = dict(np.load(export_policy_npz(str(tmp_path / "port.npz"), sd, meta=meta)))
    theirs = dict(np.load(j_export_policy_npz(str(tmp_path / "jax.npz"),
                                              convert.state_dict_to_flax_params(sd),
                                              meta=meta)))
    assert sorted(ours) == sorted(theirs)
    assert "params/actor_body/Dense_0/kernel" in ours and "__meta__/num_obs" in ours
    assert ours["params/actor_body/Dense_0/kernel"].shape == (
        tenv.num_obs_history + tenv.num_privileged_obs, 512)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)

    rng = np.random.RandomState(0)
    hist = rng.normal(size=(5, tenv.num_obs_history)).astype(np.float32)
    obs = rng.normal(size=(5, tenv.num_obs)).astype(np.float32)
    actions = PolicyRuntime(str(tmp_path / "port.npz"))(hist)
    want = talg.act_inference(torch.as_tensor(obs), torch.as_tensor(hist)).numpy()
    np.testing.assert_allclose(actions, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ runner
def plane_env(num_envs=8):
    """tests/test_runner.py's env: plane, P control, 2 s episodes (and a
    3-frame history)."""
    cfg = t_config_go1(TCfg())
    cfg.env.num_observation_history = 3
    cfg.env.num_envs = num_envs
    cfg.terrain.mesh_type = "plane"
    cfg.env.command_type = "xy"
    cfg.terrain.measure_front_half = True
    cfg.control.control_type = "P"
    cfg.env.episode_length_s = 2.0
    cfg.control.decimation = 2
    return TEnv(cfg, device="cpu")


def make_runner(env, logdir=None, resume="", save_interval=400):
    return Runner(env, runner_args=RunnerArgs(num_steps_per_env=4, log_freq=1, resume=resume,
                                              save_interval=save_interval),
                  ppo_args=t_ppo.PPOArgs(num_steps_per_env=4, num_mini_batches=2,
                                         num_learning_epochs=1),
                  logdir=logdir, seed=3)


def params_np(ts):
    return {k: v.detach().numpy().copy() for k, v in ts.params.items()}


def test_save_restores_opt_state_and_curriculum(tmp_path):
    """Parameters, both Adam states, the learning rate, the iteration and
    the curriculum distance go through a checkpoint bitwise, and the
    resumed runner trains on (tests/test_runner.py's case)."""
    r1 = make_runner(plane_env(), logdir=str(tmp_path))
    r1.learn(3, verbose=False)
    r1.env_state = r1.env_state._replace(target_dist=torch.tensor(1.25))
    path = str(tmp_path / "ck.pkl")
    r1.save(path)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    leaves = jax.tree.leaves(ckpt)
    assert all(isinstance(x, (np.ndarray, float, int)) for x in leaves)

    r2 = make_runner(plane_env(), resume=path)
    a, b = r1.train_state, r2.train_state
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    moments_nonzero = False
    for sa, sb in ((a.opt_state, b.opt_state), (a.adapt_opt_state, b.adapt_opt_state)):
        assert sa.count == sb.count == 6        # 3 iterations x 2 minibatches
        for k in sa.mu:
            assert torch.equal(sa.mu[k], sb.mu[k]) and torch.equal(sa.nu[k], sb.nu[k]), k
            moments_nonzero |= bool(sa.mu[k].abs().sum() > 0)
    assert moments_nonzero
    assert float(b.learning_rate) == float(a.learning_rate)
    assert b.iteration == a.iteration == 3
    assert float(r2.env_state.target_dist) == 1.25
    hist = r2.learn(2, verbose=False)
    assert np.isfinite(hist[-1]["value_loss"])


def test_restore_best_on_downstep():
    """cl_restore_best_on_downstep: a window collapse at the start distance
    eases nothing and restores nothing; at an advanced distance it steps
    the distance back and restores the best snapshot (tests/test_runner.py's
    case, 0.6 not float32-representable included)."""
    env = plane_env()
    ct = env.cfg.curriculum_thresholds
    ct.cl_fix_target = True
    ct.cl_start_target_dist = 0.6
    ct.cl_goal_target_dist = 3.6
    ct.cl_switch_delta = 0.5
    ct.cl_switch_threshold = 1.1          # advance can never fire
    ct.cl_downstep_threshold = 0.5
    ct.cl_restore_best_on_downstep = True
    r = make_runner(env)
    r.learn(2, verbose=False)
    assert r._best_train_state is not None
    r._best_score = (99.0, 1.0)
    best = params_np(r._best_train_state)
    best_it = r._best_train_state.iteration

    r.learn(2, verbose=False)
    assert any(np.any(v != best[k]) for k, v in params_np(r.train_state).items())
    assert abs(float(r.env_state.target_dist) - 0.6) < 1e-6
    r._reached_window.extend([0.0] * 4000)
    r.learn(1, verbose=False)
    assert r._restore_count == 0

    r.env_state = r.env_state._replace(target_dist=torch.tensor(1.1))
    r._reached_window.extend([0.0] * 4000)
    r.learn(1, verbose=False)
    assert r._restore_count == 1
    assert r.history[-1]["restored_best_total"] == 1
    assert abs(float(r.env_state.target_dist) - 0.6) < 1e-6
    for k, v in params_np(r.train_state).items():
        np.testing.assert_array_equal(v, best[k], err_msg=k)
    # the module itself acts with the restored parameters, and, as in the
    # JAX package, the iteration counter goes back with the snapshot
    assert r.train_state.params["std"] is r.alg.ac.std
    assert r.train_state.iteration == best_it
    hist = r.learn(1, verbose=False)
    assert np.isfinite(hist[-1]["value_loss"])


def test_best_checkpoint_file_is_the_snapshot(tmp_path):
    """ac_weights_best.pkl holds the best-score snapshot taken at its log
    iteration, not the state at the save iteration; best.json names it."""
    env = plane_env()
    env.cfg.curriculum_thresholds.cl_fix_target = True
    r = make_runner(env, logdir=str(tmp_path), save_interval=2)
    r.learn(2, verbose=False)
    r._best_score = (99.0, 1.0)
    best = params_np(r._best_train_state)
    r._best_dirty = True
    r.learn(3, verbose=False)
    with open(tmp_path / "ac_weights_best.pkl", "rb") as f:
        ckpt = pickle.load(f)
    saved = flax_params_to_state_dict(ckpt["params"])
    for k, v in best.items():
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)
    assert any(np.any(v != best[k]) for k, v in params_np(r.train_state).items())
    with open(tmp_path / "best.json") as f:
        assert json.load(f)["restores"] == 0


def test_freeze_model_rolls_out_without_updating():
    """update_model=False: parameters and Adam states untouched, episodic
    metrics still logged."""
    r = make_runner(plane_env())
    before = params_np(r.train_state)
    r.learn(2, verbose=False, update_model=False)
    for k, v in params_np(r.train_state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert r.train_state.opt_state.count == 0 and r.train_state.iteration == 0
    assert r.history and r.history[-1]["value_loss"] == 0.0
    assert np.isfinite(r.history[-1]["episode_length_mean"])


@pytest.mark.parametrize("kwargs,need", [({"num_devices": 2}, "of world size 2"),
                                         ({"distributed": True}, "")])
def test_runner_refuses_what_is_not_ported(kwargs, need):
    """Data parallelism is ported (A13, tests/test_torch_parallel.py runs it
    over two ranks): without a process group to run in, num_devices and
    distributed raise, naming the group they need."""
    with pytest.raises(RuntimeError, match="needs a process group " + need):
        Runner(plane_env(), **kwargs)


# ------------------------------------------------------------- train entry
def test_train_entry_on_cpu(tmp_path):
    """``python -m legged_tracking_torch.train --device cpu`` trains 2
    iterations of 8 envs and writes metrics.jsonl (the JAX runner's keys),
    a checkpoint that loads back, and policy.npz."""
    logdir = tmp_path / "run"
    cmd = [sys.executable, "-m", "legged_tracking_torch.train", "--device", "cpu",
           "--old_ppo", "--strategy", "e2e", "--num_envs", "8", "--iterations", "2",
           "--terrain_rows", "2", "--terrain_cols", "2", "--logdir", str(logdir)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert [r["it"] for r in recs] == [0, 1]
    for key in ("value_loss", "surrogate_loss", "adaptation_loss", "kl_mean", "learning_rate",
                "fps", "timesteps", "episode_length_mean", "reached_mean", "rew_total",
                "mean_reward_per_step", "action_std_mean"):
        assert np.isfinite(recs[-1][key]), key
    assert recs[-1]["timesteps"] == 2 * 8 * 24
    policy = np.load(logdir / "policy.npz")
    assert "params/adaptation_module/Dense_0/kernel" in policy
    with open(logdir / "ac_weights_last.pkl", "rb") as f:
        assert pickle.load(f)["iteration"] == 2


# the modules of all cases are ported: the CNN/GRU policy, the goal recipe's
# TrajectoryTrackingRewards, the planner, random_target, the DR profiles, the
# training video (A12) and data parallelism (A13)
PORTED = {"actor_critic_cnn", "TrajectoryTrackingRewards", "planner", "random_target",
          "domain_randomization_profiles", "A12", "A13"}


@pytest.mark.parametrize("flags,module", [
    ([], "actor_critic_cnn"), (["--old_ppo", "--cnn"], "actor_critic_cnn"),
    (["--old_ppo", "--strategy", "goal"], "TrajectoryTrackingRewards"),
    (["--old_ppo", "--strategy", "pms"], "planner"),
    (["--old_ppo", "--terrain", "multi_path"], "planner"),
    (["--old_ppo", "--random_target"], "random_target"),
    (["--old_ppo", "--dr_profile", "large"], "domain_randomization_profiles"),
    (["--old_ppo", "--num_devices", "4"], "A13"),
    (["--old_ppo", "--save_video_interval", "10"], "A12")])
def test_train_entry_refuses_what_is_not_ported(flags, module):
    """A flag whose module is not ported raises NotImplementedError naming
    it; a flag whose module is ported passes the check."""
    args = t_train.parse_args(flags + ["--device", "cpu"])
    if module in PORTED:
        t_train.check_supported(args)
        return
    with pytest.raises(NotImplementedError, match=module):
        t_train.main(args)


def test_velocity_entry_refuses_what_is_not_ported():
    """The velocity entry's --num_devices is ported (A13): the flag passes
    the check, as the entry's defaults do."""
    from legged_tracking_torch import train_velocity_tracking as t_tv
    t_tv.check_supported(t_tv.parse_args(["--device", "cpu", "--num_devices", "4"]))
    t_tv.check_supported(t_tv.parse_args(["--device", "cpu"]))
