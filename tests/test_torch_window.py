"""Windowed rollout histories (``PPOArgs.windowed_history``) in the port's PPO.

With windowing on, the rollout stores no history rows and the update cuts
every minibatch's K-frame windows from each env's frame stream.  The rows
are the stored ones bit for bit, so a windowed train iteration equals a
stored one at atol 0: across the auto-resets of 3-step episodes, from an
iteration started by the Runner's ``observe`` and from one started by a
step, with eval envs, the cheap shuffle, the velocity env's RMA policy,
the goal recipe's ``ActorCriticCNN`` and the planner stack.  Under ``normalize_obs`` windowing
turns itself off, as in the JAX package.  ``window_histories`` is held
bitwise against the JAX ``PPO._window_histories``, and one windowed
``train_iteration`` against the jitted JAX one at ``test_torch_ppo.py``'s
bars.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import JaxDraws, bench_cfg, install, to_numpy
from test_torch_ppo import HISTORY, METRICS, iteration_cfg, max_err, params_errors, tree_rel_err
from torch.overrides import TorchFunctionMode

from legged_tracking_torch import convert
from legged_tracking_torch import train as t_train
from legged_tracking_torch import train_hierarchy as t_th
from legged_tracking_torch import train_velocity_tracking as t_tv
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv
from legged_tracking_torch.learn import ppo as t_ppo
from legged_tracking_torch.learn.actor_critic import ACArgs
from legged_tracking_torch.learn.actor_critic_rma import ActorCriticRMA
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.envs import LeggedEnv as JEnv
from legged_tracking_tpu.learn import ppo as j_ppo

N = 8
# 4 steps of 3-step episodes: auto-resets inside each rollout, and windows
# that reach into the state's history (t < K) and a window of the rollout's
# frames alone (t = 3) at K = HISTORY = 3
T = 4
# 2 epochs x 2 minibatches: each minibatch's windows gathered twice
PPO_KW = dict(num_steps_per_env=T, num_learning_epochs=2, num_mini_batches=2)


def short_steps(cfg):
    """One physics substep a control step (the windows do not depend on the
    physics; it keeps the CPU work and the JAX compile small) and episodes
    of 3 control steps.  Returns ``cfg``."""
    cfg.control.decimation = 1
    cfg.env.episode_length_s = 3 * cfg.sim.dt
    return cfg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port runs single-threaded beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ window_histories
@pytest.mark.parametrize("start", ["observe", "step"])
def test_window_histories_match_jax(start):
    """``window_histories`` of every (t, n) sample, in a permuted order,
    against the JAX ``_window_histories`` (its ``lax.gather``, jitted) and
    against the rows the env would have stored (each step appends its
    frame, cast to bf16, to the state's history), atol 0.  After
    ``observe`` the acting history at step 0 holds f_0, which the state
    never stores; after a step it is the state's own row."""
    K, no, T_, n = 4, 7, 6, 5
    rng = np.random.RandomState(0)
    bf = lambda x: torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16)
    frames = torch.as_tensor(rng.normal(size=(T_, n, no)).astype(np.float32))
    s0 = bf(rng.normal(size=(n, K * no)))
    if start == "observe":
        h_first = torch.cat([s0[:, no:], frames[0].to(torch.bfloat16)], dim=1)
    else:
        frames[0] = s0[:, -no:].float()
        h_first = s0
    stored, state = [h_first], s0
    for t in range(1, T_):
        state = torch.cat([state[:, no:], frames[t].to(torch.bfloat16)], dim=1)
        stored.append(state)
    stored = torch.stack(stored).reshape(T_ * n, K * no)
    perm = torch.as_tensor(rng.permutation(T_ * n))

    got = t_ppo.window_histories(h_first, s0, frames, perm // n, perm % n, K, no)
    assert got.dtype == torch.bfloat16 and got.shape == (T_ * n, K * no)
    torch.testing.assert_close(got, stored[perm], rtol=0, atol=0)

    stub = types.SimpleNamespace(env=types.SimpleNamespace(num_obs=no))
    j = lambda x: jnp.asarray(x.float().numpy(),
                              jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    want = jax.jit(lambda h, s, f, p: j_ppo.PPO._window_histories(stub, h, s, f, p, n))(
        j(h_first), j(s0), j(frames), jnp.asarray(perm.numpy(), jnp.int32))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ----------------------------------------------------- windowed vs stored
def bench_env():
    cfg = bench_cfg(TCfg, t_config_go1, num_envs=N)
    cfg.env.num_observation_history = HISTORY
    return TEnv(short_steps(cfg), seed=3, device="cpu")


def eval_env():
    """Two eval envs and rehearsal mixing (the frontier_* metrics)."""
    return TEnv(short_steps(iteration_cfg(TCfg, t_config_go1, 2)), seed=3, device="cpu")


def velocity_env():
    """The velocity entry's configuration at 8 envs, its 30-frame history of
    70, commands resampled every 2 steps."""
    cfg = t_tv.build_cfg(t_tv.parse_args(["--num_envs", str(N), "--terrain_rows", "2",
                                          "--terrain_cols", "2"]))
    short_steps(cfg)
    cfg.commands.resampling_time = 2 * cfg.sim.dt
    return VelocityTrackingEnv(cfg, seed=3, device="cpu")


def rma(env):
    return ActorCriticRMA(num_obs=env.num_obs, num_privileged_obs=env.num_privileged_obs,
                          num_obs_history=env.num_obs_history, num_actions=env.num_actions)


GOAL_ARGS = t_train.parse_args(["--strategy", "goal", "--terrain", "random_pyramid",
                                "--num_envs", str(N), "--terrain_rows", "2",
                                "--terrain_cols", "2"])


def goal_env():
    """The goal recipe's configuration (3-step episodes, HISTORY frames)."""
    cfg = t_train.build_cfg(GOAL_ARGS)
    cfg.env.num_observation_history = HISTORY
    return TEnv(short_steps(cfg), seed=3, device="cpu")


def hierarchy_env():
    """The planner stack's configuration, replanning every 2 steps."""
    cfg = t_th.build_cfg(t_th.parse_args(["--num_envs", str(N), "--terrain_rows", "2",
                                          "--terrain_cols", "2", "--plan_interval", "2"]))
    cfg.env.num_observation_history = HISTORY
    return TEnv(short_steps(cfg), seed=3, device="cpu")


CASES = {
    "plain": (bench_env, None, {}, {}),
    "eval_envs": (eval_env, None, {}, {}),
    "cheap_shuffle": (bench_env, None, {"cheap_shuffle": True}, {}),
    "normalize_obs": (bench_env, None, {}, {"normalize_obs": True}),
    "velocity_rma": (velocity_env, rma, {}, {}),
    "goal_cnn": (goal_env, lambda env: t_train.make_policy(GOAL_ARGS, env.cfg, env), {}, {}),
    "hierarchy_planner": (hierarchy_env, None, {}, {}),
}


def run(case, windowed, iters=2, warmup=False):
    """``iters`` train iterations (or warmup iterations) of ``case`` from a
    seeded policy, reset and observe: the PPO, its train state and each
    iteration's metrics."""
    make_env, make_ac, ppo_kw, ac_kw = CASES[case]
    env = make_env()
    torch.manual_seed(0)
    alg = t_ppo.PPO(env, ac_args=ACArgs(**ac_kw), ac=make_ac(env) if make_ac else None,
                    args=t_ppo.PPOArgs(windowed_history=windowed, **PPO_KW, **ppo_kw),
                    seed=0)
    ts = alg.init()
    state = env.reset_fn(True)
    obs = env.observe(state)
    wopt = alg.warmup_init() if warmup else None
    out = []
    for _ in range(iters):
        if warmup:
            ts, state, obs, m, wopt = alg.warmup_iteration(ts, state, obs, wopt)
        else:
            ts, state, obs, m = alg.train_iteration(ts, state, obs)
        out.append(m)
    return alg, ts, out


def assert_bitwise(a, b):
    """Two (train state, metrics) runs equal at atol 0: parameters, both
    Adam states, learning rate, obs normalizer and every metric."""
    (ts_a, ms_a), (ts_b, ms_b) = a, b
    same = lambda x, y, what: torch.testing.assert_close(x, y, rtol=0, atol=0, msg=what)
    for k in ts_a.params:
        same(ts_a.params[k], ts_b.params[k], k)
    for sa, sb in ((ts_a.opt_state, ts_b.opt_state), (ts_a.adapt_opt_state,
                                                      ts_b.adapt_opt_state)):
        assert sa.count == sb.count
        for k in sa.mu:
            same(sa.mu[k], sb.mu[k], k)
            same(sa.nu[k], sb.nu[k], k)
    same(ts_a.learning_rate, ts_b.learning_rate, "learning_rate")
    if ts_a.obs_rms is not None:
        for x, y in zip(ts_a.obs_rms, ts_b.obs_rms):
            same(x, y, "obs_rms")
    for ma, mb in zip(ms_a, ms_b):
        assert set(ma) == set(mb)
        for k in ma:
            same(ma[k], mb[k], k)


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_train_iterations_match_stored(case):
    """Two train iterations (the first started by ``observe``, the second by
    the first's last step) windowed and stored from one seed: parameters,
    Adam states, learning rate and metrics at atol 0.  Under
    ``normalize_obs`` windowing is off and the rollout stores the rows."""
    alg, ts_w, m_w = run(case, True)
    _, ts_s, m_s = run(case, False)
    assert alg._window_history == (case != "normalize_obs")
    assert int(m_s[0]["num_episodes"]) > 0            # auto-resets inside the rollout
    assert_bitwise((ts_w, m_w), (ts_s, m_s))


def test_windowed_warmup_iterations_match_stored():
    """Two critic-only warmup iterations, windowed and stored: atol 0."""
    _, ts_w, m_w = run("plain", True, warmup=True)
    _, ts_s, m_s = run("plain", False, warmup=True)
    assert_bitwise((ts_w, m_w), (ts_s, m_s))


class HistoryRows(TorchFunctionMode):
    """Records the largest count of bf16 history rows (trailing width
    ``width``) in any one tensor that a torch function returns."""

    def __init__(self, width):
        super().__init__()
        self.width, self.most = width, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 and x.ndim
                    and x.shape[-1] == self.width):
                self.most = max(self.most, x.numel() // self.width)
        return out


@pytest.mark.parametrize("windowed", [True, False], ids=["windowed", "stored"])
def test_windowed_rollout_keeps_no_history_buffer(windowed):
    """Windowed, the rollout's history field is (T, N, 0) and no tensor of a
    train iteration holds more history rows than one minibatch (or the N
    rows the env steps with); stored, the (T, N, K num_obs) buffer shows."""
    env = bench_env()
    alg = t_ppo.PPO(env, args=t_ppo.PPOArgs(windowed_history=windowed, **PPO_KW))
    ts = alg.init()
    state = env.reset_fn(True)
    obs = env.observe(state)
    _, _, traj, _, _ = alg.rollout(state, obs)
    width = env.num_obs_history
    assert traj.obs_history.shape == (T, N, 0 if windowed else width)
    probe = HistoryRows(width)
    with probe:
        alg.train_iteration(ts, state, obs)
    mb = T * N // alg.args.num_mini_batches
    if windowed:
        assert probe.most <= max(mb, N), probe.most
    else:
        assert probe.most == T * N


def test_windowed_runner_trains_saves_and_resumes(tmp_path):
    """``Runner(env, ppo_args=PPOArgs(windowed_history=True))``: two
    ``learn`` iterations bitwise those of a stored Runner (parameters and
    history), its checkpoint resumed by a windowed Runner with a critic
    warmup iteration, which then trains on."""
    from legged_tracking_torch.learn.runner import Runner, RunnerArgs

    ppo_kw = {k: v for k, v in PPO_KW.items() if k != "num_steps_per_env"}
    runs = {}
    for windowed in (False, True):
        runner = Runner(bench_env(), runner_args=RunnerArgs(num_steps_per_env=T, log_freq=1),
                        ppo_args=t_ppo.PPOArgs(windowed_history=windowed, **ppo_kw),
                        logdir=str(tmp_path / f"run{int(windowed)}"), seed=0)
        assert runner.alg._window_history == windowed
        runner.learn(2, verbose=False)
        runs[windowed] = runner
    strip = lambda h: [{k: v for k, v in rec.items() if k != "fps"} for rec in h]
    assert strip(runs[True].history) == strip(runs[False].history)
    for k, v in runs[False].train_state.params.items():
        torch.testing.assert_close(runs[True].train_state.params[k], v, rtol=0, atol=0)

    resumed = Runner(bench_env(), runner_args=RunnerArgs(
        num_steps_per_env=T, log_freq=1, critic_warmup_iters=1,
        resume=str(tmp_path / "run1" / "ac_weights_last.pkl")),
        ppo_args=t_ppo.PPOArgs(windowed_history=True, **ppo_kw), seed=1)
    start = {k: v.detach().clone() for k, v in resumed.train_state.params.items()}
    for k, v in start.items():
        torch.testing.assert_close(v, runs[True].train_state.params[k], rtol=0, atol=0)
    resumed.learn(1, verbose=False)
    assert np.isfinite(resumed.history[-1]["value_loss"])
    assert any(not torch.equal(v, start[k]) for k, v in resumed.train_state.params.items())


# ------------------------------------------------------- against JAX
def test_windowed_train_iteration_matches_jax():
    """One windowed ``train_iteration`` (a 4-step rollout of 8 envs from
    ``observe``, 3-step episodes, 2 x 2 minibatches) against the jitted JAX
    one with ``PPOArgs(windowed_history=True)``, from the same state and
    parameters with the JAX env's draws, JAX's action normals and its
    permutation, at ``test_torch_ppo.py::test_train_iteration_matches``'s
    bars."""
    jenv = JEnv(short_steps(iteration_cfg(Cfg, config_go1, 0)), seed=3)
    tenv = TEnv(short_steps(iteration_cfg(TCfg, t_config_go1, 0)), seed=3, device="cpu")
    jalg = j_ppo.PPO(jenv, args=j_ppo.PPOArgs(windowed_history=True, **PPO_KW))
    talg = t_ppo.PPO(tenv, args=t_ppo.PPOArgs(windowed_history=True, **PPO_KW))
    jts = jax.jit(jalg.init)(jax.random.key(0))
    jts_np = jax.tree.map(np.asarray, jts)
    tts = convert.train_state_from_numpy(jts_np, talg, device="cpu")
    key = jax.random.key(5)
    jstate = jenv._reset_jit(key, True)
    jobs = jenv._observe_jit(jstate)
    ikey = jax.random.key(9)
    k_roll, k_update = jax.random.split(ikey)
    noise = np.stack([np.asarray(jax.random.normal(k, (N, jenv.num_actions)))
                      for k in jax.random.split(k_roll, T)])
    perm = np.asarray(jax.random.permutation(k_update, T * N))

    install(tenv, JaxDraws(key, N))
    try:
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
        tts2, tstate2, tobs2, tm = talg.train_iteration(
            tts, tstate, tenv.observe(tstate), action_noise=torch.as_tensor(noise),
            perm=torch.as_tensor(perm))
    finally:
        del tenv.draw, tenv.step_fn
    jts2, jstate2, jobs2, jm = jalg.train_iteration_jit(jts, jstate, jobs, ikey)
    jm.pop("video")
    jts2 = jax.tree.map(np.asarray, jts2)
    back = convert.train_state_to_numpy(tts2, jts2)

    assert set(tm) == set(jm)
    assert int(jm["num_episodes"]) > 0
    errs = {k: max_err(tm[k].numpy(), jm[k]) for k in tm}
    errs.update({"params": params_errors(back.params, jts2.params, jts_np.params),
                 "opt_state": tree_rel_err(back.opt_state, jts2.opt_state),
                 "adapt_opt_state": tree_rel_err(back.adapt_opt_state, jts2.adapt_opt_state),
                 "obs": max_err(tobs2["obs"].numpy(), jobs2["obs"]),
                 "base_pos": max_err(tstate2.phys.base_pos.numpy(), jstate2.phys.base_pos)})
    tol = {"params": {"leaf_rms_rel": 1e-3, "frac_over_1e-4": 2e-6}, "opt_state": 5e-4,
           "adapt_opt_state": 5e-4, "obs": 5e-5, "base_pos": 1e-6}
    for k in tm:
        if k in METRICS:
            errs[k] /= max(abs(float(jm[k])), 1.0)
        tol[k] = (1e-5 if k in METRICS else 0.0 if k.endswith(("num_episodes", "learning_rate"))
                  else 5e-7)
    bad = {k: (v, tol[k]) for k, v in errs.items()
           if (any(v[x] > tol[k][x] for x in v) if isinstance(v, dict) else not v <= tol[k])}
    assert not bad, bad
