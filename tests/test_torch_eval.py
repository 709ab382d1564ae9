"""The port's evaluation path against the JAX package on the CPU: the eval
metrics and the adaptation loss, the DR profiles, an env step under
``rand_large``, ``eval.rollout_metrics`` against ``scripts/eval.py`` on a
JAX-written run, ``render_frames``, ``sim_real_compare``, the eval entries
on a run the port wrote, and a JAX run's artifacts loaded where JAX cannot
be imported.

One JAX env (the bench configuration, 4 envs on 2x2 tiles, evaluated under
``rand_large``) is compiled once for the whole file.  The JAX metrics are
called eagerly, as ``scripts/eval.py`` calls them."""

import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import JaxDraws, assert_state_close, bench_cfg, install, to_numpy
from test_torch_goal import cfg_tree, script
from test_torch_imports import FORBIDDEN

from legged_tracking_torch import convert
from legged_tracking_torch import eval as t_eval
from legged_tracking_torch import eval_reached as t_eval_reached
from legged_tracking_torch import play_hierarchical as t_play
from legged_tracking_torch import sim_real_compare as t_sim_real
from legged_tracking_torch import watch as t_watch
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_torch.io import checkpoint as t_ckpt
from legged_tracking_torch.io import render as t_render
from legged_tracking_torch.learn import actor_critic_cnn as t_cnn
from legged_tracking_torch.learn import actor_critic_rma as t_rma
from legged_tracking_torch.learn import domain_randomization_profiles as t_drp
from legged_tracking_torch.learn import eval_metrics as t_metrics
from legged_tracking_torch.learn.runner import Runner as TRunner
from legged_tracking_torch.learn.runner import RunnerArgs as TRunnerArgs
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.io import render as j_render
from legged_tracking_tpu.learn import actor_critic_cnn as j_cnn
from legged_tracking_tpu.learn import actor_critic_rma as j_rma
from legged_tracking_tpu.learn import domain_randomization_profiles as j_drp
from legged_tracking_tpu.learn import eval_metrics as j_metrics
from legged_tracking_tpu.learn import ppo as j_ppo
from legged_tracking_tpu.learn.runner import Runner as JRunner
from legged_tracking_tpu.learn.runner import RunnerArgs as JRunnerArgs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS = 4, 5
J_EVAL = script("eval")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs single-threaded beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_jax_run(logdir, env):
    """A JAX Runner's artifacts for ``env``'s configuration:
    ``parameters.pkl`` and ``ac_weights_last.pkl`` of the CSE policy, with
    moved parameters and Adam moments, count 3, iteration 7.  Returns the
    checkpoint's train state (numpy leaves)."""
    jr = object.__new__(JRunner)
    jr.runner_args, jr.env_state = JRunnerArgs(), None
    ts = jax.tree.map(np.asarray, j_ppo.PPO(env).init(jax.random.key(0)))
    rng = np.random.RandomState(4)
    moved = lambda x: (x + 0.05 * rng.normal(size=np.shape(x))).astype(np.float32)
    adam = lambda s: s._replace(count=np.int32(3), mu=jax.tree.map(moved, s.mu),
                                nu=jax.tree.map(lambda x: np.abs(moved(x)), s.nu))
    inject = ts.opt_state[1]
    jr.train_state = ts._replace(
        params=jax.tree.map(moved, ts.params),
        opt_state=(ts.opt_state[0], inject._replace(
            inner_state=(adam(inject.inner_state[0]), inject.inner_state[1]))),
        adapt_opt_state=(adam(ts.adapt_opt_state[0]), ts.adapt_opt_state[1]),
        learning_rate=np.float32(4e-4), iteration=np.int32(7))
    jr.save(os.path.join(logdir, "ac_weights_last.pkl"), target_dist=1.5)
    return jr.train_state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A JAX-written run of the bench configuration, its eval env under
    ``rand_large`` in both packages (the port's from the run's artifacts,
    read by the port), the JAX reset state that ``scripts/eval.py`` starts
    from, and the JAX policy."""
    logdir = str(tmp_path_factory.mktemp("jax_run"))
    with open(os.path.join(logdir, "parameters.pkl"), "wb") as f:
        pickle.dump(bench_cfg(Cfg, config_go1), f)
    jenv = J_EVAL.load_env(logdir, N, dr_profile="rand_large")
    jts = write_jax_run(logdir, jenv)
    jalg, jparams, jpolicy = J_EVAL.load_policy(jenv, logdir)
    tenv = t_eval.load_env(logdir, N, dr_profile="rand_large", device="cpu")
    talg, tpolicy = t_eval.load_policy(tenv, logdir)
    key = jax.random.key(jenv.cfg.seed)
    jstate0 = jenv._reset_jit(key, False)
    return types.SimpleNamespace(logdir=logdir, jenv=jenv, jts=jts, jalg=jalg,
                                 jparams=jparams, jpolicy=jpolicy, tenv=tenv, talg=talg,
                                 tpolicy=tpolicy, key=key, jstate0=jstate0)


@pytest.fixture(scope="module")
def rollouts(world):
    """``rollout_metrics`` of 5 steps: scripts/eval.py's from its reset, and
    the port's from that reset state with the JAX env's draws."""
    w = world
    jm, jframes = J_EVAL.rollout_metrics(w.jenv, w.jalg, w.jparams, w.jpolicy, STEPS)
    install(w.tenv, JaxDraws(w.key, N))
    try:
        tm, tframes = t_eval.rollout_metrics(
            w.tenv, w.talg, w.tpolicy, STEPS,
            state=convert.env_state_from_numpy(to_numpy(w.jstate0), device="cpu"))
    finally:
        del w.tenv.draw, w.tenv.step_fn
    return jm, jframes, tm, tframes


# ----------------------------------------------------------------- metrics
def random_states(n, seed):
    """A JAX and a port state (the fields the metrics read) of ``n`` envs
    with random orientations, velocities, torques, payloads and 15 velocity
    commands; env 0 stands still in x and y, so its cost of transport reads
    infinite."""
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(n, 18)).astype(np.float32)
    v[0, :3] = 0.0
    fields = dict(torques=(rng.normal(size=(n, 12)) * 10).astype(np.float32),
                  payload=rng.uniform(-1.5, 4.0, n).astype(np.float32),
                  commands=rng.normal(size=(n, 15)).astype(np.float32))
    phys = dict(base_quat=q, v=v, base_pos=rng.normal(size=(n, 3)).astype(np.float32))
    make = lambda f: types.SimpleNamespace(
        phys=types.SimpleNamespace(**{k: f(x) for k, x in phys.items()}),
        **{k: f(x) for k, x in fields.items()})
    return make(jnp.asarray), make(torch.as_tensor)


@pytest.mark.parametrize("which", ["rolled", "random"])
def test_metrics_match_eager_jax(world, rollouts, which):
    """The nine metrics against the JAX functions called eagerly, as
    scripts/eval.py calls them, bitwise: on the JAX state after the eval
    rollout fed through convert.py (the tunnel task's 2 xy commands, where
    ang_vel_rmsd reads column 1 because JAX's index 2 clamps), and on 4,096
    random states with 15 commands, one of them standing still (its cost of
    transport infinite on both sides)."""
    if which == "rolled":
        jstate = world.jenv.state
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
    else:
        jstate, tstate = random_states(4096, 1)
    for name, fn in t_metrics.METRICS_FNS.items():
        got = fn(tstate).numpy()
        want = np.asarray(j_metrics.METRICS_FNS[name](jstate))
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if which == "random":
        assert np.isinf(t_metrics.cost_of_transport(tstate).numpy()[0])


def test_froude_number_divides():
    """froude_number divides as eager JAX does (the true quotient), not by
    the reciprocal that a jitted JAX call multiplies by: on 100,000 draws it
    equals the eager call everywhere, and the reciprocal multiply differs
    somewhere."""
    rng = np.random.RandomState(0)
    v = rng.normal(size=100_000).astype(np.float32)
    state = types.SimpleNamespace(phys=types.SimpleNamespace(
        base_quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]]).expand(len(v), 4),
        v=torch.as_tensor(np.pad(v[:, None], ((0, 0), (0, 17))))))
    got = t_metrics.froude_number(state).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(v) ** 2 / (9.8 * 0.30)))
    assert not np.array_equal(got, (v * v) * np.float32(1 / np.float32(9.8 * 0.30)))


def adaptation_pair(world, family):
    """The flax policy of ``family`` for the eval env and its port twin, the
    flax parameters carried over."""
    env = world.jenv
    dims = dict(num_obs=env.num_obs, num_privileged_obs=env.num_privileged_obs,
                num_obs_history=env.num_obs_history, num_actions=env.num_actions)
    if family == "cse":
        jm = world.jalg.ac
        tm = world.talg.ac
        return jm, tm, world.jparams
    if family == "cnn":
        # the goal recipe's default: the MLP height encoder, no GRU
        kw = dict(use_cnn=False, use_gru=False, height_map_shape=(2, 10, 11))
        jm = j_cnn.ActorCriticCNN(**dims, args=j_cnn.ACCnnArgs(**kw))
        tm = t_cnn.ActorCriticCNN(**dims, args=t_cnn.ACCnnArgs(**kw))
    else:
        jm = j_rma.ActorCriticRMA(**dims, args=j_rma.ACRmaArgs())
        tm = t_rma.ActorCriticRMA(**dims, args=t_rma.ACRmaArgs())
    o, p, h = (jnp.zeros((1, n)) for n in (dims["num_obs"], dims["num_privileged_obs"],
                                           dims["num_obs_history"]))
    params = jm.init(jax.random.key(1), o, p, h)
    tm.load_state_dict(convert.flax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, tm, params


@pytest.mark.parametrize("family", ["cse", "cnn", "rma"])
def test_adaptation_loss_matches_jax(world, family):
    """adaptation_loss of the CSE, CNN and RMA policies on random obs
    (histories stored bf16) against the eager JAX function: the same MLPs
    in another summation order (read: 1.1e-6 relative at most; limit
    1e-5)."""
    jm, tm, params = adaptation_pair(world, family)
    env = world.jenv
    rng = np.random.RandomState(2)
    p = rng.normal(size=(8, env.num_privileged_obs)).astype(np.float32)
    h = jnp.asarray(rng.normal(size=(8, env.num_obs_history)), jnp.bfloat16)
    want = np.asarray(j_metrics.adaptation_loss(
        types.SimpleNamespace(ac=jm, _m=type(jm)), params,
        {"obs_history": h, "privileged_obs": jnp.asarray(p)}))
    got = t_metrics.adaptation_loss(tm, {"obs_history": torch.as_tensor(
        np.asarray(h, np.float32)).to(torch.bfloat16), "privileged_obs": torch.as_tensor(p)})
    assert got.shape == want.shape == (8,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


# ------------------------------------------------------------ DR profiles
@pytest.mark.parametrize("name", sorted(j_drp.DR_PROFILES))
def test_dr_profiles_match_jax(name):
    """Each profile leaves both packages' configurations equal, field by
    field."""
    jcfg = j_drp.DR_PROFILES[name](config_go1(Cfg()))
    tcfg = t_drp.DR_PROFILES[name](t_config_go1(TCfg()))
    assert cfg_tree(tcfg) == cfg_tree(jcfg)
    assert sorted(t_drp.DR_PROFILES) == sorted(j_drp.DR_PROFILES)


def test_reset_and_step_under_rand_large(world):
    """The port's reset under rand_large with the JAX env's draws is the JAX
    reset state (friction, restitution, payload, CoM and motor strength
    drawn from the profile's ranges), and one step from it matches the JAX
    step within the limits of tests/test_torch_env.py's five steps (read:
    base_pos 0, obs 1.2e-7, rew 9.3e-10)."""
    w = world
    draws = JaxDraws(w.key, N)
    install(w.tenv, draws)
    try:
        tstate = w.tenv.reset_fn(False)
        assert_state_close(tstate, w.jstate0, atol=0.0)
        dr = w.tenv.cfg.domain_rand
        assert dr.randomize_restitution and dr.friction_range == [0.04, 6.0]
        a = 0.3 * np.sin(np.arange(N * 12, dtype=np.float32)).reshape(N, 12)
        tstate, ot = w.tenv.step_fn(tstate, torch.as_tensor(a))
    finally:
        del w.tenv.draw, w.tenv.step_fn
    # the env's own jitted step, which the rollout compiled; it donates its
    # state, so it gets a copy
    js, oj = w.jenv._step_jit(jax.tree.map(lambda x: x.copy(), w.jstate0), jnp.asarray(a))
    np.testing.assert_allclose(tstate.phys.base_pos.numpy(), np.asarray(js.phys.base_pos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ot.obs.numpy(), np.asarray(oj.obs), rtol=0, atol=5e-5)
    np.testing.assert_allclose(ot.rew.numpy(), np.asarray(oj.rew), rtol=0, atol=1e-7)
    assert_state_close(tstate, js, atol=5e-2)


# ------------------------------------------------------------- eval entry
def test_rollout_metrics_match_scripts_eval(world, rollouts):
    """eval.rollout_metrics against scripts/eval.py's on a JAX-written run
    under rand_large, 5 steps from one state with the JAX env's draws: the
    same keys; every frame within 1e-5 and its base positions within 1e-6
    (read: 1.3e-6 and 3.0e-8); each metric within 1e-5 of max(|value|, 1)
    (read: 8.1e-7 at most, power_consumption).  The physics sums run in
    another order, so the states differ by ulps."""
    jm, jframes, tm, tframes = rollouts
    assert list(tm) == list(jm) and len(tframes) == len(jframes) == STEPS
    for f_t, f_j in zip(tframes, jframes):
        assert sorted(f_t) == sorted(f_j)
        for k in f_j:
            np.testing.assert_allclose(f_t[k], f_j[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(f_t["base_pos"], f_j["base_pos"], rtol=0, atol=1e-6)
    for k, v in jm.items():
        assert abs(tm[k] - v) <= 1e-5 * max(abs(v), 1.0), (k, tm[k], v)


def test_render_frames_match_jax(world, rollouts):
    """render_frames of the port's TerrainArrays gives the JAX images, pixel
    for pixel, on the same frames and tile."""
    _, jframes, _, _ = rollouts
    tile = int(np.asarray(world.jenv.terrain.env_tile)[1])
    want = j_render.render_frames(jframes[:2], world.jenv.terrain, env_id_pos=1, tile_idx=tile)
    got = t_render.render_frames(jframes[:2], world.tenv.terrain, env_id_pos=1, tile_idx=tile)
    assert len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------- artifacts without JAX
def test_foreign_jax_global_raises(tmp_path):
    """load_pickle names a JAX global it cannot map instead of importing it."""
    path = tmp_path / "array.pkl"
    with open(path, "wb") as f:
        pickle.dump({"x": jnp.zeros(2)}, f)
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        t_ckpt.load_pickle(str(path))


def test_jax_run_loads_without_jax(world, tmp_path):
    """In a process where importing jax, jaxlib, flax, optax or
    legged_tracking_tpu raises: eval.load_env reads the JAX run's
    parameters.pkl, eval.load_policy its checkpoint, and Runner.load resumes
    from it, parameters, iteration, learning rate and both Adam states
    (count 3, moments) as the JAX Runner wrote them, bitwise."""
    ts = world.jts
    want = {"params": convert.flax_params_to_state_dict(ts.params),
            "mu": convert.flax_params_to_state_dict(ts.opt_state[1].inner_state[0].mu),
            "adapt_nu": convert.flax_params_to_state_dict(ts.adapt_opt_state[0].nu)}
    np.savez(tmp_path / "want.npz", **{f"{g}/{k}": v.numpy() for g, sd in want.items()
                                       for k, v in sd.items()})
    code = f"""
import sys
for m in {FORBIDDEN!r}:
    sys.modules[m] = None
sys.path.insert(0, {ROOT!r})
import numpy as np, torch
from legged_tracking_torch import eval as ev
from legged_tracking_torch.learn.runner import Runner
want = np.load({str(tmp_path / 'want.npz')!r})
env = ev.load_env({world.logdir!r}, 4, device="cpu")
assert env.cfg.commands.traj_function == "fixed_target" and env.num_envs == 4
alg, policy = ev.load_policy(env, {world.logdir!r})
for k, v in alg.ac.state_dict().items():
    assert np.array_equal(v.numpy(), want["params/" + k]), k
r = Runner(env, seed=0)
r.load({os.path.join(world.logdir, 'ac_weights_last.pkl')!r})
ts = r.train_state
assert ts.iteration == 7 and float(ts.learning_rate) == np.float32(4e-4)
assert ts.opt_state.count == 3 and ts.adapt_opt_state.count == 3
for k in ts.params:
    assert np.array_equal(ts.params[k].detach().numpy(), want["params/" + k]), k
    assert np.array_equal(ts.opt_state.mu[k].numpy(), want["mu/" + k]), k
    assert np.array_equal(ts.adapt_opt_state.nu[k].numpy(), want["adapt_nu/" + k]), k
obs = env.observe(env.reset_fn())
assert policy(obs["obs"], obs["obs_history"]).shape == (4, 12)
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**env, "OMP_NUM_THREADS": "1"}, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


# -------------------------------------------- the entries on a port run
@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run the port's Runner wrote: the bench configuration, 4 envs on 2x2
    tiles, one iteration of 2 steps."""
    logdir = str(tmp_path_factory.mktemp("port_run"))
    env = TEnv(bench_cfg(TCfg, t_config_go1), seed=3, device="cpu")
    runner = TRunner(env, runner_args=TRunnerArgs(num_steps_per_env=2), logdir=logdir, seed=0)
    runner.learn(1, verbose=False)
    return logdir


def test_eval_entries_on_a_port_run(port_run, capsys):
    """eval (2 steps, one env's video, plots, report), eval_reached (with a
    target distance), play_hierarchical (the planner in the loop, no video)
    and watch (one render) run on the CPU on a run the port wrote."""
    d = port_run
    report = t_eval.main(t_eval.parse_args(["--logdir", d, "--device", "cpu", "--num_envs", "4",
                                            "--steps", "2", "--video_envs", "1"]))
    assert set(report["nominal"]) == set(t_metrics.METRICS_FNS) | {"adaptation_loss"}
    assert all(np.isfinite(v) for k, v in report["nominal"].items() if k != "CoT")
    assert {"env0.mp4", "plots.png", "eval_report.json"} <= set(os.listdir(f"{d}/eval")) or \
        "env0.gif" in os.listdir(f"{d}/eval")
    reached = t_eval_reached.main(t_eval_reached.parse_args(
        ["--logdir", d, "--device", "cpu", "--num_envs", "4", "--steps", "3",
         "--target_dist", "1.0"]))
    assert 0.0 <= reached <= 1.0
    sums = t_play.main(t_play.parse_args(["--logdir", d, "--device", "cpu", "--steps", "3",
                                          "--no_video"]))
    assert "total" in sums and np.isfinite(sums["total"])
    out = t_watch.main(t_watch.parse_args(["--logdir", d, "--device", "cpu", "--steps", "2",
                                           "--every", "1"]))
    assert os.path.exists(out)
    assert "wrote" in capsys.readouterr().out


def test_sim_real_compare_replays_its_own_log(tmp_path):
    """sim_real_compare on a log the port's sim wrote (the deploy format,
    tests/test_sim_real.py's scripted actions): RMSE below 1e-3 on every
    channel."""
    def make_cfg():
        cfg = t_config_go1(TCfg())
        cfg.env.num_envs = 1
        cfg.env.command_type = "xy"
        cfg.terrain.mesh_type = "plane"
        cfg.terrain.measure_heights = False
        cfg.env.observe_heights = False
        cfg.noise.add_noise = False
        for k in list(vars(cfg.domain_rand)):
            if k.startswith("randomize"):
                setattr(cfg.domain_rand, k, False)
        cfg.domain_rand.push_robots = False
        cfg.parse()
        return cfg

    env = TEnv(make_cfg(), device="cpu")
    env.reset(randomize_ep_len=False)
    rng = np.random.RandomState(0)
    T, log = 40, []
    for t in range(T):
        action = 0.3 * np.sin(0.1 * t + rng.uniform(0, np.pi, 12))
        od, _, _, _ = env.step(torch.as_tensor(action[None], dtype=torch.float32))
        log.append({"t": float(t) * 0.02, "obs": od["obs"].numpy(),
                    "action": action.astype(np.float32)})
    with open(tmp_path / "parameters.pkl", "wb") as f:
        pickle.dump(make_cfg(), f)
    with open(tmp_path / "deploy_log.pkl", "wb") as f:
        pickle.dump(log, f)
    rmse, sim, real = t_sim_real.compare(str(tmp_path), str(tmp_path / "deploy_log.pkl"),
                                         steps=T, channels=45, plot=False, device="cpu")
    assert sim.shape == real.shape == (T, min(45, env.num_obs))
    assert float(rmse.max()) < 1e-3, rmse


def test_training_video_is_written(tmp_path):
    """Runner.learn with save_video_interval=1 (4 envs, 2 iterations of 2
    steps, the last 3 frames) writes videos/train_it000001.mp4, or the GIF
    fallback."""
    env = TEnv(bench_cfg(TCfg, t_config_go1), seed=3, device="cpu")
    runner = TRunner(env, runner_args=TRunnerArgs(num_steps_per_env=2, save_video_interval=1,
                                                  video_frames=3),
                     logdir=str(tmp_path), seed=0)
    assert runner.alg.record_video
    runner.learn(2, verbose=False)
    assert os.listdir(tmp_path / "videos") in (["train_it000001.mp4"], ["train_it000001.gif"])
