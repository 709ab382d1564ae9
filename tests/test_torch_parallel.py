"""Data parallelism of the port (``legged_tracking_torch/parallel``) on the
CPU: two gloo ranks, each holding 4 of 8 envs, against the 1-rank port.

The bars are the JAX package's own (``tests/test_distributed.py``): a
sharded rollout within 1e-5 of one device on base positions and obs, two
train iterations within atol 2e-4 / rtol 2e-3 on every parameter, and a
two-process ``Runner.learn`` within 1e-3 / 6e-3.  The 1-rank port is held to
the JAX package elsewhere (``test_torch_ppo.py``, ``test_torch_runner*.py``).
The two ranks run once, in a module fixture; each writes what it computed
and the tests compare.  ``cheap_perm`` is held bitwise against JAX's
``_cheap_perm`` on JAX's own draws, fed to the port.  JAX is imported in
that test only: the spawned ranks import this module, and need none of it.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from legged_tracking_torch.config import Cfg, config_go1
from legged_tracking_torch.envs import LeggedEnv
from legged_tracking_torch.learn.ppo import PPO, PPOArgs, cheap_perm
from legged_tracking_torch.learn.runner import Runner, RunnerArgs
from legged_tracking_torch.parallel import Shard, init_distributed, launch, rank_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The one-rank side runs single-threaded, as the ranks do, beside the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_env(shard=None):
    """tests/test_distributed.py's 8-env plane env (xy commands, P control)."""
    cfg = config_go1(Cfg())
    cfg.env.num_envs = N
    cfg.terrain.mesh_type = "plane"
    cfg.env.command_type = "xy"
    cfg.control.control_type = "P"
    cfg.env.episode_length_s = 2.0
    cfg.control.decimation = 2
    return LeggedEnv(cfg, device="cpu", shard=shard)


def velocity_env(shard=None):
    """The velocity configuration at 8 envs on 2x2 tiles, resampling
    commands every 2 steps from 5-step episodes, with success thresholds a
    sixteenth of the defaults, so that the curriculum's bump runs within a
    few steps (chip_smoke.py's velocity-reference env, thresholds halved)."""
    from legged_tracking_torch import train_velocity_tracking as tv
    from legged_tracking_torch.envs.velocity_env import TRACK_KEYS, VelocityTrackingEnv

    cfg = tv.build_cfg(tv.parse_args(["--num_envs", str(N), "--terrain_rows", "2",
                                      "--terrain_cols", "2"]))
    cfg.commands.resampling_time = 0.04
    cfg.env.episode_length_s = 0.1
    cfg.commands.lin_vel_x = cfg.commands.ang_vel_yaw = [-0.3, 0.3]
    th = cfg.curriculum_thresholds
    for k in TRACK_KEYS:
        setattr(th, k, getattr(th, k) / 16)
    return VelocityTrackingEnv(cfg, seed=3, device="cpu", shard=shard)


def rollout(env, steps=3):
    """``steps`` steps of a fixed action from a seeded reset: base positions,
    obs and rewards after each."""
    env.generator.manual_seed(3)
    state = env.reset_fn(False)
    a = torch.full((env.num_envs, 12), 0.05)
    out = []
    for _ in range(steps):
        state, o = env.step_fn(state, a)
        out.append({"base_pos": state.phys.base_pos, "obs": o.obs, "rew": o.rew})
    return out, state


def train(env, windowed=False):
    """Two PPO train iterations (4 steps, 2 x 2 minibatches) from a seeded
    policy and reset, histories stored or ``windowed``; the parameters after
    them."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        alg = PPO(env, args=PPOArgs(num_steps_per_env=4, num_mini_batches=2,
                                    num_learning_epochs=2, windowed_history=windowed),
                  seed=2)
    ts = alg.init()
    env.generator.manual_seed(1)
    es = env.reset_fn(False)
    obs = env.observe(es)
    for _ in range(2):
        ts, es, obs, metrics = alg.train_iteration(ts, es, obs)
    return {k: v.detach().clone() for k, v in ts.params.items()}, metrics


def small_runner(env, logdir=None, distributed=False):
    """tests/test_distributed.py's Runner configuration."""
    return Runner(env, runner_args=RunnerArgs(num_steps_per_env=4, log_freq=1),
                  ppo_args=PPOArgs(num_mini_batches=2, num_learning_epochs=2),
                  seed=7, logdir=logdir, distributed=distributed)


def rank_work(outdir):
    """One rank's share of every case, written to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    shard = Shard(rank, world, N)
    steps, _ = rollout(make_env(shard))
    _, vstate = rollout(velocity_env(shard), steps=8)
    params, metrics = train(make_env(shard))
    params_w, metrics_w = train(make_env(shard), windowed=True)
    runner = small_runner(make_env(), os.path.join(outdir, f"run{rank}"), distributed=True)
    runner.learn(2, verbose=False)
    res = {"rollout": steps, "params": params, "metrics": metrics,
           "params_windowed": params_w, "metrics_windowed": metrics_w,
           "runner_params": {k: v.detach().clone() for k, v in
                             runner.train_state.params.items()},
           "history": runner.history,
           "velocity": {k: getattr(vstate, k) for k in
                        ("curriculum_weights", "env_command_bins", "env_command_categories",
                         "commands")}}
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    launch(rank_work, 2, out, backend="gloo", device="cpu")
    res = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return out, res


@pytest.fixture(scope="module")
def one_rank_train():
    """One rank's two train iterations with stored histories, the reference
    of the sharded cases."""
    return train(make_env())


def cat(parts):
    return torch.cat(parts, dim=0)


# --------------------------------------------------------------- draws
@pytest.mark.parametrize("tag,shape,lo,hi,integer", [
    (("reset", 10), (N, 12), 0.5, 1.5, False),
    (("step", 20), (N, 2), -1.0, 1.0, False),
    (("step", 26), (N, 7), -1.0, 1.0, False),
    (("rng", 50, 40), (N,), 0, 4, True),
    (("reset", "ep_len"), (N,), 0, 100, True),
    (("global", "gravity"), (3,), -1.0, 1.0, False),
])
def test_sharded_draw_is_rows_of_the_whole(tag, shape, lo, hi, integer):
    """Under a shard ``draw`` gives the rank's rows of the unsharded draw,
    bitwise; a global draw is whole and the same on every rank."""
    def draws(shard):
        env = make_env(shard)
        env.generator.manual_seed(11)
        local = (env.num_envs,) + shape[1:] if tag[0] != "global" else shape
        # two draws in a row: the generator advances alike on every rank
        return [env.draw(tag, local, lo, hi, integer) for _ in range(2)]

    whole = draws(None)
    parts = [draws(Shard(r, 2, N)) for r in range(2)]
    for i in range(2):
        if tag[0] == "global":
            for p in parts:
                torch.testing.assert_close(p[i], whole[i], rtol=0, atol=0)
        else:
            torch.testing.assert_close(cat([p[i] for p in parts]), whole[i], rtol=0, atol=0)


def test_draw_needs_the_shard_width():
    env = make_env(Shard(1, 2, N))
    with pytest.raises(ValueError, match="leading axis"):
        env.draw(("step", 20), (N, 2), 0.0, 1.0)


def test_shard_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="do not divide"):
        Shard(0, 3, N)


def test_nccl_refuses_more_ranks_than_cards():
    """NCCL needs a card for each rank: asked for more ranks on this host than
    cards, init_distributed raises naming both counts, before joining."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"{cards + 1} ranks on this host, {cards} card"):
        init_distributed("127.0.0.1:1", cards + 1, 0, backend="nccl", device="cuda")
    assert not dist.is_initialized()


def test_a_rank_without_its_card_raises():
    """A rank's device that is not there raises; nothing moves to the CPU."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        rank_device(f"cuda:{cards}")
    assert rank_device("cpu", 3) == torch.device("cpu")


# ------------------------------------------------------------- two ranks
def test_sharded_rollout_matches_one_rank(ranks):
    _, res = ranks
    whole, _ = rollout(make_env())
    for t, ref in enumerate(whole):
        for k in ("base_pos", "obs", "rew"):
            got = cat([r["rollout"][t][k] for r in res])
            np.testing.assert_allclose(got.numpy(), ref[k].numpy(), atol=1e-5,
                                       err_msg=f"step {t} {k}")


def test_sharded_velocity_curriculum_matches_one_rank(ranks):
    """The velocity env's bump is all-reduced: after 8 steps the curriculum
    weights are bitwise those of one rank (small integer counts in float32),
    and have moved; the bins, categories and commands are the rows."""
    _, res = ranks
    env = velocity_env()
    _, state = rollout(env, steps=8)
    w = state.curriculum_weights
    assert not torch.equal(w, env.curriculum.init_weights)
    for r in res:
        torch.testing.assert_close(r["velocity"]["curriculum_weights"], w, rtol=0, atol=0)
    for k in ("env_command_bins", "env_command_categories"):
        torch.testing.assert_close(cat([r["velocity"][k] for r in res]), getattr(state, k),
                                   rtol=0, atol=0)
    np.testing.assert_allclose(cat([r["velocity"]["commands"] for r in res]).numpy(),
                               state.commands.numpy(), atol=1e-5)


def test_sharded_train_iterations_match_one_rank(ranks, one_rank_train):
    _, res = ranks
    params, metrics = one_rank_train
    for k, v in params.items():
        for r in res:
            np.testing.assert_allclose(r["params"][k].numpy(), v.numpy(), atol=2e-4,
                                       rtol=2e-3, err_msg=k)
        torch.testing.assert_close(res[0]["params"][k], res[1]["params"][k], rtol=0, atol=0)
    for k in ("value_loss", "surrogate_loss", "adaptation_loss", "kl_mean",
              "mean_reward_per_step", "action_std_mean", "num_episodes"):
        np.testing.assert_allclose(res[0]["metrics"][k].numpy(), metrics[k].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_sharded_windowed_train_iterations_match_one_rank_stored(ranks, one_rank_train):
    """Two ranks with windowed histories, each cutting the windows of its own
    envs from its own frame stream, against one rank that stores them:
    within the same bars; the ranks' parameters equal, and bitwise those of
    the two ranks that store them."""
    _, res = ranks
    params, metrics = one_rank_train
    for k, v in params.items():
        for r in res:
            np.testing.assert_allclose(r["params_windowed"][k].numpy(), v.numpy(), atol=2e-4,
                                       rtol=2e-3, err_msg=k)
            torch.testing.assert_close(r["params_windowed"][k], r["params"][k], rtol=0, atol=0)
        torch.testing.assert_close(res[0]["params_windowed"][k], res[1]["params_windowed"][k],
                                   rtol=0, atol=0)
    for k in ("value_loss", "surrogate_loss", "adaptation_loss", "kl_mean",
              "mean_reward_per_step", "action_std_mean", "num_episodes"):
        np.testing.assert_allclose(res[0]["metrics_windowed"][k].numpy(), metrics[k].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_two_process_runner_matches_single(ranks):
    """Two ranks of ``Runner.learn(2)`` against one: the parameters within
    the JAX package's two-process bar, the history alike on both ranks (but
    each rank's own fps), timesteps of the global envs, and rank 0 the only
    writer."""
    out, res = ranks
    runner = small_runner(make_env())
    runner.learn(2, verbose=False)
    for k, v in runner.train_state.params.items():
        np.testing.assert_allclose(res[0]["runner_params"][k].numpy(), v.detach().numpy(),
                                   atol=1e-3, rtol=6e-3, err_msg=k)
        torch.testing.assert_close(res[0]["runner_params"][k], res[1]["runner_params"][k],
                                   rtol=0, atol=0)
    strip = lambda h: [{k: v for k, v in rec.items() if k != "fps"} for rec in h]
    assert strip(res[0]["history"]) == strip(res[1]["history"])
    assert [rec["timesteps"] for rec in res[0]["history"]] == [N * 4, 2 * N * 4]
    assert sorted(os.listdir(os.path.join(out, "run0"))) == [
        "ac_weights_last.pkl", "metrics.jsonl", "parameters.pkl", "policy.npz"]
    assert not os.path.exists(os.path.join(out, "run1"))


def test_train_entry_on_two_cpu_ranks(tmp_path):
    """``python -m legged_tracking_torch.train --num_devices 2 --device cpu``
    spawns two gloo ranks; rank 0 writes the logdir, timesteps count the
    global envs."""
    logdir = tmp_path / "run"
    cmd = [sys.executable, "-m", "legged_tracking_torch.train", "--device", "cpu",
           "--num_devices", "2", "--old_ppo", "--strategy", "e2e", "--num_envs", "8",
           "--iterations", "2", "--num_steps_per_env", "4", "--terrain_rows", "2",
           "--terrain_cols", "2", "--logdir", str(logdir)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert [r["it"] for r in recs] == [0, 1]
    assert recs[-1]["timesteps"] == 2 * 8 * 4
    assert all(np.isfinite(recs[-1][k]) for k in ("value_loss", "kl_mean", "rew_total"))
    assert "params/actor_body/Dense_0/kernel" in np.load(logdir / "policy.npz")
    assert res.stdout.count("it     1") == 1          # rank 0 prints, rank 1 does not


# --------------------------------------------------------- cheap shuffle
@pytest.mark.parametrize("B,T,N_", [(32, 4, 8), (98304, 24, 4096), (30, 1, 30)])
def test_cheap_perm_is_jax_bitwise(B, T, N_):
    """The port's ``cheap_perm`` on JAX's draws equals JAX's ``_cheap_perm``
    bitwise and is a bijection of [0, B); the bench's B = 24 x 4096 takes
    the int32 product past 2**31, which wraps in both."""
    import jax
    import jax.numpy as jnp

    from legged_tracking_tpu.learn.ppo import _cheap_perm as jax_cheap_perm

    key = jax.random.key(5)
    want = np.asarray(jax.jit(jax_cheap_perm, static_argnums=(1, 2, 3))(key, B, T, N_))
    # JAX's draws inside _cheap_perm (learn/ppo.py:51-60)
    ks = jax.random.split(key, 4)
    amax = max(3, min((2 ** 31 - 1 - B) // max(B, 1), 1 << 20))
    a0 = [int(jax.random.randint(k, (), 2, amax)) for k in ks[:2]]
    c1, c2 = (int(jax.random.randint(k, (), 0, B, dtype=jnp.int32)) for k in ks[2:])
    t = lambda v: torch.tensor(v, dtype=torch.int32)
    got = cheap_perm(B, T, N_, [t(a) for a in a0], t(c1), t(c2)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(B))


def test_ppo_cheap_shuffle_draws_a_bijection():
    alg = PPO(make_env(), args=PPOArgs(cheap_shuffle=True), seed=4)
    for B, T, N_ in ((32, 4, 8), (30, 4, 8)):
        p = alg._perm(B, T, N_)
        np.testing.assert_array_equal(np.sort(p.numpy()), np.arange(B))
