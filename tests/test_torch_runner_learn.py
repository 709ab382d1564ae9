"""The port's ``Runner.learn`` against the JAX package's, on the CPU.

Both runners are driven by one scripted stream of ``train_iteration``
results (each side's ``train_iteration`` is replaced by a stub that returns
the stream's metrics and, when it updates, steps the iteration, sets the
stream's learning rate and adds 1 to ``std``), so the comparison holds the
host loop alone: the fix-target curriculum (advance, the clamp at the goal
distance, downstep, the stagnation probe, restore-best with its two gates
and the 1e-4 slack, the 4000-deep window), the best-score snapshot, the
periodic, last and best checkpoints, ``best.json`` and the
``metrics.jsonl`` records.  Before every iteration and at the end, the
curriculum distance, the restore count, the best iteration and score, the
window and the training state's iteration, learning rate and ``std`` must
be equal on both sides; so must every record (``fps`` only by key) and the
files each run writes.
"""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_support  # noqa: F401

from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_torch.learn import ppo as t_ppo
from legged_tracking_torch.learn import runner as t_runner
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.envs import LeggedEnv as JEnv
from legged_tracking_tpu.learn import ppo as j_ppo
from legged_tracking_tpu.learn import runner as j_runner

LOSSES = ("value_loss", "surrogate_loss", "adaptation_loss", "adaptation_test_loss",
          "kl_mean", "mean_reward_per_step", "action_std_mean")


def curriculum_cfg(Cfg, config_go1):
    """tests/test_runner.py's plane env, with a fix-target curriculum whose
    every branch a short scripted stream can fire: advance above 0.8,
    downstep below 0.3, a 3-iteration stagnation probe, restore-best on,
    distances 0.6 (not float32-representable) to 1.4 in steps of 0.5."""
    cfg = config_go1(Cfg())
    cfg.env.num_observation_history = 3
    cfg.env.num_envs = 8
    cfg.terrain.mesh_type = "plane"
    cfg.env.command_type = "xy"
    cfg.terrain.measure_front_half = True
    cfg.control.control_type = "P"
    cfg.env.episode_length_s = 2.0
    cfg.control.decimation = 2
    ct = cfg.curriculum_thresholds
    ct.cl_fix_target = True
    ct.cl_start_target_dist = 0.6
    ct.cl_goal_target_dist = 1.4
    ct.cl_switch_delta = 0.5
    ct.cl_switch_threshold = 0.8
    ct.cl_downstep_threshold = 0.3
    ct.cl_stagnation_probe = 3
    ct.cl_restore_best_on_downstep = True
    return cfg


@pytest.fixture(scope="module")
def envs():
    return (JEnv(curriculum_cfg(Cfg, config_go1)),
            TEnv(curriculum_cfg(TCfg, t_config_go1), device="cpu"))


def row(n, reach, frontier=None):
    """One iteration's episodes: (count, reached mean) of the train envs,
    and of the frontier slice and the eval envs when ``frontier`` is given."""
    r = {"": (n, reach)}
    if frontier is not None:
        r["frontier_"] = frontier
        r["eval_"] = (3, 0.5)
    return r


# Window full after two iterations of 2000 episodes.  it1 advances (0.6 ->
# 1.1), the probe fires at it4 (1.1 -> 1.4, clamped at the goal), it6 and
# it9 downstep and restore the best snapshot, it7 ends no episode, it11's
# downstep at the start distance restores nothing (the 1e-4 slack), it13
# advances again.
CURRICULUM = ([row(2000, 0.9)] * 2 + [row(2000, 0.75)] * 3 + [row(2000, 0.1)] * 2
              + [row(0, 0.0)] + [row(2000, 0.1)] * 4 + [row(2000, 1.0)] * 2)
# The best snapshot's window (0.2, logged at it0) is under the downstep
# bar, so it2's real downstep (1.1 -> 0.6) restores nothing.
WEAK_BEST = [row(4000, 0.2), row(4000, 0.95), row(4000, 0.1), row(4000, 0.5)]
# Rehearsal mixing: the gate reads the frontier slice (advancing twice),
# not the train envs' 0.1 (which would downstep).
FRONTIER = [row(2000, 0.1, frontier=(2000, 0.95))] * 5

CASES = {
    "curriculum": dict(rows=CURRICULUM, log_freq=2, save_interval=3, update_model=True),
    "restore_gates": dict(rows=WEAK_BEST, log_freq=3, save_interval=3, update_model=True),
    "frontier": dict(rows=FRONTIER, log_freq=1, save_interval=2, update_model=True),
    "freeze_model": dict(rows=CURRICULUM[:5], log_freq=2, save_interval=3, update_model=False),
}


def stream(rows, K, seed=0):
    """The scripted metrics of each iteration, as numpy: the losses and
    the learning rate, and the episodic metrics of each population."""
    rng = np.random.RandomState(seed)
    out = []
    for i, r in enumerate(rows):
        m = {k: np.float32(rng.uniform(-1, 1)) for k in LOSSES}
        m["learning_rate"] = np.float32(1e-3 * (1 + 0.1 * i))
        for prefix, (n, reach) in r.items():
            m[prefix + "num_episodes"] = np.int64(n)
            m[prefix + "reached_mean"] = np.float32(reach)
            m[prefix + "episode_sums_mean"] = rng.uniform(-1, 1, K).astype(np.float32)
            m[prefix + "episode_length_mean"] = np.float32(rng.uniform(10, 40))
            m[prefix + "goal_distance_mean"] = np.float32(rng.uniform(0, 2))
        out.append(m)
    return out


def runner_state(r, ts, target_dist, std):
    return (float(target_dist), r._restore_count, r._best_it,
            tuple(float(x) for x in r._best_score), int(ts.iteration),
            float(ts.learning_rate), float(std), len(r._reached_window),
            getattr(r, "_its_since_switch", 0))


def drive_jax(env, case, logdir, metrics):
    r = j_runner.Runner(env, runner_args=j_runner.RunnerArgs(
        num_steps_per_env=4, log_freq=case["log_freq"], save_interval=case["save_interval"]),
        ppo_args=j_ppo.PPOArgs(num_steps_per_env=4), logdir=logdir, seed=3)
    std0 = float(np.asarray(r.train_state.params["params"]["std"])[0])
    std = lambda ts: float(np.asarray(ts.params["params"]["std"])[0]) - std0
    trace = []

    def train_iteration_jit(ts, es, obs, key, update_model=True):
        trace.append(runner_state(r, ts, es.target_dist, std(ts)))
        m = metrics[len(trace) - 1]
        if update_model:
            p = ts.params["params"]
            ts = ts._replace(params={**ts.params, "params": {**p, "std": p["std"] + 1.0}},
                             learning_rate=jnp.asarray(m["learning_rate"]),
                             iteration=ts.iteration + 1)
        return ts, es, obs, {k: jnp.asarray(v) for k, v in m.items()}

    r.alg.train_iteration_jit = train_iteration_jit
    r.learn(len(metrics), verbose=False, update_model=case["update_model"])
    trace.append(runner_state(r, r.train_state, r.env_state.target_dist, std(r.train_state)))
    ckpt_std = lambda c: float(c["params"]["params"]["std"][0]) - std0
    return r.history, trace, ckpt_std


def drive_port(env, case, logdir, metrics):
    r = t_runner.Runner(env, runner_args=t_runner.RunnerArgs(
        num_steps_per_env=4, log_freq=case["log_freq"], save_interval=case["save_interval"]),
        ppo_args=t_ppo.PPOArgs(num_steps_per_env=4), logdir=logdir, seed=3)
    std0 = float(r.train_state.params["std"][0].detach())
    std = lambda ts: float(ts.params["std"][0].detach()) - std0
    trace = []

    def train_iteration(ts, es, obs, update_model=True):
        trace.append(runner_state(r, ts, es.target_dist, std(ts)))
        m = metrics[len(trace) - 1]
        if update_model:
            with torch.no_grad():
                ts.params["std"].add_(1.0)
            ts = ts._replace(learning_rate=torch.tensor(m["learning_rate"]),
                             iteration=ts.iteration + 1)
        return ts, es, obs, {k: torch.as_tensor(np.asarray(v)) for k, v in m.items()}

    r.alg.train_iteration = train_iteration
    r.learn(len(metrics), verbose=False, update_model=case["update_model"])
    trace.append(runner_state(r, r.train_state, r.env_state.target_dist, std(r.train_state)))
    ckpt_std = lambda c: float(c["params"]["params"]["std"][0]) - std0
    return r.history, trace, ckpt_std


def without_fps(recs):
    for rec in recs:
        assert np.isfinite(rec["fps"])
    return [{k: v for k, v in rec.items() if k != "fps"} for rec in recs]


@pytest.mark.parametrize("name", list(CASES))
def test_learn_matches_jax(envs, name, tmp_path):
    """Runner.learn of both packages on one scripted stream: equal state
    before every iteration and at the end, equal records, equal files."""
    jenv, tenv = envs
    case = CASES[name]
    assert jenv.metric_names == tenv.metric_names
    metrics = stream(case["rows"], len(jenv.metric_names))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jhist, jtrace, jstd = drive_jax(jenv, case, str(jdir), metrics)
    thist, ttrace, tstd = drive_port(tenv, case, str(tdir), metrics)

    assert ttrace == jtrace
    assert [sorted(r) for r in thist] == [sorted(r) for r in jhist]
    assert without_fps(thist) == without_fps(jhist)
    jrecs = [json.loads(line) for line in open(jdir / "metrics.jsonl")]
    trecs = [json.loads(line) for line in open(tdir / "metrics.jsonl")]
    assert without_fps(trecs) == without_fps(jrecs) == without_fps(jhist)

    files = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == files
    for f in files:
        if f.startswith("ac_weights"):
            with open(jdir / f, "rb") as fj, open(tdir / f, "rb") as ft:
                cj, ct = pickle.load(fj), pickle.load(ft)
            for k in ("iteration", "target_dist", "learning_rate"):
                assert ct[k] == cj[k], (f, k)
            assert tstd(ct) == jstd(cj), f
    if "best.json" in files:
        assert json.load(open(tdir / "best.json")) == json.load(open(jdir / "best.json"))
    assert sorted(np.load(tdir / "policy.npz")) == sorted(np.load(jdir / "policy.npz"))

    # the scripted cases fire what they are meant to
    restores = {"curriculum": 2, "restore_gates": 0, "frontier": 0, "freeze_model": 0}
    assert ttrace[-1][1] == restores[name]
    if name == "curriculum":
        assert [round(t[0], 6) for t in ttrace] == [0.6, 0.6, 1.1, 1.1, 1.1, 1.4, 1.4, 0.9,
                                                    0.9, 0.9, 0.6, 0.6, 0.6, 0.6, 1.1]
        assert "ac_weights_best.pkl" in files and "ac_weights_000012.pkl" in files
    if name == "frontier":
        assert round(ttrace[-1][0], 6) == 1.4
    if name == "freeze_model":
        assert ttrace[-1][4] == 0 and ttrace[-1][0] == ttrace[0][0]
