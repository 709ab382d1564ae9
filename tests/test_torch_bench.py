"""The port's bench entry (``legged_tracking_torch/bench.py``) against the
repo's ``bench.py`` on the CPU: the configuration and PPO arguments its
build makes, field by field, with no ``BENCH_*`` variable set and under
each one the port acts on or stores; its main at 4 envs; the roofline's
two FLOP counts; and the data-parallel scaling tool over gloo ranks.

The JAX build is captured without building anything: its ``LeggedEnv`` is
a stub that records the configuration, and its ``PPO`` one that records
the arguments and stops the build.
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch
from torch_support import cfg_tree

import legged_tracking_tpu.envs
import legged_tracking_tpu.learn
from legged_tracking_torch import bench as t_bench
from legged_tracking_torch.learn.actor_critic import MLP
from legged_tracking_torch.tools import ji22_ledger as t_ji22
from legged_tracking_torch.tools import profile_bench as t_profile
from legged_tracking_torch.tools import roofline as t_roof
from legged_tracking_torch.tools import scaling_bench as t_scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_BENCH = _load("jax_bench", "bench.py")
J_ROOF = _load("jax_tools_roofline", "tools/roofline.py")
BENCH_VARS = ("BENCH_NUM_ENVS", "BENCH_LANE", "BENCH_FUSED", "BENCH_PATCH_X", "BENCH_PATCH_Y",
              "BENCH_GRANULE", "BENCH_LAYER", "BENCH_INTERLEAVED", "BENCH_PALLAS_SCAN",
              "BENCH_PMS", "BENCH_PMS_RESCAN", "BENCH_PMS_DIRECT", "BENCH_SHUFFLE",
              "BENCH_WINDOW", "BENCH_ITERS", "BENCH_ITERS_PER_CALL")


class _Captured(Exception):
    pass


def jax_build_config(monkeypatch):
    """(cfg, PPOArgs) the JAX ``bench.build`` makes under the current
    environment, with nothing built."""
    seen = {}

    def env_stub(cfg):
        seen["cfg"] = cfg
        return object()

    def ppo_stub(env, args):
        seen["args"] = args
        raise _Captured

    monkeypatch.setattr(legged_tracking_tpu.envs, "LeggedEnv", env_stub)
    monkeypatch.setattr(legged_tracking_tpu.learn, "PPO", ppo_stub)
    with pytest.raises(_Captured):
        J_BENCH.build()
    return seen["cfg"], seen["args"]


@pytest.fixture
def clean_env(monkeypatch):
    for var in BENCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# the knobs the port acts on, then the JAX layout knobs it stores unread
KNOBS = [{}, {"BENCH_NUM_ENVS": "2048"}, {"BENCH_PATCH_X": "16"}, {"BENCH_PATCH_Y": "24"},
         {"BENCH_PMS": "1"}, {"BENCH_PMS": "1", "BENCH_PMS_RESCAN": "1"},
         {"BENCH_PMS": "1", "BENCH_PMS_DIRECT": "1"}, {"BENCH_SHUFFLE": "1"},
         {"BENCH_WINDOW": "1"},
         {"BENCH_LANE": "0", "BENCH_FUSED": "0", "BENCH_GRANULE": "0", "BENCH_LAYER": "1",
          "BENCH_INTERLEAVED": "1", "BENCH_PALLAS_SCAN": "1"}]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "+".join(k) or "defaults")
def test_bench_config_matches_jax_build(clean_env, knobs):
    """The port's bench configuration and PPO arguments are the JAX build's,
    field by field, with no variable set and under each knob."""
    for k, v in knobs.items():
        clean_env.setenv(k, v)
    jcfg, jargs = jax_build_config(clean_env)
    tcfg, targs = t_bench.bench_config()
    assert cfg_tree(tcfg) == cfg_tree(jcfg)
    assert vars(targs) == vars(jargs)


def test_bench_main_prints_the_jax_line(clean_env, capsys):
    """``bench.main`` at 4 envs (on 2x2 tiles, the most they fill evenly),
    one timed call of one iteration, on the CPU: the last line has the JAX line's four keys and a
    finite positive rate; the line before counts B1's launches (none: the
    CPU runs the plain version)."""
    for k, v in {"BENCH_NUM_ENVS": "4", "BENCH_ITERS": "1", "BENCH_ITERS_PER_CALL": "1"}.items():
        clean_env.setenv(k, v)
    t_bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    last, run = json.loads(lines[-1]), json.loads(lines[-2])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "train_env_steps_per_s" and last["unit"] == "env-steps/s"
    assert math.isfinite(last["value"]) and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / 1093.8, 2)
    assert run["envs"] == 4 and run["card"] == "cpu" and run["scan_heights_launches"] == 0


ON_CUDA = {
    "bench.build": lambda: t_bench.build(),
    "bench.main": lambda: t_bench.main([]),
    "profile_bench.main": lambda: t_profile.main(["--ops"]),
    "roofline.main": lambda: t_roof.main(["--ms-per-iter", "100"]),
    "ji22_ledger.make_env": lambda: t_ji22.make_env(0.0, 4),
}


@pytest.mark.parametrize("entry", sorted(ON_CUDA))
def test_entries_raise_on_cuda_without_a_card(clean_env, entry):
    """The entries default to the card and raise without one; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    clean_env.setenv("BENCH_NUM_ENVS", "4")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ON_CUDA[entry]()


# ------------------------------------------------------------------ roofline
@pytest.mark.parametrize("kw", [
    {}, {"num_priv": 8},
    {"num_envs": 1024, "steps": 12, "epochs": 3, "num_obs": 70, "history": 30, "num_priv": 2},
    {"num_envs": 4000, "num_actions": 16, "hidden": (256, 128, 64), "adapt_hidden": (128, 64, 32)},
], ids=["defaults", "bench_widths", "velocity_like", "other_mlps"])
def test_model_flops_per_iter_matches_jax_tool(kw):
    """The JAX tool's count, kept in the port: equal to it exactly."""
    assert t_roof.model_flops_per_iter(**kw) == J_ROOF.model_flops_per_iter(**kw)


def test_iteration_flop_of_the_bench_policy():
    """The shape count of the port's bench policy (widths read from the
    built module: 3915 history, 8 privileged, 12 actions) at 4096 envs,
    24 steps, 5 epochs: the rollout's forward passes plus the update."""
    ac, ppo = t_roof.bench_policy("cpu")
    got = t_roof.iteration_flop(ac, 4096, ppo.num_steps_per_env, ppo.num_learning_epochs)
    assert got == {"rollout": 1_058_248_065_024, "update": 14_984_109_096_960,
                   "total": 1_058_248_065_024 + 14_984_109_096_960}
    assert got["total"] == 16_042_357_161_984


def test_update_flop_of_a_toy_policy_matches_a_hand_count():
    """Two-layer MLPs: actor 5->4->3 (every layer forward, weight and input
    gradient), critic 5->4->1 (its first layer without an input gradient),
    adaptation module 3->2->2 (the same, run twice)."""
    ac = torch.nn.Module()
    ac.actor_body, ac.critic_body, ac.adaptation_module = MLP(5, [4], 3), MLP(5, [4], 1), \
        MLP(3, [2], 2)
    actor = 3 * (5 * 4 + 4 * 3)                  # 96
    critic = 3 * (5 * 4 + 4 * 1) - 5 * 4         # 52
    adapt = 2 * (3 * (3 * 2 + 2 * 2) - 3 * 2)    # 48
    assert t_roof.update_flop(ac, 10) == 2 * (actor + critic + adapt) * 10 == 3920


# ------------------------------------------------------------------- scaling
def test_scaling_bench_gloo_ranks_print_the_jax_keys(monkeypatch, capsys):
    """scaling_bench at 1 and 2 gloo ranks on the CPU (8 total envs, one
    timed iteration of 4 steps an env): the JAX summary's keys, a finite
    time for each count, each rank's share of the envs, nothing written."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    t_scaling.main(["--device", "cpu", "--devices", "1", "2", "--total_envs", "8", "--iters",
                    "1", "--steps_per_env", "4"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"total_envs", "iters", "ms_per_iter", "sharding_overhead", "note"} <= set(summary)
    assert summary["total_envs"] == 8 and summary["iters"] == 1
    assert set(summary["ms_per_iter"]) == {"1", "2"}
    assert all(np.isfinite(v) and v > 0 for v in summary["ms_per_iter"].values())
    assert summary["sharding_overhead"]["1"] == 0.0
    assert [r["local_envs"] for r in summary["ranks"]["2"]] == [4, 4]
    assert {r["backend"] for rs in summary["ranks"].values() for r in rs} == {"gloo"}
