"""The port's actuator-net trainer (``legged_tracking_torch/train_actuator_net.py``)
against ``scripts/train_actuator_net.py`` on the CPU, on a joint log the
port's sim writes (the bench configuration, 4 envs on 2x2 tiles, 50 steps):
the dataset bitwise, a 2-epoch fit from the JAX script's own initial
weights, and the written npz in both packages' actuator loaders."""

import argparse
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
import torch_support  # noqa: F401

import chip_smoke
from legged_tracking_torch import train_actuator_net as tam
from legged_tracking_torch.actuation import actuators as t_act
from legged_tracking_torch.envs import LeggedEnv
from legged_tracking_tpu.actuation import actuators as j_act

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T = 4, 50


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "scripts_train_actuator_net", os.path.join(ROOT, "scripts", "train_actuator_net.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_TAM = jax_script()


@pytest.fixture(scope="module")
def sim_log():
    """(N, T, 12) arrays of the port's bench env driven by a fixed function
    of its observations."""
    env = LeggedEnv(chip_smoke.bench_cfg(N, tiles=2), seed=0, device="cpu")
    log = tam.record_log(env, lambda obs, hist: 0.5 * torch.sin(3.0 * obs[:, 5:17]), T)
    assert {k: tuple(v.shape) for k, v in log.items()} == {k: (N, T, 12) for k in tam.LOG_KEYS}
    return {k: v.numpy() for k, v in log.items()}


def jax_initial_weights(seed):
    """The three ``jax.random`` draws of scripts/train_actuator_net.py:50-61."""
    k0, k1, k2 = jax.random.split(jax.random.key(seed), 3)
    out = {}
    for i, (k, (fan_in, fan_out)) in enumerate(zip((k0, k1, k2), tam.LAYERS)):
        w = jax.random.uniform(k, (fan_out, fan_in), minval=-1, maxval=1) / np.sqrt(fan_in)
        out[f"w{i}"] = np.asarray(w)
        out[f"b{i}"] = np.zeros(fan_out, np.float32)
    return out


def test_build_dataset_bitwise(sim_log):
    """One env's (T, 12) log, and all envs' (N, T, 12) log against the JAX
    script's datasets concatenated in env order: bitwise, float32, t-major
    and joint-minor; also from a float64 log."""
    X, Y = tam.build_dataset(sim_log)
    parts = [J_TAM.build_dataset({k: v[e] for k, v in sim_log.items()}) for e in range(N)]
    assert X.shape == (N * (T - 2) * 12, 6) and Y.shape == (N * (T - 2) * 12, 1)
    assert X.dtype == Y.dtype == np.float32
    np.testing.assert_array_equal(X, np.concatenate([p[0] for p in parts]))
    np.testing.assert_array_equal(Y, np.concatenate([p[1] for p in parts]))
    one64 = {k: v[1].astype(np.float64) for k, v in sim_log.items()}
    for a, b in zip(tam.build_dataset(one64), J_TAM.build_dataset(one64)):
        np.testing.assert_array_equal(a, b)


def test_init_weights_rule():
    """The default initial weights follow the reference's rule: (out, in),
    within +-1/sqrt(in), zero biases; seeded."""
    w = tam.init_weights(0)
    for i, (fan_in, fan_out) in enumerate(tam.LAYERS):
        assert w[f"w{i}"].shape == (fan_out, fan_in) and w[f"w{i}"].dtype == np.float32
        assert np.abs(w[f"w{i}"]).max() <= 1.0 / np.sqrt(fan_in)
        np.testing.assert_array_equal(w[f"b{i}"], np.zeros(fan_out))
    np.testing.assert_array_equal(w["w1"], tam.init_weights(0)["w1"])
    assert not np.array_equal(w["w1"], tam.init_weights(1)["w1"])


# the JAX script's `main` on the log (its np.savez captured, so nothing is
# written) against the port's `fit` from the same initial weights: 2 epochs
# of 9 minibatches of 256 (2,376 samples; the last 72 dropped).  float32
# products in another order part the weights by at most 3.0e-8 here (of
# weights up to 0.42); the bar is atol 5e-7, rtol 1e-5
FIT_ATOL, FIT_RTOL = 5e-7, 1e-5


def test_fit_matches_jax_main(sim_log, tmp_path, monkeypatch, capsys):
    flat = {k: v.reshape(-1, 12) for k, v in sim_log.items()}    # one (N*T, 12) trace
    path = str(tmp_path / "log.npz")
    np.savez(path, **flat)
    captured = {}
    monkeypatch.setattr(np, "savez", lambda out, **arrays: captured.update(arrays))
    J_TAM.main(argparse.Namespace(log=path, name="parity", epochs=2, batch=256, lr=8e-4,
                                  seed=0, cpu=True))
    monkeypatch.undo()
    printed = [float(line.split()[-1]) for line in capsys.readouterr().out.splitlines()
               if line.startswith("epoch")]

    X, Y = tam.build_dataset(flat)
    res = tam.fit(X, Y, epochs=2, batch=256, lr=8e-4, seed=0, device="cpu",
                  weights=jax_initial_weights(0))
    assert res.minibatches == len(range(0, X.shape[0] - 256, 256)) == 9
    assert sorted(captured) == sorted(res.weights)
    for k, v in res.weights.items():
        np.testing.assert_allclose(v, captured[k], atol=FIT_ATOL, rtol=FIT_RTOL, err_msg=k)
    assert len(res.losses) == 2 and res.losses[1] < res.losses[0]
    np.testing.assert_allclose(res.losses, printed, atol=1e-5)


def test_batch_loop_drops_a_whole_last_batch():
    """``range(0, n - batch, batch)``: with batch dividing n the last whole
    batch is dropped too, as in the reference."""
    X = np.random.RandomState(0).randn(64, 6).astype(np.float32)
    res = tam.fit(X, X[:, :1], epochs=1, batch=16, device="cpu")
    assert res.minibatches == 3


def test_written_npz_loads_into_both_packages(tmp_path, monkeypatch, sim_log):
    """save_npz's file read by both packages' ``load_actuator_net``: the same
    torques on the log's inputs (float32 products in another order)."""
    res = tam.fit(*tam.build_dataset(sim_log), epochs=1, batch=512, device="cpu")
    tam.save_npz(str(tmp_path / "fitted.npz"), res.weights)
    monkeypatch.setattr(t_act, "_ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(j_act, "_ASSET_DIR", str(tmp_path))
    t_net = t_act.load_actuator_net("fitted", device="cpu")
    j_net = j_act.load_actuator_net("fitted")
    for k, v in res.weights.items():
        np.testing.assert_array_equal(np.asarray(getattr(j_net, k)), v)
    x = tam.build_dataset(sim_log)[0][:1200].reshape(100, 12, 6)
    tau_t = t_net(torch.as_tensor(x)).numpy()
    tau_j = np.asarray(jax.jit(j_act.actuator_net_torque)(j_net, x))
    np.testing.assert_allclose(tau_t, tau_j, atol=1e-5, rtol=1e-5)


def test_main_writes_the_asset(tmp_path, monkeypatch, sim_log):
    """The entry's flags and output: ``<ASSET_DIR>/<name>.npz`` (redirected
    here to a temporary directory) from an npz log."""
    path = str(tmp_path / "log.npz")
    np.savez(path, **{k: v[0] for k, v in sim_log.items()})
    monkeypatch.setattr(tam, "ASSET_DIR", str(tmp_path))
    tam.main(tam.parse_args(["--log", path, "--name", "n", "--epochs", "1", "--batch", "64",
                             "--device", "cpu"]))
    out = np.load(str(tmp_path / "n.npz"))
    assert sorted(out) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    assert out["w1"].shape == (32, 32)
