"""The port's measurement tools (``legged_tracking_torch/tools/``) against
the repo's ``tools/`` on the CPU: the per-line trace attribution of
``analyze_trace`` against the JAX tool's on synthetic traces of the same
device time, the idle share and the unattributed time; the policy GEMMs'
time ``roofline`` reads from a trace; ``profile_bench --ops`` at 4 envs; the ji22 stand ledger; and the planner menu's tunnels.
"""

import gzip
import importlib.util
import json
import os
import re

import jax
import numpy as np
import pytest
from torch_support import VelocityDraws, install_velocity_draws, to_numpy, uninstall

from legged_tracking_torch import bench as t_bench
from legged_tracking_torch import convert
from legged_tracking_torch.learn.ppo import PPOArgs
from legged_tracking_torch.tools import analyze_trace as t_at
from legged_tracking_torch.tools import ji22_ledger as t_ji22
from legged_tracking_torch.tools import planner_menu_bench as t_menu
from legged_tracking_torch.tools import profile_bench as t_profile
from legged_tracking_torch.tools import roofline as t_roof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_AT = _load("jax_tools_analyze_trace", "tools/analyze_trace.py")
J_JI22 = _load("jax_tools_ji22_ledger", "tools/ji22_ledger.py")
J_MENU = _load("jax_tools_planner_menu_bench", "tools/planner_menu_bench.py")


# ------------------------------------------------------------ trace parity
# device us by source line, each line's time split over two ops/kernels:
# (file, line, first us, second us)
LINES = [("envs/legged_env.py", 120, 5000, 2500), ("learn/actor_critic.py", 65, 3000, 4600),
         ("terrain/scan.py", 107, 1500, 250), ("physics/contact.py", 78, 900, 20)]


def jax_trace(tmp_path):
    """A jax.profiler trace directory (an "XLA Ops" thread) and an HLO dump
    whose ops carry the lines' source metadata."""
    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 2, "args": {"name": "XLA Ops"}},
              {"ph": "M", "name": "thread_name", "pid": 1, "tid": 3, "args": {"name": "Steps"}}]
    hlo, ts = [], 0
    for i, (f, line, *durs) in enumerate(LINES):
        for j, d in enumerate(durs):
            op = f"fusion.{i}{j}"
            events.append({"ph": "X", "pid": 1, "tid": 2, "name": op, "ts": ts, "dur": d})
            hlo.append(f'  %{op} = f32[4]{{0}} fusion(f32[4]{{0}} %p), kind=kLoop, '
                       f'metadata={{op_name="jit(step)/mul" '
                       f'source_file="/w/legged_tracking_tpu/{f}" source_line={line}}}')
            ts += d
    events.append({"ph": "X", "pid": 1, "tid": 3, "name": "step", "ts": 0, "dur": ts})
    run = tmp_path / "jax" / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    with gzip.open(run / "host.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    (tmp_path / "hlo.txt").write_text("\n".join(hlo) + "\n")
    return str(tmp_path / "jax"), str(tmp_path / "hlo.txt")


def torch_trace(extra=()):
    """A torch.profiler Chrome trace of the same device time on the same
    lines.  Each line's frame launches its first kernel through a frame
    outside the port inside an aten op; its second share is a backward
    kernel, launched on the autograd thread by the node with that op's
    sequence number.  The scan line launches through ctypes, with no aten
    op: its second share is a memcpy it launches itself.  Two program spans
    enclose the first three lines' launches, ``env.step``, and inside it the
    second line's launch and a sync, ``env.physics``.  ``extra`` events are
    appended."""
    ev, corr, t_host, t_dev = [], 0, 0, 0

    def device(d, cat, name, tid, ts, call="cudaLaunchKernel"):
        nonlocal corr, t_dev
        corr += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": call, "pid": 1, "tid": tid,
                   "ts": ts, "dur": 5, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": t_dev,
                   "dur": d, "args": {"correlation": corr}})
        t_dev += d

    for i, (f, line, first, second) in enumerate(LINES):
        ev.append({"ph": "X", "cat": "python_function", "pid": 1, "tid": 10, "ts": t_host,
                   "dur": 100, "args": {},
                   "name": f"/w/legged_tracking_torch/{f}({line}): fn{i}"})
        ev.append({"ph": "X", "cat": "python_function", "name": "torch/nn/functional.py(9): f",
                   "pid": 1, "tid": 10, "ts": t_host + 5, "dur": 80, "args": {}})
        if f == "terrain/scan.py":
            device(first, "kernel", f"scan_heights_kernel{i}", 10, t_host + 20)
            device(second, "gpu_memcpy", "Memcpy DtoH", 10, t_host + 30, "cudaMemcpyAsync")
        else:
            ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1, "tid": 10,
                       "ts": t_host + 10, "dur": 60,
                       "args": {"Sequence number": 40 + i, "Fwd thread id": 0}})
            device(first, "kernel", f"k{i}", 10, t_host + 20)
            ev.append({"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 11, "ts": 5000 + t_host,
                       "dur": 50, "name": "autograd::engine::evaluate_function: MulBackward0",
                       "args": {"Sequence number": 40 + i, "Fwd thread id": 1}})
            device(second, "gpu_memset" if i == 3 else "kernel", f"b{i}", 11, 5010 + t_host)
        t_host += 200
    ev += [{"ph": "X", "cat": "program_span", "name": "env.step", "pid": 1, "tid": 10, "ts": 0,
            "dur": 450, "args": {"syncs": 0, "sync_sites": {}}},
           {"ph": "X", "cat": "program_span", "name": "env.physics", "pid": 1, "tid": 10,
            "ts": 190, "dur": 70,
            "args": {"syncs": 1, "sync_sites": {"/w/legged_tracking_torch/physics/fk.py:48": 1},
                     "graph": 1, "captures": 1}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "pid": 1,
            "tid": 10, "ts": 240, "dur": 5, "args": {}}]
    return {"traceEvents": ev + list(extra)}


def printed_tables(text, top_header):
    """{section: [(ms, tag), ...]} of the "by file" and top-lines sections."""
    out, cur = {}, None
    for line in text.splitlines():
        if line.startswith("by file"):
            cur = out.setdefault("file", [])
        elif line.startswith(top_header):
            cur = out.setdefault("line", [])
        elif not line.strip():
            cur = None
        elif cur is not None:
            ms, tag = line.split()
            cur.append((ms, tag))
    return out


def test_trace_tables_match_the_jax_tool(tmp_path, capsys, monkeypatch):
    """The same device time on the same source lines, as a JAX trace with
    an HLO dump and as a torch trace: both tools print the same by-file and
    by-line tables, the port naming a file by its path in the package where
    the JAX tool names it by its base name."""
    jdir, hlo = jax_trace(tmp_path)
    path = tmp_path / "torch.json"
    path.write_text(json.dumps(torch_trace()))
    monkeypatch.setattr("sys.argv", ["analyze_trace", jdir, hlo, "--iters", "2", "--top", "10"])
    J_AT.main()
    jax_out = capsys.readouterr().out
    t_at.main([str(path), "--iters", "2", "--top", "10"])
    torch_out = capsys.readouterr().out

    jt = printed_tables(jax_out, "top 10 source lines")
    tt = printed_tables(torch_out, "top 10 source lines")
    base = lambda tab: [(ms, os.path.basename(tag)) for ms, tag in tab]
    assert base(tt["file"]) == jt["file"] and len(jt["file"]) == len(LINES)
    assert base(tt["line"]) == jt["line"] and len(jt["line"]) == len(LINES)
    assert [tag for _, tag in tt["line"]][:2] == ["learn/actor_critic.py:65",
                                                  "envs/legged_env.py:120"]


def test_trace_idle_share_and_unattributed_time():
    """Device time no port frame encloses (a launch outside the port, a
    device event with no runtime call) is ``<unattributed>``, never
    dropped; the busy time is the union of the device's intervals (two of
    them overlap) and the idle share is exact over the traced window."""
    extra = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
              "tid": 10, "ts": 900, "dur": 5, "args": {"correlation": 900}},
             {"ph": "X", "cat": "kernel", "name": "stray", "pid": 0, "tid": 7, "ts": 20000,
              "dur": 64, "args": {"correlation": 900}},
             {"ph": "X", "cat": "kernel", "name": "orphan", "pid": 0, "tid": 8, "ts": 20032,
              "dur": 96, "args": {}}]
    events = torch_trace(extra)["traceEvents"]
    s = t_at.summarize(events, iters=1)
    device_us = sum(a + b for _, _, a, b in LINES)
    lines = dict(s["by_line"])
    assert lines["<unattributed>"] == (64 + 96) / 1e3
    assert s["device_ms_per_iter"] == (device_us + 160) / 1e3
    assert s["port_share"] == 1.0 - 160 / (device_us + 160)
    busy = device_us + 128                     # [20000, 20064) and [20032, 20128)
    window = 20128 - 0
    assert s["busy_ms_per_iter"] == busy / 1e3 and s["window_ms_per_iter"] == window / 1e3
    assert s["idle_share"] == 1.0 - busy / window
    assert s["kernel_files"]["scan_heights_kernel2"] == {"terrain/scan.py": 1500 / 1e3}


def test_trace_by_span_table(tmp_path, capsys):
    """Device time, kernels, launches and syncs are filed under the innermost
    program span in flight at their runtime call (a memcpy is no launch nor
    kernel; a CUDA graph's kernels count under its ``cudaGraphLaunch``,
    which is no launch; what no
    span encloses, the backward kernels among it, is ``<no span>``), and
    the longest idle gaps under the innermost span at their middle; the
    spans' own sync counts and sites are summed, and so is every counter a
    span carries (bytes, the physics step's graph replays and captures, the
    GRU's steps and rows), 0 where a span has none; a trace with no
    stacks and no port frame needs nothing else."""
    extra = [{"ph": "X", "cat": "program_span", "name": "env.observe", "pid": 1, "tid": 10,
              "ts": 29990, "dur": 610, "args": {"syncs": 0, "sync_sites": {}, "bytes": 64}},
             {"ph": "X", "cat": "program_span", "name": "policy.gru", "pid": 1, "tid": 10,
              "ts": 28000, "dur": 500,
              "args": {"syncs": 0, "sync_sites": {}, "steps": 15, "rows": 4096}}]
    for corr, (ts, dev) in enumerate([(30000, 30000), (30010, 30400)], start=950):
        extra += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                   "tid": 10, "ts": ts, "dur": 5, "args": {"correlation": corr}},
                  {"ph": "X", "cat": "kernel", "name": f"late{corr}", "pid": 0, "tid": 7,
                   "ts": dev, "dur": 100, "args": {"correlation": corr}}]
    extra += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "pid": 1, "tid": 10,
               "ts": 250, "dur": 5, "args": {"correlation": 960}}]
    extra += [{"ph": "X", "cat": "kernel", "name": f"node{k}", "pid": 0, "tid": 8,
               "ts": 30020 + 40 * k, "dur": 20, "args": {"correlation": 960}} for k in range(2)]
    events = [e for e in torch_trace(extra)["traceEvents"] if e.get("cat") != "python_function"]
    s = t_at.summarize(events, iters=2)
    rows = {r["span"]: r for r in s["by_span"]}
    assert rows["env.step"] == {"span": "env.step", "spans": 0.5, "host_ms_per_iter": 450 / 2e3,
                                "device_ms_per_iter": (5000 + 1500 + 250) / 2e3,
                                "kernels": 1.0, "launches": 1.0, "syncs": 0.0, "tracer_syncs": 0.0,
                                "bytes": 0.0, "graph": 0.0, "captures": 0.0, "rows": 0.0,
                                "steps": 0.0}
    assert rows["env.physics"] == {"span": "env.physics", "spans": 0.5,
                                   "host_ms_per_iter": 70 / 2e3,
                                   "device_ms_per_iter": (3000 + 40) / 2e3,
                                   "kernels": 1.5, "launches": 0.5, "syncs": 0.5, "tracer_syncs": 0.5,
                                   "bytes": 0.0, "graph": 0.5, "captures": 0.5, "rows": 0.0,
                                   "steps": 0.0}
    assert rows["policy.gru"] == {"span": "policy.gru", "spans": 0.5,
                                  "host_ms_per_iter": 500 / 2e3, "device_ms_per_iter": 0.0,
                                  "kernels": 0.0, "launches": 0.0, "syncs": 0.0,
                                  "tracer_syncs": 0.0, "bytes": 0.0, "graph": 0.0,
                                  "captures": 0.0, "rows": 2048.0, "steps": 7.5}
    assert rows["env.observe"]["device_ms_per_iter"] == 200 / 2e3
    assert rows["env.observe"]["launches"] == 1.0 and rows["env.observe"]["bytes"] == 32
    assert rows["<no span>"]["device_ms_per_iter"] == (2500 + 4600 + 900 + 20) / 2e3
    assert rows["<no span>"]["launches"] == 2.0 and rows["<no span>"]["spans"] == 0
    device_end = sum(a + b for _, _, a, b in LINES)
    assert s["idle_gaps"] == [["<no span>", (30000 - device_end) / 1e3],
                              ["env.observe", 0.3], ["env.observe", 0.1]]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t_at.main([str(path), "--iters", "2"])
    out = capsys.readouterr().out
    assert s["sync_sites"] == [["env.physics", "physics/fk.py:48", 0.5]]
    assert "by span, per iter" in out and "longest 3 idle gaps" in out and "fk.py:48" in out
    assert "counters: bytes, captures, graph, rows, steps" in out
    assert s["span_counters"] == ["bytes", "captures", "graph", "rows", "steps"]


def launched(frame, kernel, ts, dur, corr):
    """A port frame launching ``kernel`` at ``ts`` (host) and running it
    for ``dur`` us from ``ts`` (device)."""
    return [{"ph": "X", "cat": "python_function", "pid": 1, "tid": 10, "ts": ts, "dur": 50,
             "args": {}, "name": f"/w/legged_tracking_torch/{frame}: fn"},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 10,
             "ts": ts + 10, "dur": 5, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": kernel, "pid": 0, "tid": 7, "ts": ts,
             "dur": dur, "args": {"correlation": corr}}]


def test_roofline_takes_the_policy_gemm_time_from_a_trace(tmp_path, capsys):
    """``roofline --from-trace`` reads only the policy products' device time
    from a trace (the GEMM kernels filed under ``learn/actor_critic*.py``,
    not a GEMM of the physics nor another kernel of the policy's line),
    the same as :func:`roofline.dense_ms` of ``analyze_trace``'s line; the
    whole-program share is the one at ``--ms-per-iter``, which it needs."""
    extra = (launched("learn/actor_critic.py(65)", "ampere_sgemm_128x64_tn", 30000, 700, 901)
             + launched("learn/actor_critic_cnn.py(40)", "cutlass_80_simt_sgemm_nn", 31000, 300,
                        902)
             + launched("physics/dynamics.py(41)", "gemvx_kernel", 32000, 900, 903))
    events = torch_trace(extra)["traceEvents"]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = t_at.summarize(events, iters=2)
    assert t_roof.dense_ms(s["kernel_files"]) == (700 + 300) / 1e3 / 2
    ms = 2500.0
    t_roof.main(["--device", "cpu", "--ms-per-iter", str(ms), "--from-trace", str(path),
                 "--iters", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    total = out["shape_flop_per_iter"]["total"]
    assert out["dense_ms"] == (700 + 300) / 1e3 / 2 and out["ms_per_iter"] == ms
    assert out["f32_peak_share"] == total / (ms / 1e3) / t_roof.F32_OPS_PER_S
    assert out["dense_f32_peak_share"] == total / t_roof.F32_OPS_PER_S / (out["dense_ms"] / 1e3)
    with pytest.raises(SystemExit):
        t_roof.main(["--device", "cpu", "--from-trace", str(path)])


# ------------------------------------------------------------ profile_bench
@pytest.fixture
def short_bench(monkeypatch):
    """The bench at 4 envs (2x2 tiles) with a short train iteration (2
    steps, one epoch of two minibatches): the trace of one bench iteration
    holds millions of events at any width."""
    monkeypatch.setenv("BENCH_NUM_ENVS", "4")
    config = t_bench.bench_config
    monkeypatch.setattr(t_bench, "bench_config", lambda *a, **k: (config(*a, **k)[0], PPOArgs(
        num_steps_per_env=2, num_learning_epochs=1, num_mini_batches=2)))


def test_profile_bench_ops_files_aten_ops_under_port_lines(short_bench, capsys):
    """``profile_bench --ops`` on the CPU: the aten ops of one iteration,
    filed under source lines of the port (a line of the function where the
    profiler's tree gives no call line), no launches or syncs (the CPU has
    none) and no trace kept."""
    t_profile.main(["--device", "cpu", "--ops", "--top", "5"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ops = out["ops"]
    assert out["device"] == "cpu" and "trace" not in out and ops["steps"] == 2
    assert ops["per_step"]["aten_ops"] > 100
    assert ops["per_step"]["launches"] == 0 and ops["per_step"]["syncs"] == 0
    top = [tag for tag, _ in ops["by_line_aten_ops"]]
    assert len(top) == 5 and all(re.fullmatch(r"[\w/]+\.py:\d+", t) for t in top), top


@pytest.mark.parametrize("argv", [[], ["--trace", "d", "--iters", "0"]], ids=["nothing", "iters0"])
def test_profile_bench_validates_before_the_build(monkeypatch, argv):
    """Bad arguments stop the tool before it builds the bench."""
    monkeypatch.setattr(t_bench, "build", lambda **k: pytest.fail("built"))
    with pytest.raises(SystemExit):
        t_profile.main(argv)


# -------------------------------------------------------------- ji22 ledger
# per-term bar of the stand ledger, a step, |port - JAX| <= TERM_ATOL +
# TERM_RTOL |JAX|: the JAX tool steps its lane-major engine, the port the
# env-major one it follows, and 35 steps of contact carry the float32
# differences on (the velocity state's multi-step bar is atol 5e-2,
# tests/test_torch_velocity.py).  Read on the CPU, JAX value and error:
# total_neg -7.31e-2 / 6.4e-6, tracking_contacts_shaped_force -3.98e-2 /
# 1.9e-5, feet_clearance_cmd_linear -1.91e-2 / 5.2e-6, raibert_heuristic
# -6.70e-3 / 1.6e-5, orientation_control -5.55e-3 / 2.3e-6, total_pos
# 4.93e-3 / 5.9e-5 (1.2 %), tracking_ang_vel 3.12e-3 / 4.5e-5 (1.4 %),
# tracking_lin_vel 1.81e-3 / 1.4e-5, jump -1.02e-3 / 9.4e-7,
# tracking_contacts_shaped_vel -5.55e-4 / 1.5e-5 (2.7 %), total 2.84e-4 /
# 6.1e-6, torques -2.33e-4 / 9.6e-6 (4.1 %), dof_vel -5.50e-5 / 1.7e-6,
# feet_slip -5.20e-5 / 2.3e-6 (4.4 %), dof_acc -7.19e-6 / 2.3e-6 (a
# difference of differences), lin_vel_z -4.01e-6 / 6.4e-9, ang_vel_xy
# -1.30e-6 / 1.0e-8; collision, action_rate, dof_pos_limits and both
# action_smoothness terms exactly 0 under zero actions.  The bar: a few
# times the 1.2-4.4 % of the terms above 5e-5, and an atol under every
# nonzero term's magnitude but ang_vel_xy's, which the sign check holds;
# the worst reading takes 0.67 of its bar (dof_acc)
TERM_ATOL, TERM_RTOL = 3e-6, 0.06


def test_ji22_stand_ledger_matches_jax_tool():
    """The stand-policy ledger of the JAX tool and of the port, per term, on
    4 envs with noise, pushes and friction randomization off, 5 steps after
    the 30-step settle, from the JAX tool's reset state under its draws."""
    jenv = J_JI22.make_env(0.0, num_envs=4)
    jper, jneg = J_JI22.ledger(jenv, "stand", steps=5)
    tenv = t_ji22.make_env(0.0, num_envs=4, device="cpu")
    state = convert.env_state_from_numpy(
        to_numpy(jenv._reset_jit(jax.random.key(1), False)), device="cpu")
    install_velocity_draws(tenv, VelocityDraws(jax.random.key(1), 4))
    try:
        tper, tneg = t_ji22.ledger(tenv, "stand", steps=5, state=state)
    finally:
        uninstall(tenv)
    assert set(tper) == set(jper)
    share = {k: abs(tper[k] - jper[k]) / (TERM_ATOL + TERM_RTOL * abs(jper[k])) for k in jper}
    assert max(share.values()) <= 1.0, sorted(share.items(), key=lambda kv: -kv[1])[:3]
    # a term the JAX tool reads as 0 is 0, and every other has its sign
    assert all(np.sign(tper[k]) == np.sign(jper[k]) for k in jper), (tper, jper)
    assert tneg == tper["total_neg"] and abs(tneg - jneg) <= TERM_ATOL + TERM_RTOL * abs(jneg)
    assert jneg < 0


# ------------------------------------------------------------- planner menu
@pytest.mark.parametrize("seed", [100, 101, 102])
def test_planner_menu_tunnels_bitwise(seed):
    """make_tunnel draws the JAX tool's slalom for the same seed, bitwise."""
    emap, hs = t_menu.make_tunnel(np.random.RandomState(seed))
    jmap, jhs = J_MENU.make_tunnel(np.random.RandomState(seed))
    assert hs == jhs
    np.testing.assert_array_equal(emap, jmap)
