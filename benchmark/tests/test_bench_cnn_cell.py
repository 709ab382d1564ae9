"""The conv + GRU cell ``tunnel-cnn-gru-train-4096``: its files load and
differ from the tunnel cell's only in the policy; at 8 envs on 2 x 2 tiles
and 15 frames on the CPU it is ``correct`` and a transposed flatten in the
port's encoder fails ``policy``; and the readers of its three per-layer
metrics on hand-built records.  On the card, at the cell's own size, the
program within its limits and the TF32 control outside them:

    python -m pytest benchmark/tests/test_bench_cnn_cell.py -m cuda -q
"""

import sys
import types

import pytest

from benchmark import compare, control, counts, manifest, run, spans
from benchmark.reference import train as reference

from .conftest import small
from .test_bench_policy import chw_flatten, cnn_ac

CELL = "tunnel-cnn-gru-train-4096"
MS = 1_000_000


def test_the_cells_files_load_and_change_only_the_policy():
    cell = manifest.cell(CELL)
    tunnel = manifest.cell("tunnel-train-4096")
    assert cell.traffic == tunnel.traffic and cell.chips == 1
    assert set(cell.limits) == set(compare.NUMBERS)
    mine, base = cell.config, tunnel.config
    assert mine["policy"] == "ActorCriticCNN" and mine["ac"] == cnn_ac()
    assert mine["cfg"]["env"].pop("num_observation_history") == 15
    own = ("name", "source", "why", "policy", "ac")
    assert {k: v for k, v in mine.items() if k not in own} == \
        {k: v for k, v in base.items() if k not in own}
    assert mine["widths"]["history_frames"] == 15 and mine["reduced"] == []


@pytest.fixture(scope="module")
def small_cell():
    return small(manifest.cell(CELL))


def test_the_cell_is_correct_at_a_small_size_and_a_chw_flatten_fails(small_cell):
    """``control.check`` of the cell's first iteration, 8 envs of 15 frames:
    within every limit; with the conv output flattened channels-rows-columns
    in the port's encoder, ``policy`` is over its limit."""
    import torch

    cell, overrides = small_cell
    seed, cpu = 2 ** 31 + 67, torch.device("cpu")
    got = control.readings(cell, seed, "program", cpu, overrides)
    assert got["traj"]["obs_history"].shape[-1] == 15 * 261
    correct, rows = compare.verdict(control.check(cell, seed, got, cpu, overrides), cell.limits)
    assert correct, rows
    with chw_flatten():
        bad = control.readings(cell, seed, "program", cpu, overrides)
    g = control.check(cell, seed, bad, cpu, overrides)
    assert g["policy"] > cell.limits["policy"], g


def span(name, start_ms, end_ms, parent=-1):
    return types.SimpleNamespace(name=name, start_ns=start_ms * MS, end_ns=end_ms * MS,
                                 parent=parent, syncs=0)


def hand_record(steps=2, policy=True):
    """A rollout of ``steps`` steps, each an act with two policy calls
    (encoder 3 ms, GRU 5 ms, each; none without ``policy``) and an env
    step; then an update whose minibatch holds two policy calls and an
    adaptation substep with one (encoder 30 ms, GRU 50 ms, each)."""
    rec = [span("ppo.rollout", 0, 1000)]
    for t in range(steps):
        t0 = 1 + 100 * t
        act = len(rec)
        rec.append(span("ppo.act", t0, t0 + 20, parent=0))
        for c in range(2 if policy else 0):
            rec += [span("policy.encoder", t0 + 10 * c, t0 + 10 * c + 3, parent=act),
                    span("policy.gru", t0 + 10 * c + 3, t0 + 10 * c + 8, parent=act)]
        rec.append(span("env.step", t0 + 20, t0 + 90, parent=0))
    update = len(rec)
    rec.append(span("ppo.update", 1000, 2000))
    mb = len(rec)
    rec.append(span("ppo.minibatch", 1000, 1900, parent=update))
    for c in range(2):
        rec += [span("policy.encoder", 1000 + 100 * c, 1030 + 100 * c, parent=mb),
                span("policy.gru", 1030 + 100 * c, 1080 + 100 * c, parent=mb)]
    adapt = len(rec)
    rec += [span("ppo.adapt", 1300, 1400, parent=mb),
            span("policy.encoder", 1300, 1330, parent=adapt),
            span("policy.gru", 1330, 1380, parent=adapt)]
    return rec


@pytest.fixture
def tracer(monkeypatch):
    """A stand-in for the port's tracer in ``sys.modules``, whose record
    the test sets."""
    fake = types.ModuleType(spans.TRACER)
    fake.spans = []
    fake.record = lambda: fake.spans
    monkeypatch.setitem(sys.modules, spans.TRACER, fake)
    return fake


@pytest.mark.parametrize("name,want", [("gru_ms_per_step", 10.0),
                                       ("encoder_ms_per_step", 6.0)])
def test_policy_readers_count_the_rollouts_spans_only(tracer, monkeypatch, name, want):
    """Each reads the spans under ``ppo.act``, two calls a step, and not
    those of the minibatch or its adaptation substep; nothing without a
    whole record, without such spans, or without the tracer."""
    read = manifest.metric_reader(name)
    ctx = {"steps_per_iteration": 2, "device_type": "cuda"}
    tracer.spans = hand_record()
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    tracer.spans = hand_record(steps=3)
    assert read(ctx) is None
    tracer.spans = hand_record(policy=False)
    assert read(ctx) is None
    monkeypatch.delitem(sys.modules, spans.TRACER)
    assert read(ctx) is None


def test_update_mfu_is_the_update_count_over_the_span_mean():
    read = manifest.metric_reader("update_mfu_f32")
    cell = manifest.cell(CELL)
    flop = counts.iteration_flop({**cell.config, "ppo": cell.ppo}, cell.num_envs)["update"]
    ctx = {"cell": cell, "device_type": "cuda", "spans": {"update": [10.0, 12.0, 11.0]}}
    assert read(ctx) == pytest.approx(100.0 * flop / 11.0 / counts.F32_OPS_PER_S, rel=1e-12)
    assert 0 < read(ctx) < 100
    assert read({**ctx, "spans": {}}) is None
    assert read({**ctx, "device_type": "cpu"}) is None


def test_a_traced_run_reports_the_policy_spans_on_the_cpu(small_cell):
    """A ``--trace 1`` run of the cell at 8 envs on the CPU: ``correct``,
    the encoder and GRU metrics read from the program's spans, within the
    act's; no update share of the card's peak off CUDA."""
    cell, overrides = small_cell
    result, _ = run.run_cell(cell, 2 ** 31 + 71, 0.1, True, "cpu", overrides=overrides)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"], result["compared"]
    assert "update_mfu_f32" not in got
    # the cell lists no act_ms_per_step: the act's spans, read as that metric reads them
    act = spans.ms_per_step({"steps_per_iteration": cell.ppo["num_steps_per_env"]}, "ppo.act")
    assert 0 < got["gru_ms_per_step"] < act and 0 < got["encoder_ms_per_step"] < act


@pytest.mark.cuda
def test_the_cell_on_the_card_within_its_limits_and_the_control_outside(cuda_device):
    cell = manifest.cell(CELL)
    got = control.readings(cell, 2 ** 31 + 73, "program", cuda_device)
    correct, rows = compare.verdict(control.check(cell, 2 ** 31 + 73, got, cuda_device),
                                    cell.limits)
    assert correct, rows
    del got
    low = reference.drive(cell.config, cell.num_envs, 2 ** 31 + 79, cuda_device,
                          ppo_overrides=cell.traffic["ppo"], tf32=True)
    correct, rows = compare.verdict(control.check(cell, 2 ** 31 + 79, low, cuda_device),
                                    cell.limits)
    assert not correct, rows
