"""The readers of the program's spans (``metrics/*_per_step.py`` through
``spans.py``) on hand-built tracer records: each reads its value, and each
reads nothing where the program has no tracer or its record does not hold
one ``env.step`` span a step; and a traced run of a small tunnel cell on
the CPU, which reports the span metrics the CPU has."""

import sys
import types

import pytest

from benchmark import manifest, run, spans

from .conftest import small

READERS = ("act_ms_per_step", "env_step_ms_per_step", "physics_ms_per_step",
           "observe_ms_per_step", "curriculum_ms_per_step", "env_syncs_per_step")
MS = 1_000_000


def span(name, start_ms, end_ms, parent=-1, syncs=0):
    return types.SimpleNamespace(name=name, start_ns=start_ms * MS, end_ns=end_ms * MS,
                                 parent=parent, syncs=syncs)


def hand_record(steps=2):
    """A rollout of ``steps`` steps, each: act (2 ms, 1 sync), the env step
    (100 ms, 1 sync of its own) holding physics (70 ms, 4 syncs), the
    command curriculum (3 ms), the reset (10 ms) with a second curriculum
    (2 ms, 1 sync) inside it, and observe (8 ms) with the scan (5 ms, 1
    sync) inside it; then the update, with a sync."""
    rec = [span("ppo.rollout", 0, 1000, syncs=2)]
    for t in range(steps):
        t0 = 1 + 120 * t
        rec.append(span("ppo.act", t0, t0 + 2, parent=0, syncs=1))
        step = len(rec)
        rec += [span("env.step", t0 + 5, t0 + 105, parent=0, syncs=1),
                span("env.physics", t0 + 5, t0 + 75, parent=step, syncs=4),
                span("env.curriculum", t0 + 76, t0 + 79, parent=step)]
        reset = len(rec)
        rec += [span("env.reset", t0 + 80, t0 + 90, parent=step),
                span("env.curriculum", t0 + 81, t0 + 83, parent=reset, syncs=1)]
        observe = len(rec)
        rec += [span("env.observe", t0 + 91, t0 + 99, parent=step),
                span("env.scan", t0 + 92, t0 + 97, parent=observe, syncs=1)]
    rec.append(span("ppo.update", 1000, 1400, syncs=1))
    return rec


EXPECTED = {"act_ms_per_step": 2.0, "env_step_ms_per_step": 100.0,
            "physics_ms_per_step": 70.0, "observe_ms_per_step": 8.0,
            "curriculum_ms_per_step": 5.0, "env_syncs_per_step": 1 + 4 + 1 + 1}


def ctx(steps=2, device="cuda"):
    return {"steps_per_iteration": steps, "device_type": device}


@pytest.fixture
def tracer(monkeypatch):
    """A stand-in for the port's tracer in ``sys.modules``, whose record
    the test sets."""
    fake = types.ModuleType(spans.TRACER)
    fake.spans = []
    fake.record = lambda: fake.spans
    monkeypatch.setitem(sys.modules, spans.TRACER, fake)
    return fake


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_hand_built_record(tracer, name):
    tracer.spans = hand_record()
    assert manifest.metric_reader(name)(ctx()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_whole_record(tracer, monkeypatch, name):
    """Nothing where the record has another count of env steps than the
    iteration, is empty, or the program has no tracer."""
    read = manifest.metric_reader(name)
    tracer.spans = hand_record(steps=3)
    assert read(ctx(steps=2)) is None
    tracer.spans = []
    assert read(ctx()) is None
    monkeypatch.delitem(sys.modules, spans.TRACER)
    assert read(ctx()) is None


def test_syncs_only_on_cuda_and_curriculum_only_where_it_ran(tracer):
    tracer.spans = hand_record()
    assert manifest.metric_reader("env_syncs_per_step")(ctx(device="cpu")) is None
    tracer.spans = [s for s in hand_record() if s.name != "env.curriculum"]
    assert manifest.metric_reader("curriculum_ms_per_step")(ctx()) is None


def test_traced_run_reports_the_span_metrics_on_the_cpu():
    """A ``--trace 1`` run of the tunnel cell at 8 envs: the program's
    tracer recorded the profiled iteration, and every span metric of the
    cell but the sync count (CUDA only) is there, the env step's parts
    within it."""
    cell, overrides = small(manifest.cell("tunnel-train-4096"))
    result, _ = run.run_cell(cell, 2 ** 31 + 5, 0.1, True, "cpu", overrides=overrides)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"], result["compared"]
    assert "env_syncs_per_step" not in got and "curriculum_ms_per_step" not in got
    assert 0 < got["physics_ms_per_step"] < got["env_step_ms_per_step"]
    assert 0 < got["observe_ms_per_step"] < got["env_step_ms_per_step"]
    assert got["act_ms_per_step"] > 0
