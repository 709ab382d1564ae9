"""The port's tracer (``legged_tracking_torch/tracing.py``) on the CPU: off
while the profiler is off; under the profiler, one span a layer and a step
in a train iteration of the bench at 4 envs on 2 x 2 tiles (2 steps, one
epoch of two minibatches), each child inside its parent and a span on the
profiler's clock; sync warnings counted on the innermost span, other
warnings shown; one record a profiler session."""

import collections
import inspect
import json
import warnings

import pytest
import torch

from legged_tracking_torch import bench, tracing
from legged_tracking_torch.learn.ppo import PPOArgs

STEPS, EPOCHS, MINIBATCHES = 2, 1, 2
# (span, its parent) of a train iteration
PARENTS = {"ppo.act": "ppo.rollout", "env.step": "ppo.rollout", "env.physics": "env.step",
           "env.rewards": "env.step", "env.reset": "env.step", "env.observe": "env.step",
           "env.scan": "env.observe", "ppo.minibatch": "ppo.update",
           "ppo.adapt": "ppo.minibatch"}


def profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``, after a span with the
    profiler off (so its spans start a record); returns (its result, the
    profiler)."""
    with tracing.span("off"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def short_train():
    env, alg, ts, state, obs = bench.build(4, device="cpu")
    alg.args = PPOArgs(num_steps_per_env=STEPS, num_learning_epochs=EPOCHS,
                       num_mini_batches=MINIBATCHES)
    return [alg, (ts, state, obs)]


def iterate(train):
    alg, carry = train
    ts, state, obs, _ = alg.train_iteration(*carry)
    train[1] = (ts, state, obs)


def test_off_reads_no_clock_and_records_nothing(short_train, monkeypatch):
    """With the profiler off, a train iteration reads no clock in the
    tracer and leaves its record as it was."""
    reads = []
    monkeypatch.setattr(tracing, "time_ns", lambda: reads.append(1) or 0)
    before = tracing.record()
    n = len(before)
    iterate(short_train)
    assert reads == [] and tracing.record() is before and len(before) == n


def test_profiled_iteration_records_each_layer(short_train):
    """Under the profiler: T act, step, physics, rewards, reset and observe
    spans, epochs x minibatches minibatch spans, each span inside its
    parent, and no sync counted off CUDA."""
    profiled(lambda: iterate(short_train))
    spans = tracing.record()
    counts = collections.Counter(s.name for s in spans)
    for name in ("ppo.act", "env.step", "env.physics", "env.rewards", "env.reset",
                 "env.observe", "env.scan"):
        assert counts[name] == STEPS, counts
    assert counts["ppo.minibatch"] == counts["ppo.adapt"] == EPOCHS * MINIBATCHES
    assert counts["ppo.rollout"] == counts["ppo.gae"] == counts["ppo.update"] == 1
    for i, s in enumerate(spans):
        assert s.index == i and 0 < s.start_ns <= s.end_ns
        if s.parent < 0:
            assert s.name not in PARENTS
            continue
        parent = spans[s.parent]
        assert parent.name == PARENTS[s.name] and s.parent < i
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert sum(s.syncs for s in spans) == 0


def test_span_lies_on_the_profilers_clock(tmp_path):
    """A span around a matrix product encloses the product's profiler event
    within 50 us, in the profiler's events and in its Chrome trace once the
    span is added to it."""
    a = torch.randn(256, 256)
    a @ a

    def product():
        with tracing.span("probe"):
            a @ a
    _, prof = profiled(product)
    (s,) = tracing.record()
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    slack = 50_000
    assert s.start_ns - slack <= mm.start_ns()
    assert mm.start_ns() + mm.duration_ns() <= s.end_ns + slack
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert tracing.add_to_chrome_trace(str(path)) == 1
    events = json.loads(path.read_text())["traceEvents"]
    (ev,) = [e for e in events if e.get("cat") == "program_span"]
    (op,) = [e for e in events if e.get("name") == "aten::mm"]
    assert ev["name"] == "probe" and ev["args"]["syncs"] == 0
    assert ev["ts"] - slack / 1e3 <= op["ts"]
    assert op["ts"] + op["dur"] <= ev["ts"] + ev["dur"] + slack / 1e3


def test_sync_warning_counts_on_the_innermost_span(monkeypatch):
    """A sync warning raised inside a nested span counts on the innermost
    one, with its file and line, and does not show; another warning shows,
    the one that setting the sync debug mode gives too; the mode, the
    warning filters and the display are restored after."""
    filters, shown = list(warnings.filters), warnings.showwarning
    modes = []

    def set_mode(mode):
        modes.append(mode)
        warnings.warn("the sync debug mode is a prototype")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)

    def nested():
        with tracing.span("outer"):
            with tracing.span("inner"):
                line = inspect.currentframe().f_lineno + 1
                warnings.warn(f"{tracing.SYNC_WARNING} (a fake one)")
                warnings.warn("another warning")
        return line

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        line, _ = profiled(nested)
    outer, inner = tracing.record()
    assert (inner.name, inner.syncs, inner.parent) == ("inner", 1, outer.index)
    assert inner.sites == {f"{__file__}:{line}": 1} and outer.syncs == 0
    assert [str(w.message) for w in caught] == ["the sync debug mode is a prototype",
                                                "another warning",
                                                "the sync debug mode is a prototype"]
    assert modes == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is shown


def test_each_profiler_session_starts_a_record():
    """The first span under the profiler after spans without it starts a
    new record; a record handed out stays as it was."""
    def spans(*names):
        for name in names:
            with tracing.span(name) as s:
                s.add("bytes", 8)

    profiled(lambda: spans("a", "a"))
    first = tracing.record()
    spans("off")
    assert tracing.record() is first
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spans("b")
    second = tracing.record()
    assert [s.name for s in first] == ["a", "a"] and [s.name for s in second] == ["b"]
    assert second[0].counters == {"bytes": 8} and second[0].parent == -1
