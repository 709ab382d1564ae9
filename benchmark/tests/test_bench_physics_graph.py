"""The reader of ``physics_graph_share`` on hand-built tracer records: the
share of ``env.physics`` spans whose ``graph`` counter is 1 and which
captured nothing, and nothing
off CUDA, without a whole record, or where the spans carry no ``graph``
counter (a program without the physics graph)."""

import sys
import types

import pytest

from benchmark import manifest, spans

READ = manifest.metric_reader("physics_graph_share")


def record(graphs, captures=(0, 0, 0, 0)):
    """A rollout of four env steps, each with its physics span; the physics
    spans' ``graph`` counters are ``graphs`` (None: no counter), and their
    ``captures`` counters ``captures`` (0: none)."""
    rec = [types.SimpleNamespace(name="ppo.rollout", parent=-1, counters={})]
    for g, c in zip(graphs, captures):
        step = len(rec)
        counters = ({} if g is None else {"graph": g}) | ({"captures": c} if c else {})
        rec.append(types.SimpleNamespace(name="env.step", parent=0, counters={}))
        rec.append(types.SimpleNamespace(name="env.physics", parent=step, counters=counters))
    return rec


@pytest.fixture
def tracer(monkeypatch):
    fake = types.ModuleType(spans.TRACER)
    fake.spans = []
    fake.record = lambda: fake.spans
    monkeypatch.setitem(sys.modules, spans.TRACER, fake)
    return fake


@pytest.mark.parametrize("graphs,share", [((1, 1, 1, 1), 100.0), ((0, 1, 1, 1), 75.0),
                                          ((0, 0, 0, 0), 0.0)])
def test_share_of_replayed_physics_spans(tracer, graphs, share):
    tracer.spans = record(graphs)
    assert READ({"steps_per_iteration": 4, "device_type": "cuda"}) == share


@pytest.mark.parametrize("graphs,captures,share", [
    ((0, 1, 1, 1), (1, 0, 0, 0), 75.0), ((0, 0, 0, 0), (1, 1, 1, 1), 0.0),
    ((1, 1, 1, 1), (1, 1, 1, 1), 0.0)])
def test_capturing_spans_do_not_count(tracer, graphs, captures, share):
    """A span counts only where it replayed without capturing: a graph
    captured anew on every step reads 0, whatever its ``graph`` counters."""
    tracer.spans = record(graphs, captures)
    assert READ({"steps_per_iteration": 4, "device_type": "cuda"}) == share


def test_reads_nothing_without_the_counter_or_off_cuda(tracer, monkeypatch):
    """Nothing where a physics span has no ``graph`` counter (the spans of a
    program without the graph), off CUDA, where the record holds another
    count of env steps, or without a tracer."""
    ctx = {"steps_per_iteration": 4, "device_type": "cuda"}
    tracer.spans = record((None, None, None, None))
    assert READ(ctx) is None
    tracer.spans = [s for s in record((1, 1, 1, 1))]
    for s in tracer.spans:
        del s.counters
    assert READ(ctx) is None
    tracer.spans = record((1, 1, 1, 1))
    assert READ({**ctx, "device_type": "cpu"}) is None
    assert READ({**ctx, "steps_per_iteration": 3}) is None
    monkeypatch.delitem(sys.modules, spans.TRACER)
    assert READ(ctx) is None
