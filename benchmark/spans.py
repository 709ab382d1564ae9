"""The program's own spans of the profiled iteration, for the per-layer
readers of ``metrics/``: the record of the port's tracer
(``legged_tracking_torch/tracing.py``), taken from ``sys.modules`` so that
no file here but ``program.py`` imports the program.

The tracer records while ``torch.profiler`` records, so its record is the
one iteration that a ``--trace 1`` run profiles after its window, stretched
about 2x by the profiler like every other trace metric.  A span is an
object with ``name``, ``start_ns``, ``end_ns``, ``parent`` (the index of
its parent in the record, -1 for none) and ``syncs``.
"""

from __future__ import annotations

import sys

TRACER = "legged_tracking_torch.tracing"
STEP = "env.step"


def record(ctx) -> list | None:
    """The tracer's record, or None where the program has no tracer or the
    record does not hold exactly one ``env.step`` span a step of the
    iteration (a cell of several ranks is one such case: each rank's record
    stays in its own process)."""
    tracer = sys.modules.get(TRACER)
    spans = tracer.record() if tracer is not None and hasattr(tracer, "record") else None
    if not spans or sum(s.name == STEP for s in spans) != ctx["steps_per_iteration"]:
        return None
    return spans


def ms_per_step(ctx, name: str) -> float | None:
    """Milliseconds an env step in the spans called ``name``, or None where
    there is no record or no such span."""
    spans = record(ctx)
    if spans is None:
        return None
    mine = [s for s in spans if s.name == name]
    if not mine:
        return None
    return sum(s.end_ns - s.start_ns for s in mine) / 1e6 / ctx["steps_per_iteration"]
