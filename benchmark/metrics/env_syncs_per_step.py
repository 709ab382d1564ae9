"""env_syncs_per_step: synchronizing CUDA operations an env step makes in
``step_fn``: the ``syncs`` the port's tracer counts on the ``env.step``
spans and the spans inside them, over the profiled iteration's T steps;
nothing off CUDA.  Read from the one iteration that runs under the
profiler (``benchmark/spans.py``); a count, which the profiler's stretch
does not move."""

from benchmark import spans


def read(ctx):
    if ctx["device_type"] != "cuda":
        return None
    record = spans.record(ctx)
    if record is None:
        return None
    inside = []
    for s in record:
        inside.append(s.name == spans.STEP or (s.parent >= 0 and inside[s.parent]))
    syncs = sum(s.syncs for s, i in zip(record, inside) if i)
    return syncs / ctx["steps_per_iteration"]
