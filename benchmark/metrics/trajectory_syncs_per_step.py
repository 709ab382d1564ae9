"""trajectory_syncs_per_step: synchronizing CUDA operations an env step
makes in the trajectory draw: the ``syncs`` the port's tracer counts on
the ``env.trajectory`` spans, over the profiled iteration's T steps;
nothing off CUDA, and nothing where the program records no such span.
Read from the one iteration that runs under the profiler
(``benchmark/spans.py``); a count, which the profiler's stretch does not
move."""

from benchmark import spans


def read(ctx):
    if ctx["device_type"] != "cuda":
        return None
    record = spans.record(ctx)
    if record is None:
        return None
    mine = [s for s in record if s.name == "env.trajectory"]
    if not mine:
        return None
    return sum(s.syncs for s in mine) / ctx["steps_per_iteration"]
