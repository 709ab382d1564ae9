"""env_step_ms_per_step: milliseconds an env step takes in ``step_fn``
(the ``env.step`` spans of the port's tracer), summed over the profiled
iteration's rollout and divided by its T steps.  Read from the one
iteration that runs under the profiler, stretched about 2x like the other
trace metrics (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx, "env.step")
