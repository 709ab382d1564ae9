"""observe_ms_per_step: milliseconds an env step takes to observe (the
``env.observe`` spans of the port's tracer: the step's observations of the
post-reset state, and ``observe()``, with the height scan ``env.scan``
inside them), summed over the profiled iteration and divided by its T
steps.  Read from the one iteration that runs under the profiler,
stretched about 2x like the other trace metrics (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx, "env.observe")
