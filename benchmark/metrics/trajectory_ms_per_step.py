"""trajectory_ms_per_step: milliseconds an env step takes in the
trajectory draw (the ``env.trajectory`` spans of the port's tracer: the
configuration's trajectory function, ``valid_goal`` in the goal recipe,
called by the branchless auto-reset of every step), summed over the
profiled iteration's rollout and divided by its T steps.  Read from the
one iteration that runs under the profiler, stretched about 2x like the
other trace metrics (``benchmark/spans.py``); nothing where the program
records no such span."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx, "env.trajectory")
