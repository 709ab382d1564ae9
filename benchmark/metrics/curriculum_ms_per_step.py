"""curriculum_ms_per_step: milliseconds an env step takes in the command
curriculum (the ``env.curriculum`` spans of the port's tracer,
``VelocityTrackingEnv._resample_commands``: the step's resample and the
reset's), summed over the profiled iteration and divided by its T steps;
nothing where no such span ran (the tunnel env has no curriculum).  Read
from the one iteration that runs under the profiler, stretched about 2x
like the other trace metrics (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx, "env.curriculum")
