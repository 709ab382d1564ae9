"""act_ms_per_step: milliseconds an env step that the policy's act takes
(the ``ppo.act`` spans of the port's tracer: the history's normalization,
``action_dist``, the noise, ``log_prob`` and ``evaluate``), summed over the
profiled iteration's rollout and divided by its T steps.  Read from the
one iteration that runs under the profiler, stretched about 2x like the
other trace metrics (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_step(ctx, "ppo.act")
