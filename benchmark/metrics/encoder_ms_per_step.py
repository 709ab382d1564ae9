"""encoder_ms_per_step: milliseconds an env step that the policy's height
encoder takes in the rollout: the ``policy.encoder`` spans of the port's
tracer (the conv encoder over the history frames in
``ActorCriticCNN.process_obs_history``) that lie inside a ``ppo.act``
span, summed over the profiled iteration and divided by its T steps; the
update's spans are left out.  Host-clock spans of the one iteration that
runs under the profiler, stretched about 2x like ``act_ms_per_step``
(``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNDER = "policy.encoder", "ppo.act"


def read(ctx):
    record = spans.record(ctx)
    if record is None:
        return None
    # whether each span lies inside an UNDER span (parents come first)
    inside = []
    for s in record:
        inside.append(s.parent >= 0 and (record[s.parent].name == UNDER or inside[s.parent]))
    mine = [s for s, i in zip(record, inside) if s.name == NAME and i]
    if not mine:
        return None
    return sum(s.end_ns - s.start_ns for s in mine) / 1e6 / ctx["steps_per_iteration"]
