"""physics_graph_share: the share, in percent, of the profiled iteration's
``env.physics`` spans (the port's tracer) whose ``graph`` counter is 1 and
which captured nothing: env steps whose physics ran as one replay of a CUDA
graph captured earlier (``legged_tracking_torch/physics/graph.py``), not
eagerly and not by capturing anew.  CUDA only; nothing where the program's
spans carry no ``graph`` counter (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    if ctx["device_type"] != "cuda":
        return None
    record = spans.record(ctx)
    if record is None:
        return None
    counters = [getattr(s, "counters", {}) for s in record if s.name == "env.physics"]
    if not counters or any("graph" not in c for c in counters):
        return None
    replays = sum(1 for c in counters if c["graph"] == 1 and not c.get("captures"))
    return 100.0 * replays / len(counters)
