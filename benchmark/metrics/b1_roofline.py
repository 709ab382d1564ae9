"""b1_roofline: kernel B1's share of its roofline in the profiled
iteration, in percent: the least seconds of its launches there (the
frozen ``counts.scan_bound_s`` at each launch's own inputs) over their
device seconds.  Nothing where B1 did not run."""

from benchmark import trace


def read(ctx):
    prof = ctx["profile"]
    if ctx["device_type"] != "cuda" or not prof:
        return None
    seconds = sum(s for name, (s, _) in prof["kernels"].items() if trace.B1_KERNEL in name)
    if seconds <= 0 or not ctx["b1_bound_s"]:
        return None
    return 100.0 * ctx["b1_bound_s"] / seconds
