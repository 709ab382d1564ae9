"""device_idle_share: the share of the profiled iteration, in percent, in
which nothing ran on the device: one less the union of the device's
intervals over the iteration's span."""


def read(ctx):
    prof = ctx["profile"]
    if ctx["device_type"] != "cuda" or not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["span_s"])
