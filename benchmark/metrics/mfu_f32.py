"""mfu_f32: the whole train step's share of the card's float32 peak, in
percent: the frozen count of the policy's matrix-product operations an
iteration (``counts.iteration_flop``, from the configuration's widths)
times the traced window's iterations, over its seconds and the published
67 TFLOP/s."""

from benchmark import counts


def read(ctx):
    if ctx["device_type"] != "cuda" or not ctx["window_s"]:
        return None
    flop_s = ctx["flop_per_iteration"] * ctx["iterations"] / ctx["window_s"]
    return 100.0 * flop_s / counts.F32_OPS_PER_S
