"""update_mfu_f32: the update's share of the card's float32 peak, in
percent: the frozen count of the update's matrix-product operations an
iteration (``counts.iteration_flop(...)["update"]``, from the cell's
configuration and traffic) over the mean of the traced window's
``PPO.update`` spans (synchronized at both ends, as ``update_s`` reads
them) and the published 67 TFLOP/s.  CUDA only."""

from benchmark import counts


def read(ctx):
    spans = ctx["spans"].get("update")
    if ctx["device_type"] != "cuda" or not spans:
        return None
    cell = ctx["cell"]
    flop = counts.iteration_flop({**cell.config, "ppo": cell.ppo}, cell.num_envs)["update"]
    return 100.0 * flop / (sum(spans) / len(spans)) / counts.F32_OPS_PER_S
