"""rollout_s: wall seconds an iteration spends in ``PPO.rollout``, the mean
of the traced window's spans (synchronized at both ends)."""


def read(ctx):
    spans = ctx["spans"].get("rollout")
    return sum(spans) / len(spans) if spans else None
