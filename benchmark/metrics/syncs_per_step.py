"""syncs_per_step: ``cudaStreamSynchronize`` and ``cudaDeviceSynchronize``
calls inside the ``PPO.rollout`` range of the profiled iteration, over its
T env steps."""


def read(ctx):
    prof = ctx["profile"]
    if ctx["device_type"] != "cuda" or not prof or prof["rollouts"] != 1:
        return None
    return prof["syncs"] / ctx["steps_per_iteration"]
