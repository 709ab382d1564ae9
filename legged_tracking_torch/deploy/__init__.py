"""The deploy stack of the port (counterpart of ``legged_tracking_tpu/deploy``):
the LCM wire protocol and message types, the state estimator, the command
profiles, the hardware agent and the deployment runner as numpy host code,
the policy runtime as a torch module on the card, and the C++ bridge
(``bridge/``, built by ``go1_bridge.build``)."""

from .lcm_lite import LCMLite, LCMType  # noqa: F401
from .policy_runtime import PolicyRuntime  # noqa: F401
