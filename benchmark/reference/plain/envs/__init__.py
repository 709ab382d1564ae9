from .legged_env import LeggedEnv, StepOut  # noqa: F401
from .state import EnvState  # noqa: F401
