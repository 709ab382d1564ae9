import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    import torch

    # the tests run several workers side by side: two threads each
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card with CUDA; skips where torch has none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (the cell's kernels have no CPU mode)")
    return torch.device("cuda")


def small(cell, envs_per_rank=8, ranks=1):
    """``cell`` at a size a CPU test holds: ``envs_per_rank`` envs a rank on
    2 x 2 tiles and episodes of 0.1 s, so that envs reset within a rollout
    (the overrides to pass with it), rollouts of 24 steps, 2 epochs, one
    set-up iteration."""
    cell = cell._replace(traffic={**cell.traffic, "envs_per_rank": envs_per_rank,
                                  "ranks": ranks, "setup_iterations": 1,
                                  "ppo": {"num_steps_per_env": 24, "num_learning_epochs": 2}})
    return cell, {"terrain": {"num_rows": 2, "num_cols": 2}, "env": {"episode_length_s": 0.1}}
