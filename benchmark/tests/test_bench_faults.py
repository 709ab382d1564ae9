"""A run with the timed path broken underneath: each fault a train cell can
have, planted in the port, makes ``correct`` false, and a sound run is
correct, at 8 envs on 2 x 2 tiles on the CPU with the cells' own limits.
The control (TF32) fails on the card: ``test_bench_card.py``."""

import pytest
import torch

from benchmark import manifest, run
from benchmark.reference import train as reference

from .conftest import small

SEED = 2 ** 31 + 5


@pytest.mark.parametrize("name", ["tunnel-train-4096", "velocity-train-4000"])
@pytest.mark.parametrize("kind", [None, "frozen", "half_batch", "reward", "obs", "reset"])
def test_a_fault_in_the_program_makes_the_run_incorrect(name, kind):
    cell, overrides = small(manifest.cell(name))
    result, _ = run.run_cell(cell, SEED, 0.1, False, "cpu", overrides=overrides, fault=kind)
    assert result["correct"] == (kind is None), result["compared"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 3.0])
    assert reference.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
