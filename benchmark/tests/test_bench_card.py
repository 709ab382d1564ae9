"""The check on the card at the cells' own sizes: the program within the
cells' limits, and the control (the reference in TF32, one precision below
the float32 the configurations state) outside them.  Needs an NVIDIA card;
on the chip (about a minute a case):

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q
"""

import pytest

from benchmark import compare, control, manifest
from benchmark.reference import train as reference


CELLS = ["tunnel-train-4096", "velocity-train-4000"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_within_limits_on_the_card(cuda_device, name):
    cell = manifest.cell(name)
    got = control.readings(cell, 21, "program", cuda_device)
    correct, rows = compare.verdict(control.check(cell, 21, got, cuda_device), cell.limits)
    assert correct, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(cuda_device, name):
    cell = manifest.cell(name)
    low = reference.drive(cell.config, cell.num_envs, 22, cuda_device,
                          ppo_overrides=cell.traffic["ppo"], tf32=True)
    correct, rows = compare.verdict(control.check(cell, 22, low, cuda_device), cell.limits)
    assert not correct, rows
