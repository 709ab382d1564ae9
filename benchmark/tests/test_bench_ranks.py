"""The harness's rank layout, rehearsed on the CPU: a cell of two gloo
ranks at 8 envs in all runs its ranks (each a spawned process with its
shard of the envs), joins their rollouts, and is held to the one-rank
reference; with the exchange between the ranks left out it is not
correct."""

import pytest

from benchmark import manifest, run

from .conftest import small


@pytest.mark.parametrize("fault", [None, "no_allreduce"])
def test_two_gloo_ranks(fault):
    cell, overrides = small(manifest.cell("tunnel-train-4096"), envs_per_rank=4, ranks=2)
    cell = cell._replace(chips=2)
    result, _ = run.run_cell(cell, 2 ** 31 + 3, 0.1, False, "cpu", overrides=overrides,
                          backend="gloo", fault=fault)
    assert result["attempted"] >= 1 and result["device"]["count"] == 2
    assert result["correct"] == (fault is None), result["compared"]
