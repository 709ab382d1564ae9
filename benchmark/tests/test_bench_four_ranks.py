"""The four-card cell ``tunnel-train-4096x4``: its files load as the
tunnel cell's configuration under four ranks, one a card.  The rank
layout itself (spawned ranks, their joined rollouts, the one-rank
reference) does not depend on the number of ranks, and is rehearsed on
the CPU in ``test_bench_ranks.py``."""

from benchmark import compare, manifest

CELL = "tunnel-train-4096x4"


def test_the_cells_files_load_with_four_ranks_a_card():
    cell = manifest.cell(CELL)
    one = manifest.cell("tunnel-train-4096")
    assert cell.chips == cell.traffic["ranks"] == 4
    assert cell.traffic["envs_per_rank"] == one.traffic["envs_per_rank"] == 4096
    assert cell.num_envs == 16384 and cell.config == one.config
    assert cell.ppo == one.ppo and set(cell.limits) == set(compare.NUMBERS)
