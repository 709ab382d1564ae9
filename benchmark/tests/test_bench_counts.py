"""The frozen arithmetic against the port's own tools: the FLOP count of a
train iteration against ``tools/roofline`` on a built policy, and B1's
least bytes against ``chip_smoke.scan_bound`` at a small seeded input."""

import pytest
import torch

from benchmark import counts, manifest


def test_flop_count_equals_the_roofline_tools_shape_count():
    from legged_tracking_torch.tools import roofline

    ac, ppo = roofline.bench_policy("cpu")
    want = roofline.iteration_flop(ac, 4096, ppo.num_steps_per_env, ppo.num_learning_epochs)
    got = counts.iteration_flop(manifest.config("tunnel_cse"), 4096)
    assert got == want
    assert got["total"] / 1e12 == pytest.approx(16.042, abs=5e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_b1_bytes_equal_scan_bound(seed):
    import chip_smoke
    from legged_tracking_torch.terrain import heightfield as hf
    from legged_tracking_torch.terrain.tunnel import build_terrain

    cfg = chip_smoke.bench_cfg(16)
    terrain = build_terrain(cfg, 16, seed, device="cpu")
    args = chip_smoke.scan_args(terrain, hf.bf16_table(terrain), cfg, torch.device("cpu"))
    want = chip_smoke.scan_bound(args)
    assert counts.scan_bytes(*args) == want["bytes"]
    assert counts.scan_bound_s(*args) * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    from legged_tracking_torch.terrain import scan
    assert torch.equal(counts.scan_cells(*args), scan.scan_cells(*args))
