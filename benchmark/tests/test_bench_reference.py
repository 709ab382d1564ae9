"""The plain reference against the port at 8 envs on 2 x 2 tiles, on the
CPU (where the port runs its kernels' plain versions).  The two share no
solver and no learner, so they agree to rounding, not bitwise: the start
alike, every teacher-forced step and the first update within 1e-3."""

import math

import pytest
import torch

from benchmark import compare, control, manifest
from benchmark.reference import learner
from benchmark.reference import train as reference

from .conftest import small


@pytest.mark.parametrize("name", ["tunnel-train-4096", "velocity-train-4000"])
def test_reference_agrees_with_the_port(name):
    cell, overrides = small(manifest.cell(name))
    seed = 2 ** 31 + 17
    got = control.readings(cell, seed, "program", torch.device("cpu"), overrides)
    g = control.check(cell, seed, got, torch.device("cpu"), overrides)
    assert g["start"] == 0.0 and g["env_off"] == 0 and g["reset_off"] == 0, g
    assert all(g[k] < 1e-3 for k in compare.NUMBERS), g
    assert 0.0 < g["step_parts"]["max"] < 1e-3 and 0.0 < g["change"], g
    assert g["step_parts"]["done"] > 0, g
    assert len(got["steps"]) == 24 and got["traj"]["rewards"].shape == (24, 8)


@pytest.mark.parametrize("name", ["tunnel-train-4096", "velocity-train-4000"])
def test_reference_in_the_programs_place_is_correct(name):
    cell, overrides = small(manifest.cell(name))
    got = reference.drive(cell.config, cell.num_envs, 9, "cpu", overrides=overrides,
                          ppo_overrides=cell.traffic["ppo"])
    correct, rows = compare.verdict(control.check(cell, 9, got, torch.device("cpu"), overrides),
                                    cell.limits)
    assert correct, rows


def test_widths_are_checked():
    cell, overrides = small(manifest.cell("tunnel-train-4096"))
    config = {**cell.config, "widths": {**cell.config["widths"], "num_obs": 260}}
    with pytest.raises(ValueError, match="widths"):
        reference.drive(config, 8, 1, "cpu", overrides=overrides,
                        ppo_overrides=cell.traffic["ppo"])


def test_adam_is_torch_adam():
    gen = torch.Generator().manual_seed(3)
    p = {"w": torch.randn(5, 4, generator=gen, dtype=torch.float64)}
    q = torch.nn.Parameter(p["w"].clone())
    opt = torch.optim.Adam([q], lr=1e-3, eps=1e-8)
    s = learner.adam_init(p)
    for _ in range(4):
        g = torch.randn(5, 4, generator=gen, dtype=torch.float64)
        s = learner.adam_step(p, {"w": g}, s, 1e-3)
        q.grad = g.clone()
        opt.step()
    assert torch.allclose(p["w"], q.detach(), rtol=1e-12, atol=1e-14)


def test_gae_is_the_discounted_sum():
    gen = torch.Generator().manual_seed(4)
    T, N, g, lam = 6, 3, 0.99, 0.95
    r, v = torch.randn(T, N, generator=gen, dtype=torch.float64), torch.randn(T, N, generator=gen,
                                                                             dtype=torch.float64)
    last = torch.randn(N, generator=gen, dtype=torch.float64)
    done = torch.zeros(T, N, dtype=torch.bool)
    done[2, 1] = True
    returns, adv = learner.gae(r, done, v, last, g, lam)
    raw = returns - v
    for n in range(N):
        for t in range(T):
            want, w = 0.0, 1.0
            for k in range(t, T):
                nv = v[k + 1, n] if k + 1 < T else last[n]
                keep = 0.0 if done[k, n] else 1.0
                want += w * (r[k, n] + g * keep * nv - v[k, n])
                w *= g * lam * keep
                if keep == 0.0:
                    break
            assert math.isclose(float(raw[t, n]), float(want), rel_tol=1e-12, abs_tol=1e-12)
    assert abs(float(adv.mean())) < 1e-12 and math.isclose(float(adv.std(unbiased=False)), 1.0,
                                                           rel_tol=1e-6)
