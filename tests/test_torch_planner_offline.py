"""The port's offline pose planners (``legged_tracking_torch/utils/planner.py``)
against the JAX package's module on the CPU: every ``allocate_planner``
name gives bitwise the same path and cost for the same map, endpoints,
objective and seed; ``PoseCostGrid``, ``path_cost`` and ``shortcut`` agree
bitwise.

The budgets are small (a few hundred iterations or samples, on the 3 m x
1.5 m tunnel of ``tests/test_planner.py``'s ``make_tunnel``) so that both
packages plan each case in about a second; the JAX package's own tests run
the menu at its default budgets."""

import numpy as np
import pytest
import torch_support  # noqa: F401

from legged_tracking_torch.utils import planner as tp
from legged_tracking_tpu.utils import planner as jp

START = np.array([0.3, 0.75, 0.27, 0.0])
GOAL = np.array([2.6, 0.75, 0.27, 0.0])


def make_tunnel(nx=60, ny=30, hs=0.05, ceiling=0.8, blocked=False, wall=False):
    """tests/test_planner.py's tunnel; ``wall``: a half-width wall at x = 1.5 m
    that the path must pass on the +y side."""
    emap = np.zeros((2, nx, ny))
    emap[0] = ceiling
    if blocked:
        emap[1, nx // 2 - 2: nx // 2 + 2, :] = 0.7
    if wall:
        emap[1, 28:31, : ny // 2] = 0.7
    return emap, hs


def cost_grid(mod, n=8):
    """A (z, roll, pitch) cost that favours z near 0.2 m."""
    z = np.linspace(0.05, 0.6, n)
    cost = np.broadcast_to(((z - 0.2) ** 2 * 10)[:, None, None], (n, n, n)).copy()
    return mod.PoseCostGrid(cost, lo=[0.05, -0.5, -0.5], hi=[0.6, 0.5, 0.5])


# each menu name with a budget of a few hundred and one of the three
# objectives (informed sampling and BIT*'s heuristics act on pathlength only)
MENU = {
    "rrt": ("trackingerror", {"max_iters": 300, "shortcut_iters": 30}),
    "rrtconnect": ("balanced", {"max_iters": 300, "shortcut_iters": 30}),
    "rrtstar": ("trackingerror", {"max_iters": 250}),
    "informedrrtstar": ("pathlength", {"max_iters": 250}),
    "sorrtstar": ("pathlength", {"max_iters": 250}),
    "prmstar": ("balanced", {"num_samples": 150}),
    "bitstar": ("pathlength", {"batch_size": 60, "max_batches": 2}),
    "fmtstar": ("trackingerror", {"num_samples": 150}),
    "bfmtstar": ("pathlength", {"num_samples": 150}),
}


def test_menu_names_match():
    assert sorted(tp._PLANNERS) == sorted(jp._PLANNERS) == sorted(MENU)


@pytest.mark.parametrize("name", sorted(MENU))
def test_allocate_planner_matches_jax(name):
    """The same (path, cost), bitwise, on the walled tunnel; the path runs
    from start to goal."""
    objective, budget = MENU[name]
    emap, hs = make_tunnel(wall=True)
    out = {}
    for mod in (tp, jp):
        pc = cost_grid(mod) if objective != "pathlength" else None
        out[mod] = mod.allocate_planner(name)(emap, START, GOAL, hs, seed=0,
                                             objective=objective, pose_cost=pc, **budget)
    (path_t, cost_t), (path_j, cost_j) = out[tp], out[jp]
    assert path_j is not None, f"{name}: the JAX planner found no path at this budget"
    np.testing.assert_array_equal(path_t, path_j)
    assert cost_t == cost_j and np.isfinite(cost_t)
    np.testing.assert_array_equal(path_t[0], START)


def test_blocked_tunnel_and_unknown_name():
    """A wall across the tunnel: (None, inf) from both; an unknown name
    raises ValueError in both."""
    emap, hs = make_tunnel(blocked=True)
    for name, kw in (("rrtconnect", {"max_iters": 100}), ("prmstar", {"num_samples": 60}),
                     ("bitstar", {"batch_size": 40, "max_batches": 1})):
        for mod in (tp, jp):
            path, cost = mod.allocate_planner(name)(emap, START, GOAL, hs, seed=0, **kw)
            assert path is None and cost == float("inf"), (mod.__name__, name)
    for mod in (tp, jp):
        with pytest.raises(ValueError, match="not implemented"):
            mod.allocate_planner("nope")


def test_pose_cost_grid_lookup_reject_and_csv(tmp_path):
    """Lookups inside and outside the measured box, ``reject`` on per-axis
    errors, and ``from_csv`` of the reference layout: the same values."""
    n = 4
    zz, rr, pp = np.meshgrid(np.linspace(0.1, 0.5, n), np.linspace(-0.4, 0.4, n),
                             np.linspace(-0.4, 0.4, n), indexing="ij")
    rng = np.random.RandomState(0)
    errs = rng.uniform(0.0, 0.4, (n ** 3, 3))
    rows = np.concatenate([np.stack([zz.ravel(), rr.ravel(), pp.ravel()], 1), errs,
                           (zz.ravel() * 2.0 + rng.uniform(0, 0.1, n ** 3))[:, None]], 1)
    f = str(tmp_path / "err.csv")
    np.savetxt(f, rows, delimiter=" ")
    gt, gj = tp.PoseCostGrid.from_csv(f, n=n), jp.PoseCostGrid.from_csv(f, n=n)
    for a in ("cost", "lo", "hi", "interval", "axis_errors"):
        np.testing.assert_array_equal(getattr(gt, a), getattr(gj, a))
    assert gt.max_cost == gj.max_cost
    poses = np.stack([rng.uniform(0.0, 0.6, 200), rng.uniform(-0.5, 0.5, 200),
                      rng.uniform(-0.5, 0.5, 200)], 1)
    lookups = [(gt(*p), gj(*p)) for p in poses]
    rejects = [(gt.reject(*p), gj.reject(*p)) for p in poses]
    assert all(a == b for a, b in lookups) and all(a == b for a, b in rejects)
    assert any(r for r, _ in rejects) and not all(r for r, _ in rejects)
    assert any(v == gt.max_cost for v, _ in lookups)
    ct, cj = cost_grid(tp), cost_grid(jp)
    assert not ct.reject(0.3, 0.0, 0.0) and not cj.reject(0.3, 0.0, 0.0)
    assert [ct(z) for z in (0.1, 0.25, 2.0)] == [cj(z) for z in (0.1, 0.25, 2.0)]


@pytest.mark.parametrize("objective", ["pathlength", "trackingerror", "balanced"])
def test_path_cost_and_shortcut_match_jax(objective):
    """``path_cost`` of a raw RRT path and ``shortcut`` of it under the
    objective: bitwise; the shortcut never worsens the objective."""
    emap, hs = make_tunnel(wall=True)
    raw = jp.plan(emap, START, GOAL, hs, max_iters=300, seed=1, shortcut_iters=0)
    assert raw is not None
    np.testing.assert_array_equal(tp.plan(emap, START, GOAL, hs, max_iters=300, seed=1,
                                          shortcut_iters=0), raw)
    pc = {tp: cost_grid(tp), jp: cost_grid(jp)}
    costs = {m: m.path_cost(raw, objective, pc[m]) for m in (tp, jp)}
    assert costs[tp] == costs[jp]

    def valid(mod):
        return lambda p: mod._pose_valid(emap, hs, p[0], p[1], p[2], p[3])
    short = {m: m.shortcut(raw, valid(m), objective, pc[m], iters=40, seed=2)
             for m in (tp, jp)}
    np.testing.assert_array_equal(short[tp], short[jp])
    assert tp.path_cost(short[tp], objective, pc[tp]) <= costs[tp]
    with pytest.raises(ValueError):
        tp.path_cost(raw, "trackingerror")
