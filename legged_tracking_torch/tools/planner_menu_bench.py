"""Comparative benchmark of the port's offline planner menu on random
slalom tunnels (counterpart of the repo's ``tools/planner_menu_bench.py``).

    python -m legged_tracking_torch.tools.planner_menu_bench [n_tunnels] [--out FILE]

Runs every ``allocate_planner`` name of the port's ``utils/planner.py``
(the reference's allocatePlanner, go1_gym/utils/planner.py:156-178) over
randomized slalom tunnels and prints success rate, mean path length and
mean wall time as a markdown table; writes it only to ``--out``.  The
planners are numpy on the host: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..utils.planner import _pose_valid, allocate_planner, path_cost, valid_checking

NAMES = ["rrt", "rrtconnect", "rrtstar", "informedrrtstar", "sorrtstar",
         "prmstar", "bitstar", "fmtstar", "bfmtstar"]
ALIAS = {"fmtstar": "prmstar", "bfmtstar": "prmstar", "sorrtstar": "informedrrtstar"}


def make_tunnel(rng, nx=80, ny=30, hs=0.05, ceiling=0.8):
    """Random slalom: staggered part-width walls with alternating gaps.

    Walls sit in slots >= 1.0 m apart (the Go1 ellipsoid is 0.75 m long, so
    it must fully fit between consecutive walls to shift lanes) and, like the
    reference's valid_tunnel_only terrain filter (tunnel.py:107-124),
    candidates are regenerated until the BFS validity check passes (bounded
    attempts; the filter rejects only rare edge geometries)."""
    start = np.array([-1.6, 0, 0.27, 0, 0, 0, 1.0])
    goal = np.array([1.6, 0, 0.27, 0, 0, 0, 1.0])
    for _ in range(50):
        emap = np.zeros((2, nx, ny))
        emap[0] = ceiling
        # wall slots keep >=0.45 m of clearance to start (0.4 m) and goal
        # (3.6 m): the robot half-LENGTH is 0.38 m, so endpoints nearer a
        # wall row are invalid poses, not hard tunnels
        for i, slot in enumerate((19, 38, 57)):
            x = slot + rng.randint(-1, 2)
            free = rng.randint(12, 16)          # 0.60-0.75 m gap
            if i % 2 == 0:
                emap[1, x:x + 2, :ny - free] = 0.7
            else:
                emap[1, x:x + 2, free:] = 0.7
        if (_pose_valid(emap, hs, 0.4, 0.75, 0.27, 0.0)
                and _pose_valid(emap, hs, 3.6, 0.75, 0.27, 0.0)
                and valid_checking(emap, start, goal, 4.0, 1.5, 0.5, hs)):
            return emap, hs
    raise RuntimeError("no traversable slalom found in 50 attempts")


def menu_rows(n_tunnels: int) -> dict:
    """{planner name: successes, path lengths, seconds} over tunnels of
    seeds 100, 101, ...; the JAX tool's budgets."""
    rows = {n: {"ok": 0, "cost": [], "t": []} for n in NAMES}
    for t in range(n_tunnels):
        emap, hs = make_tunnel(np.random.RandomState(100 + t))
        start = np.array([0.4, 0.75, 0.27, 0.0])
        goal = np.array([3.6, 0.75, 0.27, 0.0])
        for name in NAMES:
            fn = allocate_planner(name)
            # comparable budgets: graph planners get a roadmap sized to the
            # narrow-passage yaw fraction, tree planners more iterations
            kw = ({"num_samples": 1500} if name in ("prmstar", "bitstar", "fmtstar", "bfmtstar")
                  else {"max_iters": 4000})
            t0 = time.perf_counter()
            path, _ = fn(emap, start, goal, hs, seed=t, **kw)
            rows[name]["t"].append(time.perf_counter() - t0)
            if path is not None:
                rows[name]["ok"] += 1
                rows[name]["cost"].append(path_cost(path, "pathlength"))
    return rows


def table(rows: dict, n_tunnels: int) -> str:
    out = ["# Planner menu of the port — comparative benchmark",
           "",
           f"{n_tunnels} randomized 3-wall slalom tunnels (4.0 m x 1.5 m, "
           "0.05 m cells, 0.8 m ceiling), start (0.4, 0.75) -> goal "
           "(3.6, 0.75), pathlength objective, the port's numpy copy of the "
           "JAX package's planner menu (legged_tracking_torch/utils/planner.py). "
           "The rows marked \"alias\" dispatch to the named algorithm.",
           "",
           "| planner | success | mean path length (m) | mean time (s) |",
           "|---|---|---|---|"]
    for name in NAMES:
        r = rows[name]
        mc = np.mean(r["cost"]) if r["cost"] else float("nan")
        label = f"{name} (alias of {ALIAS[name]})" if name in ALIAS else name
        out.append(f"| {label} | {r['ok']}/{n_tunnels} | {mc:.3f} | {np.mean(r['t']):.3f} |")
    out += ["", "Regenerate: `python -m legged_tracking_torch.tools.planner_menu_bench "
            "--out FILE`."]
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_tunnels", type=int, nargs="?", default=12)
    ap.add_argument("--out", default=None, help="also write the table here")
    args = ap.parse_args(argv)
    if args.n_tunnels < 1:
        ap.error("n_tunnels must be >= 1")
    text = table(menu_rows(args.n_tunnels), args.n_tunnels)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, end="")


if __name__ == "__main__":
    main()
