"""Pose planning through tunnels on the two-layer heightfield (a copy of
``legged_tracking_tpu/utils/planner.py``; numpy on the host, never on the
card).

- ``ROBOT_SIZE``: the robot's half extents, which the env's local planner
  scores candidates with (reference legged_robot_trajectory_tracking.py:1212);
- ``valid_checking``: is a tunnel traversable from start to goal?  The
  terrain builder's ``valid_tunnel_only`` retries a tile until it is
  (reference tunnel.py:107-124, an OMPL RRTConnect query there; a grid BFS
  here, as in the JAX package);
- the offline pose planners over (x, y, z, yaw), which the deploy stack's
  ``PlannerGoalProfile`` and offline tools call: ``plan`` (goal-biased RRT
  with objective-improving ``shortcut``), ``plan_star`` (RRT*, and
  Informed-RRT*), ``plan_prm_star``, ``plan_bit_star``,
  ``plan_rrt_connect``, under the objectives of ``path_cost`` (path
  length, the tracking error of a ``PoseCostGrid``, or both), and
  ``allocate_planner``, the reference's nine-name menu.

Every planner draws from ``np.random.RandomState(seed)``, so for the same
inputs and seed it returns bitwise the JAX module's path and cost.  The menu
keeps the JAX module's aliases: ``fmtstar`` and ``bfmtstar`` run PRM*,
``sorrtstar`` runs Informed-RRT* (``docs/PLANNER_MENU.md``).
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np

ROBOT_SIZE = np.array([0.3762, 0.0935, 0.114])  # half extents (reference :1212)


def _pose_valid(elevation_map, hs, x, y, z, yaw, robot_size=ROBOT_SIZE):
    """Pose collision check against the (2, nx, ny) elevation map (meters).

    The terrain is solid below the floor layer and above the ceiling layer,
    so a yaw-aligned robot ellipsoid at (x, y, z) is free iff for every map
    column inside its footprint ellipse the vertical robot extent
    [z - h, z + h] (h from the ellipsoid cross-section) clears both layers.
    """
    nx, ny = elevation_map.shape[1:]
    r = int(np.ceil(max(robot_size[:2]) / hs)) + 1
    xi = int(round(x / hs))
    yi = int(round(y / hs))
    x0, x1 = max(xi - r, 0), min(xi + r + 1, nx)
    y0, y1 = max(yi - r, 0), min(yi + r + 1, ny)
    if x0 >= x1 or y0 >= y1:
        return False
    gx, gy = np.meshgrid(np.arange(x0, x1) * hs, np.arange(y0, y1) * hs, indexing="ij")
    dx0, dy0 = gx - x, gy - y
    c, s = np.cos(-yaw), np.sin(-yaw)
    dx = c * dx0 - s * dy0
    dy = s * dx0 + c * dy0
    q = (dx / robot_size[0]) ** 2 + (dy / robot_size[1]) ** 2
    inside = q < 1.0
    if not inside.any():
        return True
    h = robot_size[2] * np.sqrt(np.clip(1.0 - q, 0.0, None))
    floor = elevation_map[1, x0:x1, y0:y1]
    ceil = elevation_map[0, x0:x1, y0:y1]
    ok = (floor <= z - h + 1e-6) & (ceil >= z + h - 1e-6)
    return bool(np.all(ok[inside]))


def valid_checking(elevation_map, start_state, goal_state, env_length, env_width,
                   terrain_ratio_y, horizontal_scale, crawl_height: float = 0.27) -> bool:
    """Tunnel traversability via grid BFS (reference planner.valid_checking,
    :467-499).

    elevation_map: (2, nx, ny) meters with x along the tunnel.  start/goal
    follow the reference convention: x measured from the tunnel centre.
    env_length, env_width and terrain_ratio_y are the reference's signature
    and unused, as in the JAX package.
    """
    nx, ny = elevation_map.shape[1:]
    hs = horizontal_scale
    # validity grid at crawl height, yaw = 0
    free = np.zeros((nx, ny), dtype=bool)
    for i in range(nx):
        for j in range(ny):
            z = elevation_map[1, i, j] + crawl_height
            free[i, j] = _pose_valid(elevation_map, hs, i * hs, j * hs, z, 0.0)

    def to_idx(state):
        xi = int(round((state[0] + nx * hs / 2.0) / hs))
        yi = int(round((state[1] + ny * hs / 2.0) / hs))
        return (np.clip(xi, 0, nx - 1), np.clip(yi, 0, ny - 1))

    si, gi = to_idx(start_state), to_idx(goal_state)
    if not free[si]:
        # snap to the nearest free cell in the start column region
        cands = np.argwhere(free[max(si[0] - 2, 0): si[0] + 3])
        if len(cands) == 0:
            return False
        si = (cands[0][0] + max(si[0] - 2, 0), cands[0][1])
    seen = np.zeros_like(free)
    q = deque([si])
    seen[si] = True
    while q:
        i, j = q.popleft()
        if i >= gi[0]:          # reached the goal end of the tunnel
            return True
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ii, jj = i + di, j + dj
            if 0 <= ii < nx and 0 <= jj < ny and free[ii, jj] and not seen[ii, jj]:
                seen[ii, jj] = True
                q.append((ii, jj))
    return False


class PoseCostGrid:
    """Measured tracking-error cost over a (z, roll, pitch) grid.

    The reference's AccuracyObjective (planner.py:141-154) integrates
    100 x a nearest-bin lookup into a 26x26x26 grid loaded from an
    error-measurement CSV (create_pose_cost_fn, planner.py:230-251); poses
    outside the measured box cost the grid maximum.  Same semantics here,
    vectorised.  The companion per-axis reject test mirrors
    create_error_reject_fn (planner.py:253-280).
    """

    def __init__(self, cost, lo, hi, axis_errors=None):
        self.cost = np.asarray(cost, dtype=np.float64)      # (Nz, Nr, Np)
        self.lo = np.asarray(lo, dtype=np.float64)          # (3,) z/roll/pitch
        self.hi = np.asarray(hi, dtype=np.float64)
        self.interval = (self.hi - self.lo) / np.array(self.cost.shape)
        self.max_cost = float(self.cost.max())
        self.axis_errors = axis_errors                      # (3, Nz, Nr, Np) | None

    @classmethod
    def from_csv(cls, path, n: int = 26):
        """Reference CSV layout: space-delimited rows of
        [z, roll, pitch, z_err, roll_err, pitch_err, ..., total_cost] spanning
        an n^3 (z, roll, pitch) sweep (planner.py:230-241)."""
        arr = np.loadtxt(path, delimiter=" ", dtype=float)
        shape = (n, n, n)
        cost = arr[:, -1].reshape(shape)
        z = arr[:, 0].reshape(shape)[:, 0, 0]
        roll = arr[:, 1].reshape(shape)[0, :, 0]
        pitch = arr[:, 2].reshape(shape)[0, 0, :]
        axis_errors = None
        if arr.shape[1] >= 7:
            axis_errors = np.stack([arr[:, 3 + i].reshape(shape) for i in range(3)])
        return cls(cost, lo=[z[0], roll[0], pitch[0]],
                   hi=[z[-1], roll[-1], pitch[-1]], axis_errors=axis_errors)

    def _bins(self, pose):
        pose = np.asarray(pose, dtype=np.float64)
        inside = bool(np.all(pose > self.lo) and np.all(pose < self.hi))
        idx = tuple(((pose - self.lo) / self.interval).astype(int)) if inside else None
        return inside, idx

    def __call__(self, z, roll=0.0, pitch=0.0) -> float:
        inside, idx = self._bins([z, roll, pitch])
        return float(self.cost[idx]) if inside else self.max_cost

    def reject(self, z, roll, pitch, thresholds=(0.05, 0.3, 0.3)) -> bool:
        """True if the measured per-axis tracking error at this pose exceeds
        any threshold (create_error_reject_fn, planner.py:267-280)."""
        if self.axis_errors is None:
            return False
        inside, idx = self._bins([z, roll, pitch])
        if not inside:
            return True
        err = self.axis_errors[(slice(None),) + idx]
        return bool(np.any(err > np.asarray(thresholds)))


def path_cost(path, objective: str = "pathlength", pose_cost=None) -> float:
    """Objective value of an (L, 4) [x, y, z, yaw] path.

    pathlength -> Euclidean xyz length (PathLengthOptimizationObjective);
    trackingerror -> trapezoidal integral of 100 x pose cost along the path
    (StateCostIntegralObjective with interpolation, planner.py:141-154);
    balanced -> sum of both with weight 1.0 each (MultiOptimizationObjective,
    planner.py:409-413).
    """
    path = np.asarray(path, dtype=np.float64)
    seg = np.linalg.norm(np.diff(path[:, :3], axis=0), axis=1)
    length = float(seg.sum())
    if objective == "pathlength":
        return length
    if pose_cost is None:
        raise ValueError(f"objective {objective!r} needs a PoseCostGrid")
    c = np.array([100.0 * pose_cost(p[2]) for p in path])
    integral = float(np.sum(0.5 * (c[:-1] + c[1:]) * seg))
    if objective == "trackingerror":
        return integral
    if objective == "balanced":
        return length + integral
    raise ValueError(f"unknown objective {objective!r}")


def _segment_valid(valid, a, b, resolution=0.08):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    n = max(int(np.ceil(np.linalg.norm(b[:3] - a[:3]) / resolution)), 1)
    for t in np.linspace(0.0, 1.0, n + 1):
        p = a + t * (b - a)
        if not valid(p):
            return False
    return True


def shortcut(path, valid, objective: str = "pathlength", pose_cost=None,
             iters: int = 100, seed: int = 0):
    """Random-shortcut smoothing that only accepts objective-improving cuts —
    the feasible-planner counterpart of OMPL's optimizing planners
    (reference uses RRT*/BIT* with the objective, planner.py:417-424)."""
    rng = np.random.RandomState(seed)
    path = [np.asarray(p, dtype=np.float64) for p in path]
    for _ in range(iters):
        if len(path) < 3:
            break
        i = rng.randint(0, len(path) - 2)
        j = rng.randint(i + 2, len(path))
        cand = path[:i + 1] + path[j:]
        if not _segment_valid(valid, path[i], path[j]):
            continue
        if path_cost(np.stack(cand), objective, pose_cost) < \
                path_cost(np.stack(path), objective, pose_cost):
            path = cand
    return np.stack(path)


def _segment_cost(a, b, objective: str, pose_cost) -> float:
    return path_cost(np.stack([a, b]), objective, pose_cost)


def _informed_sample(rng, start, goal, c_best, lo, hi):
    """Sample (x, y, z) inside the prolate hyperspheroid of transverse
    diameter ``c_best`` and foci start/goal (Informed RRT*, Gammell et al.);
    yaw stays uniform. Used once a first solution bounds the useful set."""
    c_min = np.linalg.norm(goal[:3] - start[:3])
    if not np.isfinite(c_best) or c_best <= c_min + 1e-9:
        return None
    centre = 0.5 * (start[:3] + goal[:3])
    a1 = (goal[:3] - start[:3]) / c_min
    # rotation taking e1 -> a1 (Householder-ish via SVD of outer product)
    M = np.outer(a1, np.array([1.0, 0.0, 0.0]))
    U, _, Vt = np.linalg.svd(M)
    C = U @ np.diag([1.0, 1.0, np.linalg.det(U) * np.linalg.det(Vt)]) @ Vt
    r = np.array([c_best / 2.0,
                  np.sqrt(c_best ** 2 - c_min ** 2) / 2.0,
                  np.sqrt(c_best ** 2 - c_min ** 2) / 2.0])
    # uniform in unit ball
    while True:
        b = rng.uniform(-1.0, 1.0, 3)
        if np.dot(b, b) <= 1.0:
            break
    xyz = C @ (r * b) + centre
    if np.any(xyz < lo[:3]) or np.any(xyz > hi[:3]):
        return None
    return np.concatenate([xyz, [rng.uniform(lo[3], hi[3])]])


def plan_star(elevation_map, start, goal, horizontal_scale,
              max_iters: int = 2000, step_size: float = 0.15,
              goal_bias: float = 0.2, seed: int = 0,
              objective: str = "pathlength",
              pose_cost: PoseCostGrid | None = None,
              gamma: float = 1.5, informed: bool = False):
    """Asymptotically-optimal RRT* over (x, y, z, yaw) with the same
    optimization objectives the reference gives OMPL's RRT*/PRM*/BIT*
    (reference planner.py:156-228,405-424): choose-parent and rewire both
    minimize cost-to-come under ``objective``, with the near-radius
    shrinking as gamma * (log n / n)^(1/4).

    ``informed=True`` adds Informed-RRT* sampling (reference menu
    "informedrrtstar", planner.py:163-164): once a first solution exists and
    the objective is pathlength, samples are drawn from the prolate
    hyperspheroid that can still improve it.

    Returns (path (L,4), cost) or (None, inf). Unlike ``plan`` (feasible
    RRT + objective-improving shortcut), this keeps optimizing the tree
    after the first goal connection, so the returned cost is monotonically
    non-increasing in max_iters.
    """
    rng = np.random.RandomState(seed)
    hs = horizontal_scale
    nx, ny = elevation_map.shape[1:]
    lo = np.array([0.0, 0.0, 0.05, -np.pi])
    hi = np.array([nx * hs, ny * hs, 0.6, np.pi])

    start = np.asarray(start, dtype=np.float64)
    goal = np.asarray(goal, dtype=np.float64)

    def valid(p):
        return _pose_valid(elevation_map, hs, p[0], p[1], p[2], p[3])

    if not valid(start):
        return None, float("inf")

    nodes = [start]
    parents = [-1]
    costs = [0.0]           # cost-to-come under the objective
    goal_ids = []           # nodes within connection range of the goal
    c_best = float("inf")   # best goal-path length (informed bound)

    for _ in range(max_iters):
        target = None
        if informed and goal_ids and objective == "pathlength" and \
                rng.rand() >= goal_bias:
            target = _informed_sample(rng, start, goal, c_best, lo, hi)
        if target is None:
            target = goal if rng.rand() < goal_bias else rng.uniform(lo, hi)
        pts = np.stack(nodes)
        d = np.linalg.norm(pts[:, :3] - target[:3], axis=1)
        ni = int(np.argmin(d))
        near = nodes[ni]
        direction = target - near
        dist = np.linalg.norm(direction[:3])
        if dist < 1e-6:
            continue
        new = near + direction * min(step_size / dist, 1.0)
        new[3] = np.arctan2(np.sin(new[3]), np.cos(new[3]))
        if not valid(new):
            continue
        n = len(nodes)
        radius = max(step_size, gamma * (np.log(n + 1) / (n + 1)) ** 0.25)
        dn = np.linalg.norm(pts[:, :3] - new[:3], axis=1)
        near_ids = np.flatnonzero(dn <= radius)
        # choose parent: minimal cost-to-come among reachable near nodes
        best_p, best_c = ni, costs[ni] + _segment_cost(near, new, objective,
                                                       pose_cost)
        for j in near_ids:
            if j == ni:
                continue
            c = costs[j] + _segment_cost(nodes[j], new, objective, pose_cost)
            if c < best_c and _segment_valid(valid, nodes[j], new):
                best_p, best_c = int(j), c
        if best_p == ni and not _segment_valid(valid, near, new):
            continue
        nodes.append(new)
        parents.append(best_p)
        costs.append(best_c)
        new_id = len(nodes) - 1
        # rewire the neighborhood through the new node
        for j in near_ids:
            c = best_c + _segment_cost(new, nodes[j], objective, pose_cost)
            if c < costs[j] and _segment_valid(valid, new, nodes[j]):
                parents[j] = new_id
                costs[j] = c
        if np.linalg.norm(new[:3] - goal[:3]) < step_size and \
                _segment_valid(valid, new, goal):
            goal_ids.append(new_id)
            c_best = min(c_best,
                         best_c + np.linalg.norm(new[:3] - goal[:3]))

    if not goal_ids:
        return None, float("inf")

    # rewiring can leave descendant costs-to-come stale, so score each goal
    # connection by walking its current ancestry and summing fresh segment
    # costs (equivalently: path_cost of the extracted path)
    def extract(j):
        path = [goal]
        k = j
        while k >= 0:
            path.append(nodes[k])
            k = parents[k]
        return np.stack(path[::-1])

    cands = [extract(j) for j in goal_ids]
    totals = [path_cost(p, objective, pose_cost) for p in cands]
    k = int(np.argmin(totals))
    return cands[k], float(totals[k])


def plan(elevation_map, start, goal, horizontal_scale, max_iters: int = 2000,
         step_size: float = 0.15, goal_bias: float = 0.2, seed: int = 0,
         objective: str = "pathlength", pose_cost: PoseCostGrid | None = None,
         shortcut_iters: int = 100):
    """Goal-biased RRT over (x, y, z, yaw) (reference planner.plan, :318-456).

    start/goal: (4,) [x, y, z, yaw] in map-local meters.  Returns an (L, 4)
    waypoint array or None.  ``objective`` selects the optimization objective
    applied during post-smoothing: "pathlength" | "trackingerror" |
    "balanced" (reference planner.py:405-416; the latter two need a
    ``PoseCostGrid``).
    """
    rng = np.random.RandomState(seed)
    hs = horizontal_scale
    nx, ny = elevation_map.shape[1:]
    lo = np.array([0.0, 0.0, 0.05, -np.pi])
    hi = np.array([nx * hs, ny * hs, 0.6, np.pi])

    start = np.asarray(start, dtype=np.float64)
    goal = np.asarray(goal, dtype=np.float64)
    nodes = [start]
    parents = [-1]

    def valid(p):
        return _pose_valid(elevation_map, hs, p[0], p[1], p[2], p[3])

    if not valid(start):
        return None
    for _ in range(max_iters):
        target = goal if rng.rand() < goal_bias else rng.uniform(lo, hi)
        d = np.array([np.linalg.norm((n[:3] - target[:3])) for n in nodes])
        ni = int(np.argmin(d))
        near = nodes[ni]
        direction = target - near
        dist = np.linalg.norm(direction[:3])
        if dist < 1e-6:
            continue
        new = near + direction * min(step_size / dist, 1.0)
        new[3] = np.arctan2(np.sin(new[3]), np.cos(new[3]))
        # segment check, not just the endpoint — a bare endpoint test lets
        # 0.15 m extensions hop clean over thin (2-cell) walls
        if not (valid(new) and _segment_valid(valid, near, new)):
            continue
        nodes.append(new)
        parents.append(ni)
        if np.linalg.norm(new[:3] - goal[:3]) < step_size and \
                _segment_valid(valid, new, goal):
            path = [goal, new]
            k = ni
            while k >= 0:
                path.append(nodes[k])
                k = parents[k]
            raw = np.stack(path[::-1])
            if shortcut_iters > 0:
                return shortcut(raw, valid, objective, pose_cost,
                                iters=shortcut_iters, seed=seed)
            return raw
    return None


def plan_prm_star(elevation_map, start, goal, horizontal_scale,
                  num_samples: int = 600, seed: int = 0,
                  objective: str = "pathlength",
                  pose_cost: PoseCostGrid | None = None,
                  k_scale: float = 1.0):
    """PRM* over (x, y, z, yaw) (reference menu "prmstar", planner.py:166-167).

    Batch-samples a roadmap of valid poses, connects each node to its
    k* = k_scale * e * (1 + 1/d) * log(n) nearest neighbours, and runs lazy
    Dijkstra from start to goal under ``objective`` — edges are
    collision-checked only when first relaxed (Lazy-PRM evaluation order),
    which skips most of the O(n k) segment checks on easy maps.

    Returns (path (L,4), cost) or (None, inf).
    """
    rng = np.random.RandomState(seed)
    hs = horizontal_scale
    nx, ny = elevation_map.shape[1:]
    lo = np.array([0.0, 0.0, 0.05, -np.pi])
    hi = np.array([nx * hs, ny * hs, 0.6, np.pi])

    start = np.asarray(start, dtype=np.float64)
    goal = np.asarray(goal, dtype=np.float64)

    def valid(p):
        return _pose_valid(elevation_map, hs, p[0], p[1], p[2], p[3])

    if not valid(start) or not valid(goal):
        return None, float("inf")

    nodes = [start, goal]
    # bounded rejection sampling: on a map with near-zero valid-pose
    # fraction the unbounded loop would spin forever on the host — cap
    # total attempts and plan over whatever roadmap exists (returning
    # (None, inf) like plan/plan_star if the graph stays disconnected)
    attempts = 0
    max_attempts = 200 * num_samples
    while len(nodes) < num_samples + 2 and attempts < max_attempts:
        cand = rng.uniform(lo, hi)
        attempts += 1
        if valid(cand):
            nodes.append(cand)
    pts = np.stack(nodes)
    n = len(nodes)
    # PRM* connection count in d=3 (yaw is free): e*(1+1/3)*log n
    k = max(int(np.ceil(k_scale * np.e * (1.0 + 1.0 / 3.0) * np.log(n))), 4)
    k = min(k, n - 1)
    d2 = np.linalg.norm(pts[:, None, :3] - pts[None, :, :3], axis=-1)
    np.fill_diagonal(d2, np.inf)
    knn_d = np.argsort(d2, axis=1)[:, :k]
    # symmetrized neighbour relation (PRM*/OMPL connect both directions):
    # a directed i->knn[i] roadmap drops usable edges when the relation is
    # asymmetric and voids the k* optimality constant
    adj = [set(row) for row in knn_d.tolist()]
    for i, row in enumerate(knn_d):
        for j in row:
            adj[int(j)].add(i)
    knn = [sorted(s) for s in adj]

    dist = np.full(n, np.inf)
    dist[0] = 0.0
    prev = np.full(n, -1, dtype=int)
    checked: dict[tuple[int, int], bool] = {}
    heap = [(0.0, 0)]
    while heap:
        c, i = heapq.heappop(heap)
        if c > dist[i]:
            continue
        if i == 1:      # goal reached with settled cost
            break
        for j in knn[i]:
            j = int(j)
            nc = c + _segment_cost(nodes[i], nodes[j], objective, pose_cost)
            if nc >= dist[j]:
                continue
            key = (min(i, j), max(i, j))
            ok = checked.get(key)
            if ok is None:
                ok = _segment_valid(valid, nodes[i], nodes[j])
                checked[key] = ok
            if not ok:
                continue
            dist[j] = nc
            prev[j] = i
            heapq.heappush(heap, (nc, j))

    if not np.isfinite(dist[1]):
        return None, float("inf")
    path = [1]
    while path[-1] != 0:
        path.append(int(prev[path[-1]]))
    out = np.stack([nodes[i] for i in path[::-1]])
    return out, float(dist[1])


def plan_bit_star(elevation_map, start, goal, horizontal_scale,
                  batch_size: int = 150, max_batches: int = 12,
                  seed: int = 0, objective: str = "pathlength",
                  pose_cost: PoseCostGrid | None = None, eta: float = 1.5,
                  num_samples: int | None = None):
    """Batch Informed Trees (BIT*, Gammell et al. 2015) over (x, y, z, yaw)
    — the real algorithm behind the reference menu name "bitstar"
    (reference planner.py:157-160 links ompl.geometric.BITstar).

    Per batch: (1) prune samples that cannot improve the incumbent, (2) add
    ``batch_size`` new samples — drawn inside the prolate hyperspheroid of
    transverse diameter ``c_best`` once a solution exists (_informed_sample),
    (3) process a lazy EDGE QUEUE ordered by the solution-cost lower bound
    f̂(v, x) = g(v) + ĉ(v, x) + ĥ(x), collision-checking edges only when
    popped, connecting samples into the tree and rewiring tree vertices,
    until the best queue bound cannot beat the incumbent.  Anytime: the
    incumbent cost is monotonically tightened across batches.

    Heuristics: for "pathlength" ĉ/ĥ are Euclidean distances (admissible —
    path_cost integrates straight segments); for the tracking-error
    objectives they are 0 (admissible for any nonnegative segment cost, at
    the price of less queue pruning).  RGG connection radius shrinks as
    r = eta * (log q / q)^(1/3) * diag like the PRM*/RRT* family.

    Returns (path (L, 4), cost) or (None, inf).
    """
    if num_samples is not None:      # a total sample budget, as PRM* takes
        max_batches = max(1, -(-int(num_samples) // batch_size))
    rng = np.random.RandomState(seed)
    hs = horizontal_scale
    nx, ny = elevation_map.shape[1:]
    lo = np.array([0.0, 0.0, 0.05, -np.pi])
    hi = np.array([nx * hs, ny * hs, 0.6, np.pi])
    diag = np.linalg.norm((hi - lo)[:3])

    start = np.asarray(start, dtype=np.float64)
    goal = np.asarray(goal, dtype=np.float64)

    def valid(p):
        return _pose_valid(elevation_map, hs, p[0], p[1], p[2], p[3])

    if not valid(start) or not valid(goal):
        return None, float("inf")

    use_h = objective == "pathlength"
    ghat = (lambda p: np.linalg.norm(p[:3] - start[:3])) if use_h else (lambda p: 0.0)
    hhat = (lambda p: np.linalg.norm(goal[:3] - p[:3])) if use_h else (lambda p: 0.0)
    chat = (lambda a, b: np.linalg.norm(b[:3] - a[:3])) if use_h else (lambda a, b: 0.0)

    nodes = [start.copy(), goal.copy()]        # 0 = start, 1 = goal
    in_tree = [True, False]
    g = [0.0, float("inf")]
    parent = [-1, -1]
    samples = {1}
    c_best = float("inf")
    edge_checked: dict[tuple[int, int], float] = {}   # true cost or inf

    def true_cost(i, j):
        key = (min(i, j), max(i, j))
        c = edge_checked.get(key)
        if c is None:
            c = (_segment_cost(nodes[i], nodes[j], objective, pose_cost)
                 if _segment_valid(valid, nodes[i], nodes[j])
                 else float("inf"))
            edge_checked[key] = c
        return c

    for _ in range(max_batches):
        # ---- prune + new informed batch ----
        if np.isfinite(c_best):
            samples = {i for i in samples
                       if ghat(nodes[i]) + hhat(nodes[i]) < c_best - 1e-12}
            samples.add(1) if not in_tree[1] else None
        added, attempts = 0, 0
        while added < batch_size and attempts < 200 * batch_size:
            attempts += 1
            cand = None
            if np.isfinite(c_best) and use_h:
                cand = _informed_sample(rng, start, goal, c_best, lo, hi)
                if cand is None:
                    continue
            else:
                cand = rng.uniform(lo, hi)
            if valid(cand):
                nodes.append(cand)
                in_tree.append(False)
                g.append(float("inf"))
                parent.append(-1)
                samples.add(len(nodes) - 1)
                added += 1

        # ---- RGG radius over the current vertex+sample count ----
        q = max(len(samples) + sum(in_tree), 2)
        r = max(eta * diag * (np.log(q) / q) ** (1.0 / 3.0), 0.35)

        # ---- build the lazy edge queue ----
        pts = np.stack(nodes)
        tree_ids = [i for i, t in enumerate(in_tree) if t]
        heap = []
        for v in tree_ids:
            d = np.linalg.norm(pts[:, :3] - pts[v, None, :3], axis=-1)
            for x in np.nonzero(d <= r)[0]:
                x = int(x)
                if x == v or parent[x] == v or parent[v] == x:
                    continue
                fhat = g[v] + chat(nodes[v], nodes[x]) + hhat(nodes[x])
                if fhat < c_best - 1e-12:
                    heapq.heappush(heap, (fhat, v, x))

        # ---- process edges best-bound-first ----
        while heap:
            fhat, v, x = heapq.heappop(heap)
            if fhat >= c_best - 1e-12:
                break                            # nothing left can improve
            if not in_tree[v]:
                continue
            c = true_cost(v, x)
            gx_new = g[v] + c
            if not np.isfinite(c) or gx_new + hhat(nodes[x]) >= c_best - 1e-12:
                continue
            if gx_new < g[x] - 1e-12:
                g[x] = gx_new
                parent[x] = v
                if not in_tree[x]:
                    in_tree[x] = True
                    samples.discard(x)
                    # expand the fresh vertex's own neighbourhood
                    d = np.linalg.norm(pts[:, :3] - pts[x, None, :3], axis=-1)
                    for y in np.nonzero(d <= r)[0]:
                        y = int(y)
                        if y == x or parent[y] == x:
                            continue
                        fh = g[x] + chat(nodes[x], nodes[y]) + hhat(nodes[y])
                        if fh < c_best - 1e-12:
                            heapq.heappush(heap, (fh, x, y))
                else:
                    # rewiring: push improved bounds from x's subtree root
                    d = np.linalg.norm(pts[:, :3] - pts[x, None, :3], axis=-1)
                    for y in np.nonzero(d <= r)[0]:
                        y = int(y)
                        if y != x and parent[y] != x:
                            fh = (g[x] + chat(nodes[x], nodes[y])
                                  + hhat(nodes[y]))
                            if fh < c_best - 1e-12:
                                heapq.heappush(heap, (fh, x, y))
                if x == 1 or g[1] < c_best:
                    c_best = min(c_best, g[1])

    if not in_tree[1] or not np.isfinite(g[1]):
        return None, float("inf")
    path = [1]
    while path[-1] != 0:
        path.append(parent[path[-1]])
    out = np.stack([nodes[i] for i in path[::-1]])
    # recompute from the final parent chain: ancestor rewiring can leave
    # descendant g[] values stale (costs only tighten, never loosen)
    return out, path_cost(out, objective, pose_cost)


def plan_rrt_connect(elevation_map, start, goal, horizontal_scale,
                     max_iters: int = 2000, step_size: float = 0.3,
                     seed: int = 0, objective: str = "pathlength",
                     pose_cost: PoseCostGrid | None = None,
                     shortcut_iters: int = 100):
    """Bidirectional RRT-Connect (reference menu "rrtconnect",
    planner.py:171-175 — the reference also sets range 0.3 there, matched by
    the ``step_size`` default). Feasible-path planner: alternating trees with
    a greedy connect extension, then objective-improving shortcut smoothing
    (the reference relies on OMPL's optimizing variants for cost; RRTConnect
    there returns the raw feasible path).

    Returns (path (L,4), cost) or (None, inf).
    """
    rng = np.random.RandomState(seed)
    hs = horizontal_scale
    nx, ny = elevation_map.shape[1:]
    lo = np.array([0.0, 0.0, 0.05, -np.pi])
    hi = np.array([nx * hs, ny * hs, 0.6, np.pi])

    start = np.asarray(start, dtype=np.float64)
    goal = np.asarray(goal, dtype=np.float64)

    def valid(p):
        return _pose_valid(elevation_map, hs, p[0], p[1], p[2], p[3])

    if not valid(start) or not valid(goal):
        return None, float("inf")

    trees = [{"nodes": [start], "parents": [-1]},
             {"nodes": [goal], "parents": [-1]}]

    def extend(tree, target):
        """One step toward target; returns (status, new_id)."""
        pts = np.stack(tree["nodes"])
        d = np.linalg.norm(pts[:, :3] - target[:3], axis=1)
        ni = int(np.argmin(d))
        near = tree["nodes"][ni]
        diff = target - near
        diff[3] = np.arctan2(np.sin(diff[3]), np.cos(diff[3]))
        dist = np.linalg.norm(diff[:3])
        if dist < 1e-9:
            return "reached", ni
        new = near + diff * min(step_size / dist, 1.0)
        new[3] = np.arctan2(np.sin(new[3]), np.cos(new[3]))
        if not (valid(new) and _segment_valid(valid, near, new)):
            return "trapped", -1
        tree["nodes"].append(new)
        tree["parents"].append(ni)
        nid = len(tree["nodes"]) - 1
        if dist <= step_size:
            return "reached", nid
        return "advanced", nid

    def connect(tree, target):
        """Greedy repeated extend toward target (the Connect heuristic)."""
        while True:
            status, nid = extend(tree, target)
            if status != "advanced":
                return status, nid

    def walk(tree, i):
        path = []
        while i >= 0:
            path.append(tree["nodes"][i])
            i = tree["parents"][i]
        return path

    a, b = 0, 1
    for _ in range(max_iters):
        target = rng.uniform(lo, hi)
        status, nid = extend(trees[a], target)
        if status != "trapped":
            probe = trees[a]["nodes"][nid]
            status_b, nid_b = connect(trees[b], probe)
            if status_b == "reached":
                pa = walk(trees[a], nid)[::-1]      # start tree: root..probe
                pb = walk(trees[b], nid_b)          # goal tree: meet..root
                full = pa + pb
                if a == 1:                          # trees were swapped
                    full = full[::-1]
                raw = np.stack(full)
                if shortcut_iters > 0:
                    raw = shortcut(raw, valid, objective, pose_cost,
                                   iters=shortcut_iters, seed=seed)
                return raw, path_cost(raw, objective, pose_cost)
        a, b = b, a
    return None, float("inf")


def _plan_feasible(elevation_map, start, goal, horizontal_scale, **kw):
    p = plan(elevation_map, start, goal, horizontal_scale, **kw)
    if p is None:
        return None, float("inf")
    return p, path_cost(p, kw.get("objective", "pathlength"),
                        kw.get("pose_cost"))


# Native planner menu mirroring the reference's allocatePlanner
# (planner.py:156-178). bitstar is a real Batch Informed Trees
# implementation (plan_bit_star). The OMPL marching planners
# (FMT*, BFMT*) remain ALIASES of PRM* — the same batch-sampled
# asymptotically-optimal roadmap family — and SORRT* of Informed-RRT*, its
# direct ancestor; each alias keeps the reference's planner NAME valid with
# the closest native algorithm (flagged in docs/PLANNER_MENU.md rows).
_PLANNERS = {
    "rrt": _plan_feasible,
    "rrtconnect": plan_rrt_connect,
    "rrtstar": plan_star,
    "informedrrtstar": lambda *a, **k: plan_star(*a, informed=True, **k),
    "sorrtstar": lambda *a, **k: plan_star(*a, informed=True, **k),
    "prmstar": plan_prm_star,
    "bitstar": plan_bit_star,
    "fmtstar": plan_prm_star,
    "bfmtstar": plan_prm_star,
}


def allocate_planner(planner_type: str):
    """Planner factory (reference allocatePlanner, planner.py:156-178).

    Returns ``fn(elevation_map, start, goal, horizontal_scale, *,
    objective=..., pose_cost=..., seed=..., **planner_kw) -> (path, cost)``
    where path is (L, 4) [x, y, z, yaw] or None and cost is the objective
    value (inf on failure). All planners accept the same three objectives
    ("pathlength" | "trackingerror" | "balanced").
    """
    try:
        return _PLANNERS[planner_type.lower()]
    except KeyError:
        raise ValueError(
            f"Planner-type {planner_type!r} is not implemented in allocation "
            f"function. Options: {sorted(_PLANNERS)}") from None
