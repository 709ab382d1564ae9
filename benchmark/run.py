"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload tunnel-train-4096 --seed 7 --seconds 30 --trace 0

Set-up builds the cell's env, policy and optimizer from its configuration
file and ``--seed`` and runs the first train iterations (``setup_iterations``
of the traffic file) through ``PPO.train_iteration``: they warm up every
shape, and the first of them is what the reference checks (each env step
of its rollout is recorded on the CPU for it).  The window then runs
``PPO.train_iteration`` back to back until ``--seconds`` have passed, and
ends at the end of the iteration that crosses it; the device is
synchronized before each clock read.  With ``--trace 1`` the rollout and
update are timed as spans inside the window, and one more iteration runs
under the profiler after it.  The program's state is then freed, and the
plain reference checks the first iteration to decide ``correct``
(``reference/train.py``, ``compare.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (window iterations, and those whose value loss
is not finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, as ``BENCHMARK.json`` lists them),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number of the check with its limit.  Exits 2 without the cards the cell
asks for and 3 when JAX or the JAX package is loaded, printing no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from benchmark import build, compare, counts, host, manifest  # noqa: E402
from benchmark import trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "legged_tracking_tpu")
GIB = 2 ** 30


def set_cache_dirs():
    """Fixed build and kernel cache directories inside the checkout; the
    port builds its CUDA kernels into ``build/kernels/`` there itself."""
    build_dir = os.path.join(manifest.CHECKOUT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build_dir, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build_dir, "torch_extensions")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _profiled_iteration(train, device) -> tuple[dict, float]:
    """One train iteration under the profiler, with B1's launches recorded
    (their inputs, for its bound).  Returns (the reduced profile, B1's
    least seconds over its launches)."""
    import legged_tracking_torch.envs.legged_env as legged_env

    scans = []
    scan = legged_env.scan_heights

    def recorded(*args):
        scans.append(args)
        return scan(*args)

    env, alg, ts, state, obs = train
    legged_env.scan_heights = recorded
    try:
        with tr.ranges(alg):
            prof = tr.profile(lambda: alg.train_iteration(ts, state, obs), device)
    finally:
        legged_env.scan_heights = scan
    return prof, sum(counts.scan_bound_s(*a) for a in scans)


def rank_body(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
              rank: int = 0, world: int = 1, overrides: dict | None = None,
              t_start: float = T_START, fault: str | None = None) -> dict:
    """Set-up, window and (with ``trace``) the profiled iteration of one
    rank, with ``fault`` (tests only: one of :data:`benchmark.faults.KINDS`)
    planted in the program; the program's objects are freed when it
    returns."""
    import torch
    from legged_tracking_torch.parallel import entry_device

    from benchmark import faults, program

    planted = (faults.plant(fault, *program.fault_targets()) if fault
               else contextlib.nullcontext())
    with planted:
        return _rank_body(cell, seed, seconds, trace, entry_device(device), rank, world,
                          overrides, t_start)


def _rank_body(cell, seed, seconds, trace, device, rank, world, overrides, t_start):
    import torch

    from benchmark import program

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    train = build.build(program.modules(), cell.config, cell.num_envs, seed, device,
                        rank_world=(rank, world), overrides=overrides,
                        ppo_overrides=cell.traffic.get("ppo"))
    t_steps = time.perf_counter()
    train, readings = build.first_steps(train, int(cell.traffic["setup_iterations"]),
                                        compare.UPDATE_STEPS)
    tr.synchronize(device)
    t_setup = time.perf_counter()
    out = {"setup_s": t_setup - t_start, "readings": readings,
           "setup_parts": {"start": t_build - t_start, "build": t_steps - t_build,
                           "first_steps": t_setup - t_steps}}

    env, alg, ts, state, obs = train
    spans = {}
    losses, ends, done = [], [], False
    speed0 = host.speed(device)
    tr.synchronize(device)
    t0 = time.perf_counter()
    h0 = host.sample()
    with tr.spans(alg, device, spans) if trace else contextlib.nullcontext():
        while not done:
            ts, state, obs, m = alg.train_iteration(ts, state, obs)
            losses.append(m["value_loss"])
            tr.synchronize(device)
            t = time.perf_counter()
            ends.append(t - t0)
            done = t - t0 >= seconds
            if world > 1:
                # rank 0's clock ends the window on every rank
                import torch.distributed as dist
                flag = torch.tensor(int(done), device=device)
                dist.broadcast(flag, 0)
                done = bool(flag.item())
    out.update(window_s=t - t0, iterations=len(ends), ends=ends,
               host={**host.delta(h0, host.sample()), "before": speed0,
                     "after": host.speed(device)},
               failed=int((~torch.isfinite(torch.stack(losses))).sum()),
               peak_bytes=int(torch.cuda.max_memory_allocated(device)) if cuda else None,
               spans=spans)
    if trace:
        prof, b1_bound = _profiled_iteration(build.Train(env, alg, ts, state, obs), device)
        out.update(profile=prof, b1_bound_s=b1_bound)
    return out


def _rank_main(cell, seed, seconds, trace, device, overrides, t_start, fault, outdir):
    """A spawned rank: :func:`rank_body`, saved for the parent to read."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    out = rank_body(cell, seed, seconds, trace, device, rank, world, overrides, t_start, fault)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def run_ranks(cell, seed, seconds, trace, device, overrides, backend=None, fault=None) -> dict:
    """:func:`rank_body` in the cell's ranks: in this process for one, else
    one spawned process a rank (``legged_tracking_torch.parallel.launch``),
    each card its own; rank 0's numbers, with the ranks' rollouts joined in
    env order and the fullest card's peak."""
    import torch

    ranks = int(cell.traffic["ranks"])
    if ranks == 1:
        return rank_body(cell, seed, seconds, trace, device, overrides=overrides, fault=fault)
    from legged_tracking_torch.parallel import launch

    with tempfile.TemporaryDirectory() as outdir:
        launch(_rank_main, ranks, cell, seed, seconds, trace, device, overrides, T_START,
               fault, outdir, backend=backend, device=device)
        outs = [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(ranks)]
    out = outs[0]
    out["readings"] = join_ranks([o["readings"] for o in outs])
    if out["peak_bytes"] is not None:
        out["peak_bytes"] = max(o["peak_bytes"] for o in outs)
    return out


# the env state's fields that every rank holds whole (no env axis)
GLOBAL_FIELDS = ("gravity_vec", "common_step", "exploration_lin_scale",
                 "exploration_yaw_scale", "target_dist", "curriculum_weights")


def join_ranks(readings: list) -> dict:
    """The ranks' readings of :func:`benchmark.build.first_steps` joined in
    env order: their trajectories, last observations, recorded env states,
    rewards and time-outs; the rest (weights, losses, the env generator's
    state, the global state fields) is rank 0's."""
    import torch

    n = readings[0]["traj"]["actions"].shape[1]

    def state(states):
        parts = {}
        for name in states[0]._fields:
            xs = [getattr(st, name) for st in states]
            if hasattr(xs[0], "_fields"):
                parts[name] = state(xs)
            elif (isinstance(xs[0], torch.Tensor) and name not in GLOBAL_FIELDS
                  and xs[0].ndim and xs[0].shape[0] == n):
                parts[name] = torch.cat(xs)
            else:
                parts[name] = xs[0]
        return type(states[0])(**parts)

    out = dict(readings[0])
    out["traj"] = {k: torch.cat([r["traj"][k] for r in readings], dim=1)
                   for k in out["traj"]}
    out["last_obs"] = {k: torch.cat([r["last_obs"][k] for r in readings])
                       for k in out["last_obs"]}
    out["final_state"] = state([r["final_state"] for r in readings])
    out["steps"] = [{"state": state([r["steps"][t]["state"] for r in readings]),
                     "gen": step["gen"],
                     **{k: torch.cat([r["steps"][t][k] for r in readings])
                        for k in ("rew", "time_outs")}}
                    for t, step in enumerate(readings[0]["steps"])]
    return out


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, doc: dict | None = None,
             root: str = manifest.BENCH_DIR, backend: str | None = None,
             fault: str | None = None) -> tuple[dict, dict]:
    """One run of ``cell``: the program's ranks, then the reference.
    Returns the result (the JSON object of the module docstring, without
    its device's name) and notes for standard error (set-up parts, window
    iteration ends, the worst leaves, the profiler's stretch).
    ``overrides``, ``root``, ``backend`` and ``fault`` are for the tests (a
    small cell on the CPU, pieces in a folder of their own, gloo ranks, a
    fault planted in the program)."""
    import torch

    from benchmark.reference import train as reference

    doc = doc if doc is not None else manifest.benchmark_json()
    device = torch.device(device)
    out = run_ranks(cell, seed, seconds, trace, device, overrides, backend, fault)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.follow(cell.config, cell.num_envs, seed, device, out["readings"],
                           overrides=overrides, ppo_overrides=cell.traffic.get("ppo"))
    gaps = compare.gaps(out["readings"], ref)
    correct, rows = compare.verdict(gaps, cell.limits)
    cuda = device.type == "cuda"
    ctx = {"cell": cell, "device_type": device.type, "window_s": out["window_s"],
           "iterations": out["iterations"], "num_envs": cell.num_envs,
           "steps_per_iteration": cell.ppo["num_steps_per_env"],
           "flop_per_iteration": counts.iteration_flop({**cell.config, "ppo": cell.ppo},
                                                       cell.num_envs)["total"],
           "spans": out["spans"], "profile": out.get("profile"),
           "b1_bound_s": out.get("b1_bound_s")}
    metrics = {}
    if not trace:
        e2e = {"env_steps_per_s": cell.num_envs * ctx["steps_per_iteration"]
               * out["iterations"] / out["window_s"],
               "peak_mem_gib": out["peak_bytes"] / GIB if cuda else None,
               "setup_s": out["setup_s"]}
        for m in manifest.cell_metrics(doc, cell.name, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in manifest.cell_metrics(doc, cell.name, "per_layer"):
            value = manifest.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["iterations"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "count": cell.chips,
                         "memory_peak_bytes": out["peak_bytes"]}}
    notes = {"setup_parts": out["setup_parts"], "window_ends": out["ends"],
             "setup_iteration_s": out["readings"]["iteration_s"],
             "host": out["host"],
             "worst": {"grad": gaps["grad_leaf"], "change": gaps["change_leaf"]},
             "quiet_leaves": gaps["quiet_leaves"],
             "steps": gaps["step_parts"]}
    if trace:
        prof = out["profile"]
        result["device"].update(busy_s=prof["busy_s"], window_s=prof["span_s"])
        result["breakdown"] = {"device_ops": tr.top_ops(prof["kernels"]),
                               "idle_gaps": prof["idle_gaps"]}
        notes.update(profiled_iteration_s=prof["span_s"],
                     window_iteration_s=out["window_s"] / out["iterations"])
    # last in the line: each number compared, with its limit
    result["compared"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                          for name, v, lim in rows}
    return result, notes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell: benchmark/workloads/<name>.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    import torch

    cell = manifest.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s), torch sees "
              f"{have}", file=sys.stderr)
        return 2
    result, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    result["compared"] = result.pop("compared")
    print(f"notes: {json.dumps(notes)}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
