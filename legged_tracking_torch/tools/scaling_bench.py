"""Data-parallel scaling of the port at fixed total envs (counterpart of
the repo's ``tools/scaling_bench.py``, which shards over a virtual CPU
mesh).

    python -m legged_tracking_torch.tools.scaling_bench --device cpu --devices 1 2 4
    python -m legged_tracking_torch.tools.scaling_bench --devices 1 2 4 \\
        --dist_backend nccl --total_envs 4096 --iters 2

The JAX tool's configuration (plane terrain, P control, ``xy`` commands)
at ``--total_envs`` global envs, trained by ``PPO.train_iteration`` in
each rank count of ``--devices``: the ranks are processes on this host
(``parallel.launch``), each owning ``total_envs / K`` envs, over gloo on
the CPU (the counterpart of the virtual mesh: the ranks share the host's
cores, so the ideal sharded time equals one rank's and any excess is the
cost of sharding and collectives) or over NCCL with one rank a card (the
ideal is one rank's time over K).  Each count runs 2 warm-up iterations,
then ``--iters`` timed ones between two synchronizes; a count's time is its
slowest rank's, as the ranks meet at every all-reduce.

Prints the JAX summary's keys (``total_envs``, ``iters``, ``ms_per_iter``,
``sharding_overhead`` against the first count, ``note``) as the last line,
and writes it to ``--out`` only when given.  It runs on the cards unless
``--device cpu`` is given; without the cards it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def scaling_cfg(total_envs: int):
    """The JAX tool's configuration: plane terrain, xy commands, P control."""
    from ..config import Cfg, config_go1

    cfg = config_go1(Cfg())
    cfg.env.num_envs = total_envs
    cfg.terrain.mesh_type = "plane"
    cfg.env.command_type = "xy"
    cfg.control.control_type = "P"
    return cfg


def rank_run(outdir: str, total_envs: int, steps_per_env: int, iters: int, device: str):
    """One rank of a count: its seconds an iteration, written to
    ``outdir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from ..envs import LeggedEnv
    from ..learn.ppo import PPO, PPOArgs
    from ..parallel import Shard, check_replicated, rank_device

    dev = rank_device(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    env = LeggedEnv(scaling_cfg(total_envs), device=dev, shard=Shard(rank, world, total_envs))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        alg = PPO(env, args=PPOArgs(num_steps_per_env=steps_per_env), seed=0)
    if world > 1:
        check_replicated(alg.ac.state_dict())
    ts = alg.init()
    state = env.reset_fn(False)
    obs = env.observe(state)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for _ in range(2):
        ts, state, obs, m = alg.train_iteration(ts, state, obs)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, state, obs, m = alg.train_iteration(ts, state, obs)
    sync()
    dt = (time.perf_counter() - t0) / iters
    if not bool(m["value_loss"].isfinite()):
        raise RuntimeError(f"scaling_bench: rank {rank} of {world}: non-finite value loss")
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "device": str(dev), "backend": dist.get_backend(),
                   "local_envs": env.num_envs, "s_per_iter": dt}, f)


def run_count(k: int, args) -> dict:
    """``k`` ranks of :func:`rank_run`; their slowest seconds an iteration,
    and what each rank reported."""
    from ..parallel import launch
    from . import scaling_bench     # rank_run by its module's name, also under -m

    with tempfile.TemporaryDirectory(prefix="scaling_bench_") as out:
        launch(scaling_bench.rank_run, k, out, args.total_envs, args.steps_per_env, args.iters, args.device,
               backend=args.dist_backend, device=args.device)
        ranks = []
        for r in range(k):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return {"s_per_iter": max(r["s_per_iter"] for r in ranks), "ranks": ranks}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--total_envs", type=int, default=512)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--steps_per_env", type=int, default=24)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="the rank counts to run")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: a card a rank under NCCL) or cpu")
    p.add_argument("--dist_backend", default=None,
                   help="nccl or gloo (default: nccl on cuda, gloo on the CPU)")
    p.add_argument("--out", default=None, help="also write the summary here")
    args = p.parse_args(argv)
    if min(args.devices) < 1 or args.iters < 1:
        p.error("--devices and --iters take counts >= 1")

    results = {}
    for n in args.devices:
        results[n] = run_count(n, args)
        print(f"n_devices={n}: {results[n]['s_per_iter'] * 1e3:.1f} ms/iter "
              f"({args.total_envs} envs total)", file=sys.stderr)
    backend = results[args.devices[0]]["ranks"][0]["backend"]
    t1 = results[args.devices[0]]["s_per_iter"]
    summary = {
        "total_envs": args.total_envs,
        "iters": args.iters,
        "ms_per_iter": {str(n): r["s_per_iter"] * 1e3 for n, r in results.items()},
        # fixed total work: the excess time over the first count
        "sharding_overhead": {str(n): r["s_per_iter"] / t1 - 1.0 for n, r in results.items()},
        "note": (f"{backend} ranks on {args.device}: " + (
            "the ranks share the host's cores, so the ideal sharded time is one rank's "
            "at fixed total work; overhead > 0 is the cost of sharding and collectives"
            if args.device == "cpu" else
            "one rank a card, so the ideal time is one rank's over the ranks at fixed "
            "total work; overhead -1 + 1/K is perfect strong scaling")),
        "ranks": {str(n): r["ranks"] for n, r in results.items()},
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
