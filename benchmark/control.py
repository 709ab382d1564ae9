"""Readings that set the limits of the check (``compare.py``): the
program's and the control's gaps to the reference, and the planted
faults', at a cell's own size, for several seeds in one process (no
measured window: the training readings need none).

    python -m benchmark.control --workload tunnel-train-4096 --seeds 1 2 3 \\
        --variants program tf32 half_batch reward obs

Variants: ``program`` (the port, as a run builds and drives it through its
first train iteration), ``tf32`` (the control: the reference put in the
program's place, one precision lower), and any of
:data:`benchmark.faults.KINDS` planted in the program.  Prints one JSON
line a reading and, last, all of them; ``--out FILE`` writes them too.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from benchmark import build, compare, manifest
from benchmark.reference import train as reference


def program_readings(cell, seed, device, overrides=None, fault=None):
    """The program's readings of its first train iteration, with ``fault``
    planted in it."""
    import contextlib

    from benchmark import faults, program

    planted = (faults.plant(fault, *program.fault_targets()) if fault
               else contextlib.nullcontext())
    with planted:
        train = build.build(program.modules(), cell.config, cell.num_envs, seed, device,
                            overrides=overrides, ppo_overrides=cell.traffic.get("ppo"))
        _, got = build.first_steps(train, 1, compare.UPDATE_STEPS)
    return got


def readings(cell, seed, variant, device, overrides=None):
    """The readings of ``variant`` in the program's place."""
    if variant == "tf32":
        return reference.drive(cell.config, cell.num_envs, seed, device, overrides=overrides,
                               ppo_overrides=cell.traffic.get("ppo"), tf32=True)
    return program_readings(cell, seed, device, overrides,
                            None if variant == "program" else variant)


def check(cell, seed, got, device, overrides=None):
    """The reference following ``got``, and the gaps (with both sides'
    learning rates after each iteration)."""
    ref = reference.follow(cell.config, cell.num_envs, seed, device, got, overrides=overrides,
                           ppo_overrides=cell.traffic.get("ppo"))
    return {**compare.gaps(got, ref), "loss_prog": got["loss"]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["program", "tf32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    device = torch.device(args.device)
    rows = []
    for seed in args.seeds:
        for variant in args.variants:
            t = time.perf_counter()
            got = readings(cell, seed, variant, device)
            t_ref = time.perf_counter()
            g = check(cell, seed, got, device)
            row = {"cell": cell.name, "seed": seed, "variant": variant,
                   "seconds": t_ref - t, "reference_s": time.perf_counter() - t_ref,
                   **g}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del got
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
