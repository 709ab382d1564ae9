"""What the host did during the measured window, for the notes on
standard error.  The train rate is set by the host (the device idles most
of an iteration), so these say where a run's rate came from: the share of
the window this process spent on a core, and :func:`speed`, the host's own
work timed before and after the window, so that a run's rate can be set
beside the speed of the core it ran on."""

from __future__ import annotations

import os
import time

import torch


def sample() -> dict:
    t = os.times()
    return {"wall": time.perf_counter(), "process": t.user + t.system}


def delta(a: dict, b: dict) -> dict:
    """Between samples ``a`` and ``b``: the wall seconds, the process's CPU
    seconds over them, and the cores it may run on."""
    wall = b["wall"] - a["wall"]
    return {"wall_s": wall, "process_cpu_share": (b["process"] - a["process"]) / wall,
            "cores": len(os.sched_getaffinity(0))}


def speed(device, launches: int = 2000, rounds: int = 5) -> dict:
    """The host's speed at this moment, the least of ``rounds`` timings
    each: a fixed pure-Python loop (``python_loop_ms``), and the
    microseconds a launch of one tiny kernel takes the host, the device
    synchronized at the end (``launch_us``)."""
    def loop():
        t = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i * i
        return (time.perf_counter() - t) * 1e3

    out = {"python_loop_ms": min(loop() for _ in range(rounds))}
    if device.type == "cuda":
        x = torch.zeros(1, device=device)
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            for _ in range(launches):
                x.add_(1.0)
            torch.cuda.synchronize(device)
            best = min(best, (time.perf_counter() - t) / launches * 1e6)
        out["launch_us"] = best
    return out
