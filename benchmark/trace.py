"""The traced run's instruments, all kept in memory: spans around the
program's layers, timed from the benchmark's own files, and one train
iteration under ``torch.profiler`` (CPU and CUDA activities, no stacks),
reduced to counts, device intervals and kernel times.

The reduction copies the arithmetic of the port's ``tools/analyze_trace``:
the device's busy time is the union of its events' intervals, and launches
and synchronizations are runtime calls counted by name.
"""

from __future__ import annotations

import contextlib
import re
import time

import torch

LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
ITERATION, ROLLOUT, UPDATE = "bench.iteration", "bench.rollout", "bench.update"
RANGES = (ITERATION, ROLLOUT, UPDATE)
# host events of the profiler itself, no label for what the program does
PROFILER_OWN = ("Activity Buffer Request",)
B1_KERNEL = "scan_heights_kernel"
TOP = 10


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def spans(alg, device: torch.device, into: dict):
    """Time every ``PPO.rollout`` and ``PPO.update`` of ``alg`` on the host
    clock, the device synchronized at both ends, into ``into["rollout"]``
    and ``into["update"]`` (seconds), by wrapping the instance's methods."""
    def timed(name):
        method = getattr(alg, name)
        into.setdefault(name, [])

        def call(*args, **kwargs):
            synchronize(device)
            t = time.perf_counter()
            out = method(*args, **kwargs)
            synchronize(device)
            into[name].append(time.perf_counter() - t)
            return out
        return call

    alg.rollout, alg.update = timed("rollout"), timed("update")
    try:
        yield
    finally:
        del alg.rollout, alg.update


@contextlib.contextmanager
def ranges(alg):
    """Profiler ranges around ``PPO.rollout`` and ``PPO.update``."""
    def ranged(name, method):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return method(*args, **kwargs)
        return call

    alg.rollout = ranged(ROLLOUT, alg.rollout)
    alg.update = ranged(UPDATE, alg.update)
    try:
        yield
    finally:
        del alg.rollout, alg.update


def profile(fn, device: torch.device) -> dict:
    """Run ``fn()`` once under the profiler inside a ``bench.iteration``
    range, the device synchronized before it ends, and reduce the events
    (:func:`reduce`)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    synchronize(device)
    with torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False,
                                profile_memory=False) as prof:
        with torch.profiler.record_function(ITERATION):
            fn()
            synchronize(device)
    return reduce(prof.profiler.kineto_results.events())


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events) -> dict:
    """Counts and times of one profiled iteration, in seconds:

    - ``span_s``: the ``bench.iteration`` range; ``busy_s``: the union of the
      device's intervals inside it;
    - ``launches``, ``syncs``: runtime calls (``cudaLaunchKernel*``,
      ``cuLaunchKernel*``; ``cudaStreamSynchronize``,
      ``cudaDeviceSynchronize``) that start inside the ``bench.rollout``
      range, and ``rollouts``, the ranges seen;
    - ``kernels``: {device op name: [seconds, count]};
    - ``idle_gaps``: the longest stretches inside the span with nothing on
      the device, each labelled with the innermost host event in flight at
      its middle."""
    host, device, named = [], [], {}
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device side of a host range (a user annotation) is no work
            if name not in RANGES:
                device.append((a, b, name))
        elif name not in PROFILER_OWN:
            host.append((a, b, name))
            if name in RANGES:
                named.setdefault(name, []).append((a, b))
    if ITERATION not in named:
        raise RuntimeError("the profiled iteration's range is missing from the trace")
    lo, hi = named[ITERATION][0]
    rollout = named.get(ROLLOUT, [])
    inside = lambda t: any(a <= t <= b for a, b in rollout)
    launches = sum(1 for a, _, n in host if LAUNCH.match(n) and inside(a))
    syncs = sum(1 for a, _, n in host if n in SYNCS and inside(a))
    kernels = {}
    for a, b, n in device:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (b - a) * 1e-9
        k[1] += 1
    busy = _merge((max(a, lo), min(b, hi)) for a, b, _ in device if b > lo and a < hi)
    busy_ns = sum(b - a for a, b in busy)
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, reverse=True)[:TOP]

    def label(t):
        best = None
        for a, b, n in host:
            if a <= t <= b and n != ITERATION and (best is None or b - a < best[0]):
                best = (b - a, n)
        return best[1] if best else ITERATION

    return {"span_s": (hi - lo) * 1e-9, "busy_s": busy_ns * 1e-9, "launches": launches,
            "syncs": syncs, "rollouts": len(rollout), "kernels": kernels,
            "idle_gaps": [[label((a + b) // 2), d * 1e-9] for d, a, b in gaps]}


def top_ops(kernels: dict) -> list:
    """The device ops that took most time: [[name, seconds], ...], each
    name cut to its first 160 characters (a template's arguments run to
    hundreds)."""
    return [[n[:160], s] for n, (s, _) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]]
