"""Profile the bench workload of the port: a stack-carrying trace, and its
ops, kernel launches and host-device syncs by source line (counterpart of
the repo's ``tools/profile_bench.py``).

    python -m legged_tracking_torch.tools.profile_bench --trace DIR   # 3 iterations traced
    python -m legged_tracking_torch.tools.profile_bench --ops         # one iteration's ops
    python -m legged_tracking_torch.tools.analyze_trace DIR --iters 3

Builds the bench through ``legged_tracking_torch.bench.build`` (its
``BENCH_*`` variables apply).  ``--trace DIR`` runs 2 warm-up
``train_iteration``s, then ``--iters`` under ``torch.profiler`` (CPU and
CUDA activities, ``with_stack=True``), prints their seconds and writes the
Chrome trace to ``DIR/trace.json``, which ``analyze_trace`` and
``roofline --from-trace`` read.  ``--ops`` takes the place of the JAX
tool's ``--hlo``, which has no eager counterpart: it tallies the aten ops
(the outermost, as the Python code calls them), the kernel launches
(``cudaLaunchKernel`` / ``cuLaunchKernel``) and the host-device syncs
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``, a device-to-host
``cudaMemcpyAsync``) of the traced iterations, or of one iteration under
the profiler after a warm-up one (no timing claim), each filed under its
source line in the port as ``analyze_trace`` files them, and prints the top
lines per env step.

The trace the profiler exports names each Python frame by the line of its
``def``.  Before writing it, the tool turns every Python call out of a port
frame into that frame at the line the call was made from (the profiler's
event tree holds it) and drops the other Python frames outside the port, so
that ``analyze_trace`` reads source lines and the file stays smaller.  A
trace of one bench iteration at 4096 envs still holds about 10^5 kernels
and their ops: hundreds of MB.

It runs on the card unless ``--device cpu`` is given; on ``cuda`` with no
card it raises.  The last line printed is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time

from . import analyze_trace as at

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def caller_lines(prof) -> dict:
    """{(event name, start ns): ``file(line): function``} for each Python
    call the profiler recorded from a frame of the port to a function
    outside it: the calling frame at the line of the call."""
    from torch._C._profiler import _EventType

    out, stack = {}, list(prof.profiler.kineto_results.experimental_event_tree())
    while stack:
        e = stack.pop()
        stack.extend(e.children)
        if e.tag not in (_EventType.PyCall, _EventType.PyCCall) or at.port_frame(e.name):
            continue
        c = e.extra_fields.caller
        if at.PORT in c.file_name:
            out[(e.name, e.start_time_ns)] = f"{c.file_name}({c.line_number}): {c.function_name}"
    return out


def write_trace(prof, path: str) -> tuple[dict, list]:
    """The profile's Chrome trace at ``path``, its Python frames as the
    module docstring says; returns how many Python events were kept, moved
    to a calling line and dropped, and the trace's events."""
    lines = caller_lines(prof)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    kept, moved, dropped, events = 0, 0, 0, []
    for e in trace["traceEvents"]:
        if e.get("cat") == "python_function":
            if not at.port_frame(e["name"]):
                line = lines.get((e["name"], round(e["ts"] * 1000) + base))
                if line is None:
                    dropped += 1
                    continue
                e["name"] = line
                moved += 1
            else:
                kept += 1
        events.append(e)
    trace["traceEvents"] = events
    # one dumps: json.dump encodes in Python, several times slower
    with open(path, "w") as f:
        f.write(json.dumps(trace))
    return {"port_frames": kept, "calls_out_of_port": moved, "calls_matched": len(lines),
            "dropped": dropped, "bytes": os.path.getsize(path)}, events


def profiled(fn, dev):
    """``fn()`` under ``torch.profiler`` with Python stacks, the device
    synchronized before the profile ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts, with_stack=True) as prof:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return prof


def ops_tally(events, steps: int) -> dict:
    """Aten ops, launches and syncs of ``events`` by source line, per env
    step (``steps``: the env steps the events span), with the totals."""
    tags = at.attribute(events)
    memcpy = {d["args"].get("correlation"): d["name"] for d in at.device_events(events)
              if d.get("cat") == "gpu_memcpy"}
    counts = {k: collections.Counter() for k in ("aten_ops", "launches", "syncs")}
    kinds = collections.Counter()
    open_ops = {}                   # thread -> end of its open outermost op
    for e in sorted(at._complete(events), key=lambda e: e["ts"]):
        tag, name, cat = tags.get(id(e)), e["name"], e.get("cat")
        if cat == "cpu_op" and name.startswith("aten::"):
            thread = (e["pid"], e["tid"])
            if open_ops.get(thread, float("-inf")) < e["ts"]:
                counts["aten_ops"][tag] += 1
                open_ops[thread] = e["ts"] + e.get("dur", 0)
        elif cat in at.RUNTIME_CATS:
            if name in LAUNCHES:
                counts["launches"][tag] += 1
            elif name in SYNCS or (name == "cudaMemcpyAsync" and "DtoH" in memcpy.get(
                    e.get("args", {}).get("correlation"), "")):
                counts["syncs"][tag] += 1
                kinds[name] += 1
    per = lambda c: [[t, n / steps] for t, n in c.most_common()]
    return {"steps": steps,
            "per_step": {k: sum(c.values()) / steps for k, c in counts.items()},
            "sync_kinds_per_step": {k: n / steps for k, n in kinds.items()},
            **{f"by_line_{k}": per(c) for k, c in counts.items()}}


def print_ops(ops: dict, top: int):
    print(f"\nper env step ({ops['steps']} env steps): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ops["per_step"].items())
          + f"; syncs by call {ops['sync_kinds_per_step']}")
    for k in ("aten_ops", "launches", "syncs"):
        print(f"\ntop {top} source lines by {k} per env step:")
        for tag, n in ops[f"by_line_{k}"][:top]:
            print(f"  {n:9.2f}  {tag}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None, help="write the Chrome trace into this directory")
    ap.add_argument("--iters", type=int, default=3, help="train iterations traced")
    ap.add_argument("--ops", action="store_true",
                    help="tally aten ops, launches and syncs by source line")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    # validate before the build, which takes the card for a minute
    if not args.ops and not args.trace:
        ap.error("pass --ops and/or --trace DIR")
    if args.trace and args.iters < 1:
        ap.error("--trace needs --iters >= 1")

    from .. import bench

    env, alg, ts, state, obs = bench.build(device=args.device)
    dev = env.device
    T = alg.args.num_steps_per_env
    out = {"device": str(dev), "card": bench.device_line(dev), "envs": env.num_envs}
    carry = [ts, state, obs]

    def iterations(n):
        for _ in range(n):
            carry[0], carry[1], carry[2], _ = alg.train_iteration(*carry)

    iters = args.iters if args.trace else 1
    iterations(2 if args.trace else 1)
    bench.synchronize(dev)
    t0 = time.perf_counter()
    prof = profiled(lambda: iterations(iters), dev)
    seconds = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="profile_bench_") as tmp:
        path = os.path.join(args.trace, "trace.json") if args.trace else os.path.join(tmp, "t.json")
        if args.trace:
            os.makedirs(args.trace, exist_ok=True)
        stats, events = write_trace(prof, path)
        del prof
        if args.trace:
            print(f"{iters} iters in {seconds:.3f}s (under the profiler)")
            print(f"trace written to {path}: {stats}")
            out.update({"trace": path, "iters": iters, "seconds": seconds, "trace_stats": stats})
        if args.ops:
            out["ops"] = ops_tally(events, iters * T)
            print_ops(out["ops"], args.top)
            out["ops"] = {k: (v[:args.top] if k.startswith("by_line") else v)
                          for k, v in out["ops"].items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
