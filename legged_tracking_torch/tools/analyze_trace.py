"""Device time of a ``torch.profiler`` trace by source line of the port
(counterpart of the repo's ``tools/analyze_trace.py``, which joins a
``jax.profiler`` trace with an HLO dump).

    python -m legged_tracking_torch.tools.profile_bench --trace DIR --iters 3
    python -m legged_tracking_torch.tools.analyze_trace DIR [--iters 3] [--top 35]

The device's events (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) are
joined, by their correlation id, to the runtime call that launched them
(``cuda_runtime`` / ``cuda_driver``), and each runtime call is filed under
the innermost ``python_function`` event of the port
(``legged_tracking_torch/``) that encloses it in time on its thread, as
``file.py:line`` with the file's path inside the package.  That covers
launches from aten ops and from ctypes (kernel B1) alike.  A backward op,
which the autograd engine runs on a thread of its own, is filed where its
forward op was (the op with its sequence number), as the JAX tool files a
transpose under its forward op's source line.  Device time that no line of
the port claims is ``<unattributed>``.

A frame's line is the line it is at when it calls out of the port, where
``profile_bench`` has written it into the trace; otherwise (an operator
such as ``a * b`` runs no Python call, or a trace from elsewhere) it is the
line of the function's ``def``.

The program's spans (``tracing.py``; category ``program_span``, which
``Runner.learn(profile_dir=...)`` writes into its trace) need no stacks:
device time, kernels, launches (``cudaLaunchKernel*``, ``cuLaunchKernel*``)
and syncs (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``) are filed
under the innermost span in flight when the runtime call was made (a CUDA
graph's kernels under its ``cudaGraphLaunch``, which is no launch here), and each of the
longest stretches with nothing on the device under the innermost span in
flight at its middle; ``<no span>`` where none is.  The tracer's own sync
counts ride on the spans (``syncs``, and ``sync_sites`` by ``file:line``):
the table gives them beside the trace's, and the sites are listed.  Every
other argument of a span is a counter the code inside added (a
collective's ``bytes``; the physics step's ``graph``, a replay of its CUDA
graph, and ``captures``; the policy's ``frames``, ``steps`` and
``rows``): the table sums each under its name, 0 for a span without it.

Prints device ms per iteration by file and by line (``--iters``: the
iterations the trace holds), the kernels by name, the device's busy time
and idle share over the traced window, and, where the trace has spans, the
table by span and the longest idle gaps; the last line is one JSON object
with the same numbers.  Reads a file; runs nothing on a device.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import gzip
import json
import os
import re

PORT = "legged_tracking_torch/"
UNATTRIBUTED = "<unattributed>"
NO_SPAN = "<no span>"
SPAN_CAT = "program_span"
# a span's arguments that are no counter
SPAN_OWN = ("syncs", "sync_sites")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
GAPS = 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_FRAME = re.compile(r"(.*)\((\d+)\): (.*)")


def trace_path(trace: str) -> str:
    """``trace`` itself, or the newest ``*.json`` / ``*.json.gz`` in that
    directory."""
    if os.path.isfile(trace):
        return trace
    paths = glob.glob(os.path.join(trace, "*.json")) + glob.glob(os.path.join(trace, "*.json.gz"))
    if not paths:
        raise SystemExit(f"no *.json or *.json.gz trace in {trace}")
    return max(paths, key=os.path.getmtime)


def load_trace_events(trace: str) -> list:
    """The ``traceEvents`` of the trace at :func:`trace_path`."""
    path = trace_path(trace)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return json.load(f)["traceEvents"]


def port_frame(name: str) -> str | None:
    """``file.py:line`` inside the package of a ``python_function`` event's
    name (``.../legged_tracking_torch/envs/step.py(12): fn``), or None for a
    frame outside the port."""
    m = _FRAME.match(name)
    if m is None:
        return None
    i = m.group(1).rfind(PORT)
    return None if i < 0 else f"{m.group(1)[i + len(PORT):]}:{m.group(2)}"


def _complete(events):
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def attribute(events) -> dict:
    """{id(event): ``file.py:line`` or ``<unattributed>``} for every
    ``cpu_op`` and runtime-call event (the rules of the module docstring)."""
    by_thread = collections.defaultdict(list)
    for e in _complete(events):
        cat = e.get("cat")
        if cat == "python_function":
            tag = port_frame(e["name"])
            if tag is None:
                continue
            by_thread[(e["pid"], e["tid"])].append((e["ts"], -e.get("dur", 0), 0, e, tag))
        elif cat == "cpu_op" or cat in RUNTIME_CATS:
            by_thread[(e["pid"], e["tid"])].append((e["ts"], -e.get("dur", 0), 1, e, None))
    tags, backward, forward = {}, {}, {}
    for items in by_thread.values():
        items.sort(key=lambda x: x[:3])
        frames, ops = [], []          # open (end, tag) and (end, event), outermost first
        for ts, neg_dur, kind, e, tag in items:
            while frames and frames[-1][0] < ts:
                frames.pop()
            while ops and ops[-1][0] < ts:
                ops.pop()
            if kind == 0:
                frames.append((ts - neg_dur, tag))
                continue
            here = frames[-1][1] if frames else UNATTRIBUTED
            args = e.get("args", {})
            seq = args.get("Sequence number")
            if e.get("cat") == "cpu_op":
                ops.append((ts - neg_dur, e))
                # the op that made the node with sequence number s is the
                # last one recorded with s (the counter moves on past it)
                if seq is not None and not args.get("Fwd thread id"):
                    forward[seq] = here
            # the innermost enclosing backward node (its own event included)
            node = next((o for _, o in reversed(ops)
                         if o.get("args", {}).get("Fwd thread id")), None)
            if node is not None:
                backward[id(e)] = node["args"]["Sequence number"]
            tags[id(e)] = here
    for key, seq in backward.items():
        tags[key] = forward.get(seq, UNATTRIBUTED)
    return tags


def device_events(events) -> list:
    return [e for e in _complete(events) if e.get("cat") in DEVICE_CATS]


def runtime_by_correlation(events) -> dict:
    return {e["args"]["correlation"]: e for e in _complete(events)
            if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}


def device_time_by_line(events, tags=None) -> collections.Counter:
    """{``file.py:line``: device us} over the trace."""
    tags = attribute(events) if tags is None else tags
    runtime = runtime_by_correlation(events)
    by_line = collections.Counter()
    for d in device_events(events):
        call = runtime.get(d.get("args", {}).get("correlation"))
        by_line[tags.get(id(call), UNATTRIBUTED) if call is not None else UNATTRIBUTED] += d["dur"]
    return by_line


def by_file(by_line) -> collections.Counter:
    out = collections.Counter()
    for tag, d in by_line.items():
        out[tag.rsplit(":", 1)[0]] += d
    return out


def device_busy(events) -> dict:
    """The device's busy time (the union of its events' intervals), the
    traced window (the first event's start to the last one's end, host and
    device) and the idle share of that window, in us."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events(events))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    xs = _complete(events)
    window = (max(e["ts"] + e.get("dur", 0) for e in xs) - min(e["ts"] for e in xs)) if xs else 0.0
    return {"busy_us": busy, "window_us": window,
            "idle_share": 1.0 - busy / window if window else None}


def kernels_by_name(events) -> dict:
    """{device event name: (us, count)}."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for d in device_events(events):
        out[d["name"]][0] += d["dur"]
        out[d["name"]][1] += 1
    return dict(out)


def kernel_files(events, tags=None) -> dict:
    """{device event name: {file: us}}: where each kernel is launched from."""
    tags = attribute(events) if tags is None else tags
    runtime = runtime_by_correlation(events)
    out = collections.defaultdict(collections.Counter)
    for d in device_events(events):
        call = runtime.get(d.get("args", {}).get("correlation"))
        tag = tags.get(id(call), UNATTRIBUTED) if call is not None else UNATTRIBUTED
        out[d["name"]][tag.rsplit(":", 1)[0]] += d["dur"]
    return out


def span_labels(spans):
    """t -> the name of the innermost (shortest) of ``spans`` in flight at
    host time t, or :data:`NO_SPAN`."""
    points = sorted({e["ts"] for e in spans} | {e["ts"] + e["dur"] for e in spans})
    labels = [(float("inf"), NO_SPAN)] * len(points)
    for e in spans:
        for i in range(bisect.bisect_left(points, e["ts"]),
                       bisect.bisect_left(points, e["ts"] + e["dur"])):
            labels[i] = min(labels[i], (e["dur"], e["name"]))

    def label(t):
        i = bisect.bisect_right(points, t) - 1
        return labels[i][1] if i >= 0 else NO_SPAN
    return label


def idle_gaps(events, top: int = GAPS) -> list:
    """The ``top`` longest stretches of the traced window (as
    :func:`device_busy`'s) with nothing on the device: [(us, start, end)]."""
    xs = _complete(events)
    if not xs:
        return []
    lo, hi = min(e["ts"] for e in xs), max(e["ts"] + e.get("dur", 0) for e in xs)
    gaps, prev = [], lo
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events(events)) + [(hi, hi)]:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    return sorted(gaps, reverse=True)[:top]


def span_counters(events) -> list:
    """The names of the counters the trace's spans carry, sorted."""
    return sorted({k for e in _complete(events) if e.get("cat") == SPAN_CAT
                   for k in e.get("args", {}) if k not in SPAN_OWN})


def by_span(events) -> tuple[dict, list, collections.Counter]:
    """The table by span, {name: {spans, host_us, device_us, kernels,
    launches, syncs, tracer_syncs, and each of :func:`span_counters`}}
    (``<no span>`` for what no span encloses; a counter summed over the
    name's spans), the longest idle gaps [(name, us)], each by the
    innermost span in flight (the module docstring), and the tracer's sync
    sites {(span, site): syncs}, a site's path cut to the package's; ({},
    [], {}) for a trace with no spans."""
    spans = [e for e in _complete(events) if e.get("cat") == SPAN_CAT]
    if not spans:
        return {}, [], collections.Counter()
    label = span_labels(spans)
    counters = span_counters(spans)
    zero = lambda: {"spans": 0, "host_us": 0.0, "device_us": 0.0, "kernels": 0, "launches": 0,
                    "syncs": 0, "tracer_syncs": 0, **dict.fromkeys(counters, 0)}
    table = collections.defaultdict(zero)
    sites = collections.Counter()
    for e in spans:
        row, args = table[e["name"]], e.get("args", {})
        row["spans"] += 1
        row["host_us"] += e["dur"]
        row["tracer_syncs"] += args.get("syncs", 0)
        for counter in counters:
            row[counter] += args.get(counter, 0)
        for site, n in args.get("sync_sites", {}).items():
            i = site.rfind(PORT)
            sites[(e["name"], site if i < 0 else site[i + len(PORT):])] += n
    for e in _complete(events):
        if e.get("cat") in RUNTIME_CATS:
            if LAUNCH.match(e["name"]):
                table[label(e["ts"])]["launches"] += 1
            elif e["name"] in SYNCS:
                table[label(e["ts"])]["syncs"] += 1
    runtime = runtime_by_correlation(events)
    for d in device_events(events):
        call = runtime.get(d.get("args", {}).get("correlation"))
        row = table[label(call["ts"]) if call is not None else NO_SPAN]
        row["device_us"] += d["dur"]
        row["kernels"] += d.get("cat") == "kernel"
    gaps = [(label((a + b) / 2), us) for us, a, b in idle_gaps(events)]
    return dict(table), gaps, sites


def summarize(events, iters: int, top: int = 35) -> dict:
    """The numbers :func:`main` prints, per iteration where they are times."""
    tags = attribute(events)
    lines = device_time_by_line(events, tags)
    files = by_file(lines)
    busy = device_busy(events)
    total = sum(lines.values())
    kernels = sorted(kernels_by_name(events).items(), key=lambda kv: -kv[1][0])
    spans, gaps, sites = by_span(events)
    counters = span_counters(events)
    ms = lambda us: us / iters / 1e3
    return {"iters": iters, "device_ms_per_iter": ms(total),
            "busy_ms_per_iter": ms(busy["busy_us"]), "window_ms_per_iter": ms(busy["window_us"]),
            "idle_share": busy["idle_share"],
            "port_share": 1.0 - lines.get(UNATTRIBUTED, 0) / total if total else None,
            "by_file": [[f, ms(d)] for f, d in files.most_common()],
            "by_line": [[t, ms(d)] for t, d in lines.most_common(top)],
            "kernels": [{"name": k, "ms_per_iter": ms(us), "count": n} for k, (us, n) in kernels[:top]],
            "kernel_files": {k: {f: ms(us) for f, us in files.most_common()}
                             for k, files in kernel_files(events, tags).items()},
            "by_span": [{"span": name, "spans": row["spans"] / iters,
                         "host_ms_per_iter": ms(row["host_us"]),
                         "device_ms_per_iter": ms(row["device_us"]),
                         "kernels": row["kernels"] / iters, "launches": row["launches"] / iters, "syncs": row["syncs"] / iters,
                         "tracer_syncs": row["tracer_syncs"] / iters,
                         **{c: row[c] / iters for c in counters}}
                        for name, row in sorted(spans.items(),
                                                key=lambda kv: -kv[1]["device_us"])],
            "span_counters": counters,
            "idle_gaps": [[name, us / 1e3] for name, us in gaps],
            "sync_sites": [[name, site, n / iters] for (name, site), n in sites.most_common(top)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a trace file, or the directory profile_bench --trace wrote")
    ap.add_argument("--iters", type=int, default=3,
                    help="iterations captured in the trace (for /iter numbers)")
    ap.add_argument("--top", type=int, default=35)
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be >= 1")

    s = summarize(load_trace_events(args.trace), args.iters, args.top)
    n = args.iters
    print(f"attributed device time: {s['device_ms_per_iter'] * n:.1f} ms "
          f"({s['device_ms_per_iter']:.1f} ms/iter at --iters {n})")
    print(f"device busy {s['busy_ms_per_iter']:.1f} of {s['window_ms_per_iter']:.1f} ms/iter "
          f"traced, idle share {s['idle_share']}")
    print("\nby file (ms/iter):")
    for tag, d in s["by_file"][:25]:
        print(f"  {d:8.2f}  {tag}")
    print(f"\ntop {args.top} source lines (ms/iter):")
    for tag, d in s["by_line"]:
        print(f"  {d:8.2f}  {tag}")
    print(f"\ntop {args.top} kernels (ms/iter, launches):")
    for k in s["kernels"]:
        print(f"  {k['ms_per_iter']:8.2f}  {k['count']:7d}  {k['name'][:100]}")
    if s["by_span"]:
        print("\nby span, per iter (spans, host ms, device ms, kernels, launches, syncs, the "
              f"tracer's syncs; counters: {', '.join(s['span_counters']) or 'none'}):")
        for r in s["by_span"]:
            print(f"  {r['spans']:7.1f}  {r['host_ms_per_iter']:9.2f}  "
                  f"{r['device_ms_per_iter']:9.2f}  {r['kernels']:9.1f}  {r['launches']:9.1f}  "
                  f"{r['syncs']:7.1f}  {r['tracer_syncs']:7.1f}  "
                  + "".join(f"{r[c]:11.1f}  " for c in s["span_counters"]) + r["span"])
        print(f"\nlongest {len(s['idle_gaps'])} idle gaps (ms, innermost span):")
        for name, ms in s["idle_gaps"]:
            print(f"  {ms:8.3f}  {name}")
        print(f"\ntop {args.top} sync sites, the tracer's (syncs/iter, innermost span, line):")
        for name, site, n in s["sync_sites"]:
            print(f"  {n:8.2f}  {name}  {site}")
    print(json.dumps(s))


if __name__ == "__main__":
    main()
