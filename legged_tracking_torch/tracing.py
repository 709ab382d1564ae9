"""Spans and sync counters at the layer boundaries of the train step,
recorded while ``torch.profiler`` records and at no other time.

    with tracing.span("env.physics"):
        ...

While the profiler is off, :func:`span` checks the profiler's flag and
returns one shared no-op context manager.  It reads no clock, allocates
nothing and never touches CUDA.

While the profiler records, a span keeps (:class:`Span`) its name, its start
and end on ``time.time_ns()``'s clock, which is the clock of the profiler's
events (a span can be laid on the device's timeline), the index of its
parent, and ``syncs``: the synchronizing CUDA operations counted while it
was the innermost open span of its thread, each with the ``file:line`` that
called it.  For that an outermost span turns on
``torch.cuda.set_sync_debug_mode("warn")`` (where CUDA is initialized) and
takes the sync warnings, and only those, out of the warnings machinery;
closing it restores the previous mode, filters and display.

Spans are kept in memory.  :func:`record` is the newest profiler session's
spans, in the order they opened: the first span that opens with the
profiler on, after spans that found it off, starts a new record.  No
``record_function`` range is emitted: a reader of the trace would count a
range's device-side annotation as device work.

Readers: the benchmark's per-layer metrics read the record of the
iteration it profiles; ``Runner.learn(profile_dir=...)`` writes the record
into its ``trace.json`` (:func:`add_to_chrome_trace`), which
``tools/analyze_trace`` files launches, syncs and idle gaps under.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import warnings
from time import time_ns

import torch
import torch.autograd.profiler as _profiler

SYNC_WARNING = "called a synchronizing CUDA operation"
CATEGORY = "program_span"


class Span:
    """One recorded span (the module docstring).  ``parent`` is the index
    in the record of the span it opened inside, -1 for an outermost one;
    ``tid`` its thread's native id; ``sites`` {``file:line``: syncs};
    ``counters`` what the code inside added (:meth:`add`)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "tid", "syncs", "sites", "counters",
                 "index")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = 0
        self.parent = -1
        self.tid = self.index = 0
        self.syncs = 0
        self.sites = {}
        self.counters = {}

    def add(self, counter: str, n: int):
        """Add ``n`` to the span's ``counter``, such as a collective's bytes."""
        self.counters[counter] = self.counters.get(counter, 0) + n

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        if stack:
            self.parent = stack[-1].index
        else:
            _count_syncs(True)
        self.tid = threading.get_native_id()
        record = _session.record
        self.index = len(record)
        record.append(self)
        stack.append(self)
        self.start_ns = time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time_ns()
        stack = _local.stack
        stack.pop()
        if not stack:
            _count_syncs(False)
        return False


class _Off:
    """The span of a layer while the profiler is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, counter: str, n: int):
        pass


_OFF = _Off()


class _Session:
    """The newest record, whether the last span found the profiler on,
    and the sync counting's saved state."""

    def __init__(self):
        self.record = []
        self.on = False
        self.lock = threading.Lock()
        self.open = 0               # outermost spans open, over all threads
        self.saved = None           # [catch_warnings, showwarning, sync debug mode]


_session = _Session()
_local = threading.local()


def span(name: str):
    """A context manager around one layer's lines: a :class:`Span` while
    the profiler records, else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        _session.on = False
        return _OFF
    if not _session.on:
        _session.on = True
        _session.record = []
    return Span(name)


def spanned(name: str):
    """A decorator: the whole call of the function as the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def record() -> list:
    """The spans of the newest profiler session (the module docstring)."""
    return _session.record


def _show(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while spans are open: a sync warning counts
    on the innermost open span of its thread; any other warning goes to the
    display in place before."""
    if SYNC_WARNING not in str(message):
        _session.saved[1](message, category, filename, lineno, file, line)
        return
    stack = _local.__dict__.get("stack")
    if stack:
        s = stack[-1]
        s.syncs += 1
        site = f"{filename}:{lineno}"
        s.sites[site] = s.sites.get(site, 0) + 1


def _count_syncs(on: bool):
    """Start counting syncs at the first outermost span to open, on any
    thread; stop and restore at the last one to close."""
    with _session.lock:
        _session.open += 1 if on else -1
        if on and _session.open == 1:
            caught = warnings.catch_warnings()
            caught.__enter__()
            # saved before the hook goes in: setting the mode warns once
            _session.saved = [caught, warnings.showwarning, None]
            warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
            warnings.showwarning = _show
            if torch.cuda.is_initialized():
                _session.saved[2] = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
        elif not on and _session.open == 0:
            caught, _, mode = _session.saved
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)
            _session.saved = None


def add_to_chrome_trace(path: str) -> int:
    """Add the record to the Chrome trace that ``torch.profiler`` exported
    at ``path``: each span a complete event of category ``program_span``,
    with its ``syncs``, ``sync_sites`` and counters as arguments, on the
    trace's own time base (microseconds from its ``baseTimeNanoseconds``, 0
    where it has none).  Spans still open are left out.  Returns the count
    added."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = int(doc.get("baseTimeNanoseconds", 0)), os.getpid()
    events = [{"ph": "X", "cat": CATEGORY, "name": s.name, "pid": pid, "tid": s.tid,
               "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"syncs": s.syncs, "sync_sites": s.sites, **s.counters}}
              for s in record() if s.end_ns]
    doc["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)
