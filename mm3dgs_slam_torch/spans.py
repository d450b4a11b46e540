"""In-memory spans and counters at the port's layer boundaries.

    from mm3dgs_slam_torch import spans
    with spans.span("track.iter", i=i, rebin=True):
        ...
    spans.count("bins.pairs", n)

A span records its name, its start and end, its parent (the span open
around it), the frame index it belongs to (the `idx` of the enclosing span
named ``frame``: every span of one frame shares it) and its attributes,
plain ints and bools the host already holds. A span never reads a device
tensor and never synchronizes; `phase` spans end after the `sync` that
`enable` was given, which `debug.frame_decomp` sets to a card synchronize.

Off by default. While off, `span` and `phase` return one shared no-op
object and `count` returns at once: nothing is recorded and no object is
kept. `enable()` switches it on (the benchmark's traced runs,
`debug.frame_decomp`, `debug.jax_profiler_dir`), `disable()` off, `reset()`
clears what was recorded.

One clock with torch.profiler: spans are stamped with
`time.perf_counter_ns` and put on the Unix-epoch clock that the profiler's
events are stamped on (`time.time_ns`) by one anchor pair taken at
`enable`, so that a step of the wall clock cannot bend a span.

The tracer is one object per process, as a logger is: the spans sit deep in
the port's code, which passes no tracer around. Its spans nest on one stack:
they are opened by the thread that runs the frame loop, and by autograd's
device thread (the kernel launches of a backward on the card) while the
loop's thread waits for it inside a backward span. No other thread of the
port opens a span.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict

_perf_ns = time.perf_counter_ns


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "sync", "id", "parent", "start", "outer_frame")

    def __init__(self, tracer, name, attrs, sync):
        self.tracer, self.name, self.attrs, self.sync = tracer, name, attrs, sync

    def __enter__(self):
        t = self.tracer
        self.id = t._next_id
        t._next_id += 1
        self.parent = t._stack[-1] if t._stack else None
        t._stack.append(self.id)
        if self.name == "frame":
            self.outer_frame, t._frame = t._frame, self.attrs.get("idx")
        self.start = _perf_ns()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            self.sync()
        end = _perf_ns()
        t = self.tracer
        t._stack.pop()
        t._records.append((self.name, self.start, end, self.id, self.parent, t._frame,
                           self.attrs))
        if self.name == "frame":
            t._frame = self.outer_frame
        return False


class Tracer:
    """Spans and counters of one process; see the module's docstring."""

    def __init__(self):
        self.on = False
        self._sync = None
        self._offset = None   # time_ns - perf_counter_ns, from the anchor pair
        self.reset()

    def reset(self) -> None:
        """Forget every record and counter (between frames: no span open)."""
        self._records: list[tuple] = []
        self._counts: dict[str, int] = defaultdict(int)
        self._stack: list[int] = []
        self._next_id = 0
        self._frame = None
        self._offset = None
        if self.on:
            self._anchor()

    def _anchor(self) -> None:
        p0 = _perf_ns()
        wall = time.time_ns()
        p1 = _perf_ns()
        self._offset = wall - (p0 + p1) // 2

    def enable(self, sync=None) -> None:
        """Record from now on; `sync` (a callable, or None) runs before
        every phase span closes."""
        if self._offset is None:
            self._anchor()
        self._sync = sync
        self.on = True

    def disable(self) -> None:
        self.on = False
        self._sync = None

    def span(self, name: str, **attrs):
        if not self.on:
            return NOOP
        return _Span(self, name, attrs, None)

    def phase(self, name: str, **attrs):
        """A span that ends after `enable`'s `sync`: a row of the frame
        decomposition."""
        if not self.on:
            return NOOP
        return _Span(self, name, attrs, self._sync)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self._counts[name] += n

    def records(self) -> list[dict]:
        """The closed spans, in the order they closed: name, start_ns and
        end_ns on the profiler's clock, id, parent (an id or None), frame
        (an index or None) and attrs."""
        off = self._offset or 0
        return [dict(name=n, start_ns=s + off, end_ns=e + off, id=i, parent=p, frame=f,
                     attrs=dict(a)) for n, s, e, i, p, f, a in self._records]

    def counters(self) -> dict[str, int]:
        return dict(self._counts)


TRACER = Tracer()
span = TRACER.span
phase = TRACER.phase
count = TRACER.count
enable = TRACER.enable
disable = TRACER.disable
reset = TRACER.reset
records = TRACER.records
counters = TRACER.counters


def self_ns(records: list[dict], names) -> list[tuple]:
    """(frame, name, self ns) of every record named in `names`: its duration
    less the durations of the records named in `names` whose nearest
    ancestor among them it is (a phase's time without the phases nested
    in it)."""
    names = set(names)
    by_id = {r["id"]: r for r in records}
    nested = defaultdict(int)
    for r in records:
        if r["name"] not in names:
            continue
        p = by_id.get(r["parent"])
        while p is not None and p["name"] not in names:
            p = by_id.get(p["parent"])
        if p is not None:
            nested[p["id"]] += r["end_ns"] - r["start_ns"]
    return [(r["frame"], r["name"], r["end_ns"] - r["start_ns"] - nested[r["id"]])
            for r in records if r["name"] in names]


def add_to_chrome_trace(path: str, records: list[dict]) -> None:
    """Append the spans to a torch.profiler Chrome trace as complete ("X")
    events of this thread, on the trace's timebase (its microseconds count
    from `baseTimeNanoseconds`)."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), threading.get_native_id()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "mm3dgs_span", "name": r["name"], "pid": pid, "tid": tid,
         "ts": (r["start_ns"] - base) / 1e3, "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
         "args": dict(r["attrs"], frame=r["frame"])} for r in records)
    with open(path, "w") as f:
        json.dump(trace, f)
