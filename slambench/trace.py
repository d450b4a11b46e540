"""Reading a torch.profiler trace of one frame: the device's activities
(kernels, copies and fills) inside the benchmark's own spans, their busy
union, the kernels by name, and the idle gaps by what the host was doing.

The spans are the benchmark's record_function ranges around the tracking
and mapping calls and each kernel launch (harness.Probe); a device activity
belongs to a span when the runtime call that launched it lies inside it.
What the benchmark itself does inside the traced frame (its `slambench.rec`
copies of each launch's inputs) is left out of the trace.
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict


def _kind(e) -> str:
    """device, runtime (a CUDA API call on the host), span (the benchmark's
    record_function ranges) or host. Classified by the device and the name,
    which every profiler version gives."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        # a range's shadow on the device timeline is no device activity
        return "span_shadow" if name.startswith("slambench.") else "device"
    if name.startswith("slambench."):
        return "span"
    if name.startswith("cu"):
        return "runtime"
    return "host"


def read_events(prof) -> dict:
    """The trace as plain lists: spans {name: [(start_ns, end_ns)]}, device
    activities [(start_ns, end_ns, name, correlation)], the runtime calls
    that launched them [(start_ns, correlation)] and host operators
    [(start_ns, end_ns, name)], each sorted by start; and a count of events
    by kind."""
    spans, dev, runtime, host = defaultdict(list), [], [], []
    kinds = Counter()
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        kinds[kind] += 1
        s, d = e.start_ns(), e.duration_ns()
        if kind == "device":
            dev.append((s, s + d, e.name(), e.correlation_id()))
        elif kind == "runtime":
            runtime.append((s, e.correlation_id()))
        elif kind == "span":
            spans[e.name()].append((s, s + d))
        elif kind == "host":
            host.append((s, s + d, e.name()))
    dev.sort()
    runtime.sort()
    host.sort()
    events = dict(spans=dict(spans), device=dev, runtime=runtime, host=host, kinds=dict(kinds))
    return drop_own(events)


def drop_own(events: dict, span: str = "slambench.rec") -> dict:
    """The trace without the benchmark's own work: the device activities
    launched from inside `span` (its copies of the launches' inputs) and
    the host operators that start there."""
    own = sorted(events["spans"].pop(span, []))
    if not own:
        return events
    drop = {d[3] for d in device_in(events, own)}
    events["device"] = [d for d in events["device"] if d[3] not in drop]
    starts = [a for a, _ in own]
    events["host"] = [h for h in events["host"]
                      if not _inside(starts, own, h[0])]
    return events


def _inside(starts, spans, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def device_in(events: dict, spans) -> list:
    """The device activities launched from inside the (start, end) host
    intervals: those whose runtime call starts there (a launch runs on the
    device after the call returns, so the activity's own time may lie
    after the span)."""
    rt = events["runtime"]
    starts = [r[0] for r in rt]
    corr = set()
    for a, b in spans:
        for i in range(bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)):
            corr.add(rt[i][1])
    return [d for d in events["device"] if d[3] in corr]


def busy_union_ns(events) -> int:
    """Nanoseconds in which at least one of the intervals runs."""
    total, cur_s, cur_e = 0, None, None
    for s, e, *_ in sorted(events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(events):
    out = []
    for s, e, *_ in sorted(events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def top_device_ops(events, n: int = 10):
    """[[name, seconds]] of the device activities that took most time."""
    by = defaultdict(int)
    for s, e, name, *_ in events:
        by[name] += e - s
    return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device, host, n: int = 10):
    """[[host operator, seconds]]: the device's idle time between the first
    and the last activity of the trace, each gap charged to the innermost
    host operator running at its middle ("(no host operator)" where none
    runs)."""
    starts = [h[0] for h in host]
    by = defaultdict(int)
    if not device:
        return []
    for a, b in [(min(d[0] for d in device), max(d[1] for d in device))]:
        busy = merged(device)
        edges = [a] + [x for iv in busy for x in iv] + [b]
        for i in range(0, len(edges), 2):
            g0, g1 = edges[i], edges[i + 1]
            if g1 <= g0:
                continue
            mid = (g0 + g1) // 2
            k = bisect.bisect_right(starts, mid) - 1
            name = "(no host operator)"
            for j in range(k, max(k - 256, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            by[name] += g1 - g0
    return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
