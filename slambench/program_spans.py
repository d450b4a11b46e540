"""Reading the program's own spans (mm3dgs_slam_torch/spans.py) beside a
torch.profiler trace of the same frame.

The spans are plain records (name, start_ns, end_ns, id, parent, frame,
attrs) on the profiler's clock, one frame's at a time. A device activity
belongs to the innermost span in which the runtime call that launched it
starts, as trace.device_in joins activities to the benchmark's own
`slambench.*` ranges; an idle gap of the card belongs to the innermost span
open at its middle. A program without spans gives no records, and every
function here then returns an empty result.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from . import trace

LOOPS = (("track", "track.iter"), ("map", "map.iter"))   # (loop span, its iteration span)


def own_intervals(prof, name: str = "slambench.rec") -> list:
    """The host intervals of the benchmark's own `name` ranges in a profile
    (trace.read_events drops them with the work inside them)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() == name and not str(e.device_type()).endswith("CUDA"):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out)


def keys(records: list) -> dict:
    """id -> (key, loop) of every record: the key is the span's name, a
    kernel launch's or a `bins` build's prefixed with its parent's
    (`track.loss>kernel.composite_fwd`, `map.kf_decision>bins`); the loop
    is `track` or `map` where the span lies inside that span, else None."""
    by_id = {r["id"]: r for r in records}
    out = {}
    for r in records:
        parent = by_id.get(r["parent"])
        key = r["name"]
        if parent is not None and (key.startswith("kernel.") or key == "bins"):
            key = f"{parent['name']}>{key}"
        loop, p = None, r
        while p is not None:
            if p["name"] in ("track", "map"):
                loop = p["name"]
                break
            p = by_id.get(p["parent"])
        out[r["id"]] = (key, loop)
    return out


def innermost(records: list):
    """(times, ids): from times[i] to times[i + 1] the innermost open span
    is ids[i] (None where no span is open). Spans of one thread nest."""
    times, ids, stack = [], [], []
    for r in sorted(records, key=lambda r: (r["start_ns"], -r["end_ns"])):
        while stack and stack[-1]["end_ns"] <= r["start_ns"]:
            top = stack.pop()
            times.append(top["end_ns"])
            ids.append(stack[-1]["id"] if stack else None)
        stack.append(r)
        times.append(r["start_ns"])
        ids.append(r["id"])
    while stack:
        top = stack.pop()
        times.append(top["end_ns"])
        ids.append(stack[-1]["id"] if stack else None)
    return times, ids


def _at(index, t):
    times, ids = index
    i = bisect.bisect_right(times, t) - 1
    return ids[i] if i >= 0 else None


def iterations(records: list) -> dict:
    """loop -> its iteration spans in the records ({"track": 100, "map": 150})."""
    n = defaultdict(int)
    names = dict((it, loop) for loop, it in LOOPS)
    for r in records:
        if r["name"] in names:
            n[names[r["name"]]] += 1
    return dict(n)


def device_ops_by_span(events: dict, records: list) -> dict:
    """key -> device activities launched inside the span (its innermost),
    per iteration of the loop it lies in (per frame outside both loops)."""
    if not records:
        return {}
    index, k = innermost(records), keys(records)
    launch = {corr: t for t, corr in events["runtime"]}
    n = defaultdict(int)
    for d in events["device"]:
        t = launch.get(d[3])
        sid = None if t is None else _at(index, t)
        n[k[sid] if sid is not None else ("(no span)", None)] += 1
    iters = iterations(records)
    return {key: c / max(iters.get(loop, 1), 1) for (key, loop), c in n.items()}


def idle_by_span(events: dict, records: list, own: list | None = None) -> dict:
    """key -> seconds of the card's idle time between its first and last
    activity, each gap charged to the innermost span open at its middle, or
    to `(slambench.rec)` where the benchmark's own copies ran then."""
    device = events["device"]
    if not records or not device:
        return {}
    index, k = innermost(records), keys(records)
    own = own or []
    own_starts = [a for a, _ in own]
    busy = trace.merged(device)
    by = defaultdict(int)
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(own_starts, mid) - 1
        if j >= 0 and own[j][0] <= mid <= own[j][1]:
            key = "(slambench.rec)"
        else:
            sid = _at(index, mid)
            key = k[sid][0] if sid is not None else "(no span)"
        by[key] += g1 - g0
    return {key: v * 1e-9 for key, v in sorted(by.items(), key=lambda kv: -kv[1])}


def clock_offset_us(events: dict, records: list) -> float | None:
    """How far, in µs, the program's kernel spans reach outside the
    benchmark's `slambench.k.<i>` ranges around the same launches (0 when
    the two clocks agree: each kernel span lies inside its range)."""
    ranges = sorted(iv for name, ivs in events["spans"].items()
                    if name.startswith("slambench.k.") for iv in ivs)
    kern = [r for r in records if r["name"].startswith("kernel.")]
    if not ranges or not kern:
        return None
    starts = [a for a, _ in ranges]
    worst = 0
    for r in kern:
        i = bisect.bisect_right(starts, r["start_ns"]) - 1
        cands = [ranges[j] for j in (i, i + 1) if 0 <= j < len(ranges)]
        worst = max(worst, min(max(0, a - r["start_ns"], r["end_ns"] - b) for a, b in cands))
    return worst * 1e-3


def coverage(records: list) -> dict:
    """One frame's spans against each other: the `track` and `map` spans
    (s), the share of `track` that its `track.iter` spans cover and the
    share of `map.optimize` that `map.iter` and `map.bins` cover."""
    def total(*names):
        return sum(r["end_ns"] - r["start_ns"] for r in records if r["name"] in names)

    out = dict(track_s=total("track") * 1e-9, map_s=total("map") * 1e-9)
    if total("track.iter"):
        out["track_iter_share"] = total("track.iter") / total("track")
    if total("map.optimize"):
        out["map_iter_bins_share"] = total("map.iter", "map.bins") / total("map.optimize")
    return out
