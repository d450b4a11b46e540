"""The join of a profile's device activities and idle gaps to the program's
spans, on hand-made records."""
from __future__ import annotations

import pytest

from slambench import program_spans

M = 1_000_000   # ns per ms


def _rec(i, name, s, e, parent, frame=1, **attrs):
    return dict(name=name, start_ns=s, end_ns=e, id=i, parent=parent, frame=frame,
                attrs=attrs)


def _frame_records():
    """One frame's spans: two tracking iterations (one rebin), a keyframe
    decision with one render, one mapping segment of one iteration."""
    return [_rec(*a) for a in [
        (0, "frame", 0, 10 * M, None),
        (1, "track", 0, 4 * M, 0),
        (2, "track.iter", 0, 2 * M, 1),
        (3, "track.bins", 0, M // 2, 2),
        (4, "track.loss", M // 2, 12 * M // 10, 2),
        (5, "kernel.composite_fwd", 6 * M // 10, 7 * M // 10, 4),
        (6, "track.backward", 12 * M // 10, 18 * M // 10, 2),
        (7, "track.iter", 2 * M, 4 * M, 1),
        (8, "track.loss", 2 * M, 3 * M, 7),
        (9, "track.backward", 3 * M, 36 * M // 10, 7),
        (10, "map", 4 * M, 10 * M, 0),
        (11, "map.kf_decision", 4 * M, 5 * M, 10),
        (12, "bins", 41 * M // 10, 44 * M // 10, 11),
        (13, "map.optimize", 5 * M, 10 * M, 10),
        (14, "map.bins", 5 * M, 59 * M // 10, 13),
        (15, "map.iter", 59 * M // 10, 10 * M, 13),
        (16, "map.loss", 59 * M // 10, 7 * M, 15),
        (17, "map.backward", 7 * M, 9 * M, 15)]]


def _events():
    """Three device activities launched inside kernel.composite_fwd, the
    keyframe decision's bins and map.backward; the runtime calls that
    launched them; the benchmark's range around the kernel launch."""
    return dict(device=[(700_000, 800_000, "composite_fwd_kernel", 1),
                        (4_300_000, 4_350_000, "radix_sort", 2),
                        (8_100_000, 8_200_000, "composite_bwd_rows_kernel", 3)],
                runtime=[(650_000, 1), (4_200_000, 2), (8_000_000, 3)],
                spans={"slambench.k.0": [(590_000, 710_000)]}, host=[])


def test_device_activities_per_span_per_iteration():
    ops = program_spans.device_ops_by_span(_events(), _frame_records())
    # two tracking iterations, one mapping iteration
    assert ops == {"track.loss>kernel.composite_fwd": 0.5, "map.kf_decision>bins": 1.0,
                   "map.backward": 1.0}


def test_idle_gaps_by_innermost_span():
    recs = _frame_records()
    # gap 0.8-4.3 ms, middle 2.55 ms in the second track.loss; gap 4.35-8.1 ms,
    # middle 6.225 ms in map.loss
    assert program_spans.idle_by_span(_events(), recs) == pytest.approx(
        {"map.loss": 3.75e-3, "track.loss": 3.5e-3})
    # the benchmark's own copies at the second gap's middle
    assert program_spans.idle_by_span(_events(), recs, own=[(6_000_000, 6_500_000)]) == \
        pytest.approx({"(slambench.rec)": 3.75e-3, "track.loss": 3.5e-3})
    assert program_spans.idle_by_span(_events(), []) == {}


def test_innermost_span_and_the_clock_offset():
    recs = _frame_records()
    index = program_spans.innermost(recs)
    names = {r["id"]: r["name"] for r in recs}
    at = lambda t: names.get(program_spans._at(index, t))  # noqa: E731
    assert [at(t) for t in (650_000, 1_900_000, 4_200_000, 9_500_000, 11 * M)] == [
        "kernel.composite_fwd", "track.iter", "bins", "map.iter", None]
    assert program_spans.clock_offset_us(_events(), recs) == 0.0
    late = dict(_events(), spans={"slambench.k.0": [(610_000, 710_000)]})
    assert program_spans.clock_offset_us(late, recs) == pytest.approx(10.0)


def test_coverage_of_one_frame():
    cov = program_spans.coverage(_frame_records())
    assert cov == pytest.approx(dict(track_s=4e-3, map_s=6e-3, track_iter_share=1.0,
                                     map_iter_bins_share=1.0))
