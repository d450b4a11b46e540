"""The harness's pieces on the CPU: finding cells, configurations and
metrics by name, the window's arithmetic, the idle share, the frozen bound
on a launch counted by hand, the check for JAX, and the result line.

    python -m pytest slambench/tests -q
"""
from __future__ import annotations

import json
import math

import pytest
import torch

from slambench import bounds, check, harness, reference as ref, trace
from slambench import run as run_mod


def test_cells_configs_and_metrics_found_by_name():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        spec = harness.cell_spec(w["name"], bench)
        assert spec["config"]["name"] == w["config"]
        assert spec["traffic"]["kind"] in ("synthetic", "utmm")
        assert "setup_s" in spec["end_to_end"] and len(spec["end_to_end"]) >= 2
        assert spec["per_layer"], w["name"]
        assert set(spec["limits"]) == set(check.numbers_for(spec["config"]["config"])), w["name"]
        in_cell = lambda m: w["name"] in m.get("workloads", [w["name"]])  # noqa: E731
        assert spec["end_to_end"] == [m["name"] for m in bench["end_to_end"] if in_cell(m)]
        assert spec["per_layer"] == [m["name"] for m in bench["per_layer"] if in_cell(m)]
        # a per-layer metric moves an end-to-end metric that its cell reports
        moves = {m["name"]: m["moves"] for m in bench["per_layer"]}
        assert {moves[n] for n in spec["per_layer"]} <= set(spec["end_to_end"]), w["name"]
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    with pytest.raises(KeyError):
        harness.cell_spec("no_such.cell", bench)


def test_a_metric_with_workloads_is_reported_in_those_cells_alone():
    bench = harness.benchmark()
    orbit = harness.cell_spec("synthetic_tum.orbit", bench)
    utmm = harness.cell_spec("utmm.imu", bench)
    assert orbit["end_to_end"] == utmm["end_to_end"] == ["peak_mem_gib", "setup_s"]
    loops = {"loop_frames_per_s", "loop_track_s_per_frame", "map_rows"}
    assert loops <= set(utmm["per_layer"]) and loops <= set(orbit["per_layer"])
    assert "frame_other_ms" in orbit["per_layer"] and "frame_other_ms" not in utmm["per_layer"]


def _frames():
    # three frames of the window; the second profiled
    return [dict(idx=1, wall_s=6.0, track_s=2.5, map_s=3.3, track_iters=100, map_iters=150,
                 profiled=False),
            dict(idx=2, wall_s=12.0, track_s=5.0, map_s=6.5, track_iters=100, map_iters=150,
                 profiled=True),
            dict(idx=3, wall_s=7.0, track_s=3.5, map_s=3.3, track_iters=100, map_iters=150,
                 profiled=False)]


def test_window_arithmetic():
    e2e = harness.end_to_end(3 * 2 ** 30, 17.5)
    assert set(e2e) == {"peak_mem_gib", "setup_s"}
    assert e2e["peak_mem_gib"] == (3.0, "GiB")
    assert e2e["setup_s"][0] == 17.5
    ctx = dict(frames=_frames(), phases=dict(track=dict(n_ops=117000), map=dict(n_ops=183000)),
               launches=[dict(phase="track", bound_s=0.002, device_s=0.08),
                         dict(phase="map", bound_s=0.003, device_s=0.1)],
               loops_busy_s=0.68, map_rows=211200)
    read = lambda name: harness.metric_reader(name)(ctx)  # noqa: E731
    # the unprofiled frames only: (6 - 2.5 - 3.3 + 7 - 3.5 - 3.3) / 2 s
    assert read("frame_other_ms") == pytest.approx(200.0)
    assert read("map_s_per_frame") == pytest.approx(3.3)
    assert read("device_ops_per_iter.track") == pytest.approx(1170.0)
    assert read("device_ops_per_iter.map") == pytest.approx(1220.0)
    assert read("kernel_roofline.track") == pytest.approx(2.5)
    assert read("kernel_roofline.map") == pytest.approx(3.0)
    # 0.002 s of bound per 100 iterations against 3 s per 100 iterations
    assert read("mfu.track") == pytest.approx(100 * 0.002 / 3.0)
    assert read("mfu.map") == pytest.approx(100 * 0.003 / 3.3)
    # 1 - 0.68 s busy over (5.8 + 6.8) / 2 s of loops
    assert read("device_idle") == pytest.approx(100 * (1 - 0.68 / 6.3))
    # the unprofiled frames only: 2 frames over 13 s; (2.5 + 3.5) / 2 s
    assert read("loop_frames_per_s") == pytest.approx(2 / 13.0)
    assert read("loop_track_s_per_frame") == pytest.approx(3.0)
    assert read("map_rows") == 211200.0
    empty = dict(ctx, launches=[], frames=[f for f in _frames() if f["profiled"]],
                 map_rows=None)
    for name in ("kernel_roofline.track", "mfu.map", "frame_other_ms", "device_idle",
                 "loop_frames_per_s", "loop_track_s_per_frame", "map_rows"):
        assert harness.metric_reader(name)(empty) is None


def test_idle_share_from_intervals():
    # device activities (start, end, name, correlation), ns; runtime calls
    dev = [(100, 200, "k", 1), (150, 300, "k", 2), (400, 450, "memcpy", 3), (900, 950, "k", 4)]
    events = dict(device=dev, runtime=[(10, 1), (20, 2), (30, 3), (600, 4)],
                  spans={"slambench.track": [(0, 50)], "slambench.map": [(500, 700)]}, host=[
                      (0, 60, "aten::add"), (300, 399, "aten::nonzero"),
                      (460, 890, "aten::item")])
    track = trace.device_in(events, events["spans"]["slambench.track"])
    assert [d[3] for d in track] == [1, 2, 3]
    assert trace.busy_union_ns(track) == (300 - 100) + (450 - 400)
    assert trace.busy_union_ns(dev) == 200 + 50 + 50
    gaps = dict(trace.idle_gaps(dev, events["host"]))
    assert gaps == pytest.approx({"aten::nonzero": 100e-9, "aten::item": 450e-9})
    assert trace.top_device_ops(dev)[0] == ["k", pytest.approx(300e-9)]


def test_frozen_bound_on_a_launch_counted_by_hand():
    cam = ref.Cam(16, 16, 10.0, 10.0, 7.5, 7.5)
    # one tile, two Gaussians: a broad one that stops no pixel and a tiny
    # one that no pixel of the tile reaches
    xy = torch.tensor([[7.5, 7.5], [-40.0, -40.0]])
    conic = torch.tensor([[1e-6, 0.0, 1e-6], [1.0, 0.0, 1.0]])
    op = torch.tensor([0.5, 0.9])
    bins = ref.Bins(torch.tensor([0, 1]), torch.tensor([0]), torch.tensor([2]))
    w = ref.walk_counts(xy, conic, op, bins, cam)
    assert w == dict(used=256, stops=0, pairs_used=1, n_seen=2, n_pairs=2, n_tiles=1)
    b, by = bounds.launch_bound("composite_fwd", 5, w)
    n_bytes = 4 * (2 * 11 + 2 + 2 + 256 * 6)
    n_ops = 256 * 11 + 256 * 16
    assert by == "bytes" and b == pytest.approx(n_bytes / 3.35e12)
    assert n_ops / 67e12 < b
    b, by = bounds.launch_bound("slot_reduce", 3, w, n_rows=2)
    assert b == pytest.approx(4 * (2 * 9 + 2 + 1 + 2 + 32) / 3.35e12)
    # an opaque one stops every pixel: its pixel-pairs are stops, not uses
    w2 = ref.walk_counts(xy[:1], torch.tensor([[1e-6, 0.0, 1e-6]]), torch.tensor([1.0]),
                         ref.Bins(torch.tensor([0, 0]), torch.tensor([0]), torch.tensor([2])),
                         cam)
    assert (w2["used"], w2["stops"]) == (256, 256)


def test_no_jax_check_compares_whole_top_level_names():
    names = ["jax", "jaxlib.xla_client", "flax.linen", "mm3dgs_slam_tpu.ops",
             "mm3dgs_slam_torch.slam", "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(names) == ["flax", "jax", "jaxlib", "mm3dgs_slam_tpu"]
    assert harness.forbidden_modules(["mm3dgs_slam_torch", "mm3dgs_slam_tpux"]) == []


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "synthetic_tum.orbit", "--seed", "3000000001",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_result_line_shape(tiny_run):
    r = dict(tiny_run)
    r.pop("readings")
    r.pop("check_frame")
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"peak_mem_gib", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"] is True


def test_traced_run_on_the_cpu_reads_no_device_metric():
    from slambench.tests.conftest import tiny_run_of

    r = tiny_run_of("synthetic_tum.orbit", 4100000017, traced=True)
    assert r["correct"]
    assert set(r["metrics"]) == {"frame_other_ms", "map_s_per_frame", "loop_frames_per_s",
                                 "loop_track_s_per_frame"}
    assert "busy_s" in r["device"] and r["device"]["platform"] == "cpu"
