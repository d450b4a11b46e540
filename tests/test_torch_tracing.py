"""The port's spans and counters (mm3dgs_slam_torch/spans.py).

On the CPU, configs/synthetic.yml at 48x64 on its JAX scene, 3 frames of 3
tracking and 3 mapping iterations (a tracking rebin every 2): the tracer
off records nothing, on it leaves the poses and the map the same bits; the
span tree, the bin counters against the builds, one clock with
torch.profiler, the phase decomposition's self times and the spans in
`debug.jax_profiler_dir`'s trace.

Marked `gpu` (each decides inside itself whether there is a card), on the
benchmark's orbit (slambench's synthetic_tum.orbit, seed 4200000011, frames
0-4, frame 2 under torch.profiler), tracer off and on:

    python -m pytest tests/test_torch_tracing.py -m gpu --noconftest -s

the same synchronizes and device-to-host copies in the profiled frame, the
same bits after frame 4, each device activity the join gives to a
`kernel.<name>` span that kernel, and the spans' cover of the SLAM's own
tracking and mapping seconds.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from mm3dgs_slam_torch import spans

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
N_FRAMES, TRACK_ITERS, MAP_ITERS = 3, 3, 3


def _cfg(out: Path) -> dict:
    from mm3dgs_slam_torch.config import load_config

    cfg = load_config(str(ROOT / "configs" / "synthetic.yml"))
    cfg["outputdir"] = str(out)
    cfg["early_stop_idx"] = N_FRAMES
    cfg["desired_height"], cfg["desired_width"] = 48, 64
    cfg["tracking"]["iters"], cfg["mapping"]["iters"] = TRACK_ITERS, MAP_ITERS
    cfg["tpu"]["rebin_every"] = 2
    return cfg


def _slam(out: Path):
    from mm3dgs_slam_torch.data.synthetic import jax_scene_path, load_scene
    from mm3dgs_slam_torch.slam.slam import SLAM

    return SLAM(_cfg(out), device="cpu", scene=load_scene(jax_scene_path("synthetic")))


def _steps(slam):
    for idx in range(slam.n_img):
        slam._step(idx)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The run with the tracer off, then on with every build_bins call
    recorded: (off SLAM, its records and counters, on SLAM, its records,
    its counters, the pair_gauss length of each build)."""
    import mm3dgs_slam_torch.ops.render as render_mod
    import mm3dgs_slam_torch.parallel.tile_sharded as ts_mod

    root = tmp_path_factory.mktemp("tracing")
    spans.disable()
    spans.reset()
    off = _slam(root / "off")
    _steps(off)
    off_recs, off_counts = spans.records(), spans.counters()

    builds = []
    real = ts_mod.build_bins

    def build_bins(*a, **k):
        bins = real(*a, **k)
        builds.append(int(bins.pair_gauss.shape[0]))
        return bins

    on = _slam(root / "on")
    ts_mod.build_bins = render_mod.build_bins = build_bins
    spans.reset()
    spans.enable()
    try:
        _steps(on)
    finally:
        spans.disable()
        ts_mod.build_bins = render_mod.build_bins = real
    return off, off_recs, off_counts, on, spans.records(), spans.counters(), builds


def test_span_is_one_shared_noop_while_off():
    spans.disable()
    spans.reset()
    assert spans.span("frame", idx=0) is spans.NOOP
    assert spans.phase("data") is spans.NOOP
    with spans.span("track.iter", i=0, rebin=True):
        spans.count("bins.builds")
    assert spans.records() == [] and spans.counters() == {}


def test_tracer_off_records_nothing(runs):
    _, off_recs, off_counts, *_ = runs
    assert off_recs == [] and off_counts == {}


def test_tracer_on_keeps_the_poses_and_the_map(runs):
    off, _, _, on, *_ = runs
    assert np.array_equal(on.estimate_pose_list, off.estimate_pose_list)
    for name, a, b in zip(on.gaussians._fields, on.gaussians, off.gaussians):
        assert torch.equal(a, b), name


def test_span_tree(runs):
    *_, on, recs, _, _ = runs
    by_id = {r["id"]: r for r in recs}
    parent = lambda r: by_id[r["parent"]]  # noqa: E731
    frames = [r for r in recs if r["name"] == "frame"]
    assert [r["attrs"]["idx"] for r in frames] == list(range(N_FRAMES))
    for r in recs:
        # every span of a frame lies inside it and carries its index
        top = r
        while top["parent"] is not None:
            top = parent(top)
            assert top["start_ns"] <= r["start_ns"] <= r["end_ns"] <= top["end_ns"]
        assert top["name"] == "frame" and r["frame"] == top["attrs"]["idx"]
    for r in recs:
        if r["name"] == "track.iter":
            assert parent(r)["name"] == "track" and parent(parent(r))["name"] == "frame"
            assert r["attrs"]["rebin"] == (r["attrs"]["i"] % 2 == 0)
        if r["name"] in ("track.loss", "track.backward", "track.bins"):
            assert parent(r)["name"] == "track.iter"
        if r["name"] in ("map.loss", "map.backward"):
            assert parent(r)["name"] == "map.iter"
        if r["name"] in ("map.iter", "map.bins"):
            assert parent(r)["name"] == "map.optimize"
            assert parent(parent(r))["name"] == "map"
        if r["name"] == "map.niqe":
            assert parent(r)["name"] == "map.kf_decision"
        if r["name"].startswith("kernel."):
            assert parent(r)["name"] in ("track.loss", "track.backward", "map.loss",
                                         "map.backward", "map.kf_decision", "map.candidates",
                                         "map.add_keyframe")
    per = Counter((r["frame"], r["name"]) for r in recs)
    for idx in range(N_FRAMES):
        # frame 0 is not tracked; every frame is mapped
        assert per[idx, "track.iter"] == (0 if idx == 0 else TRACK_ITERS)
        assert per[idx, "map.iter"] == on.mapper.num_iter == MAP_ITERS
        assert per[idx, "frame"] == per[idx, "track"] == per[idx, "map"] == 1


def test_bin_counters_count_every_build(runs):
    *_, recs, counts, builds = runs
    assert counts["bins.builds"] == len(builds) > 0
    assert counts["bins.pairs"] == sum(builds)
    assert counts["bins.candidate_pairs"] >= counts["bins.pairs"]
    # one build per span that builds bins
    assert len(builds) == sum(r["name"] in ("track.bins", "map.bins", "bins") for r in recs)


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    spans.reset()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with spans.span("probe"), record_function("probe_range"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        spans.disable()
    ours = [r for r in spans.records() if r["name"] == "probe"]
    theirs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe_range")
    assert len(ours) == len(theirs) == 3
    for r, (s, e) in zip(ours, theirs):
        assert abs(r["start_ns"] - s) < 1_000_000 and abs(r["end_ns"] - e) < 1_000_000


def test_phase_time_leaves_out_the_phases_nested_in_it():
    def rec(i, name, s, e, parent):
        return dict(name=name, start_ns=s, end_ns=e, id=i, parent=parent, frame=4, attrs={})

    recs = [rec(0, "frame", 0, 100, None), rec(1, "map", 10, 90, 0),
            rec(2, "map.kf_decision", 10, 40, 1), rec(3, "bins", 12, 20, 2),
            rec(4, "map.niqe", 20, 35, 2), rec(5, "track", 0, 10, 0),
            rec(6, "track.iter", 1, 9, 5)]
    got = spans.self_ns(recs, ("map.kf_decision", "map.niqe", "track"))
    # kf_decision less niqe; track keeps its iterations, which are no phase
    assert sorted(got) == [(4, "map.kf_decision", 15), (4, "map.niqe", 15), (4, "track", 10)]


def test_profiler_trace_holds_the_spans_around_the_kernels(tmp_path):
    cfg = _cfg(tmp_path)
    cfg["early_stop_idx"] = 1
    cfg["debug"]["jax_profiler_dir"] = str(tmp_path / "trace")
    from mm3dgs_slam_torch.data.synthetic import jax_scene_path, load_scene
    from mm3dgs_slam_torch.slam.slam import SLAM

    slam = SLAM(cfg, device="cpu", scene=load_scene(jax_scene_path("synthetic")))
    slam.run()
    assert slam.failed is None and not spans.TRACER.on
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "mm3dgs_span"]
    frames = [e for e in ours if e["name"] == "frame"]
    assert [e["args"]["idx"] for e in frames] == [0]
    assert {"map.iter", "map.loss", "kernel.composite_fwd"} <= {e["name"] for e in ours}
    composites = [e for e in events if e.get("name") == "_CompositePacked"]
    assert composites
    # the profiler's own ranges of the composite lie inside the frames' spans
    for c in composites:
        assert any(f["ts"] - 1e3 <= c["ts"] and c["ts"] + c["dur"] <= f["ts"] + f["dur"] + 1e3
                   for f in frames), c


# ----------------------------------------------------------------- on the card
ORBIT_SEED = 4200000011
PROFILED = 2
LAST = 4
KERNEL_SYMBOL = {"kernel.composite_fwd": "composite_fwd_kernel",
                 "kernel.composite_bwd_rows": "composite_bwd_rows_kernel",
                 "kernel.slot_reduce": "slot_reduce_kernel",
                 "kernel.composite_pose_bwd": "composite_pose_bwd_kernel",
                 "kernel.pose_rows": "pose_rows_kernel"}


def _orbit_run(traced: bool) -> dict:
    """Frames 0-4 of the benchmark's orbit on the card, frame 2 under
    torch.profiler; with `traced` the tracer on over frames 1-4."""
    from torch.profiler import ProfilerActivity, profile

    import mm3dgs_slam_torch.data.synthetic as syn_mod
    from mm3dgs_slam_torch.slam.slam import SLAM
    from slambench import harness, trace
    from slambench import scene as sc

    spec = harness.cell_spec("synthetic_tum.orbit")
    dev = torch.device("cuda")
    out = ROOT / "build" / "tracing_test"
    cfg = harness.slam_config(spec["config"], spec["traffic"], ORBIT_SEED, str(out))
    synthetic = sc.SyntheticSequence(spec["traffic"], harness.loader_cam(cfg), ORBIT_SEED, dev)
    real = syn_mod.render_frame
    syn_mod.render_frame = synthetic.renderer()
    try:
        slam = SLAM(cfg, "cuda", scene=synthetic.scene)
        slam._step(0)
        slam._sync()
        frames, prof = {}, None
        for idx in range(1, LAST + 1):
            if traced:
                spans.reset()
                spans.enable()
            tr0, mp0 = slam.tracking_time_sum, slam.mapper.mapping_time_sum
            if idx == PROFILED:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    slam._step(idx)
                    slam._sync()
            else:
                slam._step(idx)
                slam._sync()
            spans.disable()
            frames[idx] = dict(track_s=slam.tracking_time_sum - tr0,
                               map_s=slam.mapper.mapping_time_sum - mp0,
                               records=spans.records() if traced else [])
        syncs = Counter()
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                if "DtoH" in name or "Device -> Pageable" in name or "Device -> Pinned" in name:
                    syncs["device: " + name] += 1
            elif name.startswith("cu") and ("Synchronize" in name or "Memcpy" in name):
                syncs[name] += 1
        events = trace.read_events(prof)
        state = dict(poses=slam.estimate_pose_list[:LAST + 1].copy(),
                     leaves=[t.detach().cpu() for t in slam.gaussians])
        slam._frames.close()
        return dict(frames=frames, syncs=syncs, events=events, **state)
    finally:
        syn_mod.render_frame = real
        spans.disable()


@pytest.fixture(scope="module")
def orbit_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _orbit_run(False), _orbit_run(True)


@pytest.mark.gpu
def test_tracer_adds_no_synchronize_on_the_card(orbit_runs):
    off, on = orbit_runs
    print(f"[tracing] profiled frame, tracer off: {dict(off['syncs'])}; on: {dict(on['syncs'])}")
    assert off["syncs"] == on["syncs"]
    assert np.array_equal(off["poses"], on["poses"])
    for a, b in zip(off["leaves"], on["leaves"]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_spans_join_their_kernels_on_the_card(orbit_runs):
    from slambench import program_spans

    _, on = orbit_runs
    recs, events = on["frames"][PROFILED]["records"], on["events"]
    index, by_id = program_spans.innermost(recs), {r["id"]: r for r in recs}
    launch = {corr: t for t, corr in events["runtime"]}
    joined = Counter()
    for d in events["device"]:
        sid = program_spans._at(index, launch[d[3]]) if d[3] in launch else None
        name = by_id[sid]["name"] if sid is not None else None
        if name in KERNEL_SYMBOL:
            assert KERNEL_SYMBOL[name] in d[2], (name, d[2])
            joined[name] += 1
        elif any(sym in d[2] for sym in KERNEL_SYMBOL.values()):
            pytest.fail(f"{d[2]} launched outside its kernel span (in {name})")
    print(f"[tracing] device activities joined to kernel spans: {dict(joined)}")
    assert set(joined) == set(KERNEL_SYMBOL)


@pytest.mark.gpu
def test_spans_cover_the_slams_own_seconds_on_the_card(orbit_runs):
    from slambench import program_spans

    _, on = orbit_runs
    for idx, f in on["frames"].items():
        cov = program_spans.coverage(f["records"])
        print(f"[tracing] frame {idx}: {cov}, tracking {f['track_s']:.4f} s, mapping "
              f"{f['map_s']:.4f} s")
        if idx == PROFILED:
            continue
        assert cov["track_s"] == pytest.approx(f["track_s"], rel=0.01)
        assert cov["map_s"] == pytest.approx(f["map_s"], rel=0.01)
        assert cov["track_iter_share"] >= 0.97
        assert cov["map_iter_bins_share"] >= 0.90
