"""One run of one cell: set-up, the timed window over the SLAM frame loop,
the per-layer readings of a traced run, and the check of the outputs.

Everything that belongs to one cell is data the harness finds by name:
BENCHMARK.json's workload entry names a configuration (configs/<name>.json,
the frozen SLAM config with its source) and a traffic mix
(traffic/<name>.json, the parameters scene.py's generator reads); the
limits of the check are limits/<cell>.json; each per-layer metric is a
reader metrics/<metric>.py with a `read(ctx)` that returns a number or
None. A later cell or metric adds files and edits none.

The harness reaches into the program at named entry points (Probe): the
tracking and mapping calls of the frame loop, the map optimizer's
gradient and Adam steps, bundle adjustment's pose Adam, frame 0's new
Gaussians and the four kernel wrappers of mm3dgs_slam_torch/ops/kernels.py.
A missing entry point fails the run.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import inspect
import json
import os
import shutil
import sys
import tempfile
import time
import weakref
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mm3dgs_slam_tpu")
KERNEL_ENTRIES = ("composite_fwd", "composite_bwd_rows", "slot_reduce", "composite_pose_bwd")
PROFILED_FRAME = 2      # the window's second frame, after one unprofiled frame
CHECK_FRAMES = (1, 3)   # the checked frame is one of these, drawn from the seed
# peak_mem_gib is the peak over frames 1 .. MEM_FRAMES: the map frame 0 seeded,
# before the first keyframe can grow it (kf_every 5 in both configurations), so
# the same frames and the same map size in every run, whatever the seed
MEM_FRAMES = 4


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of loaded modules that the benchmark may not hold:
    each module's name up to its first dot, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(workload: str, bench: dict | None = None) -> dict:
    """The cell `workload` of BENCHMARK.json with its configuration, traffic
    and limits loaded from their files. A metric with a `workloads` list is
    reported in those cells alone, one without it in every cell."""
    bench = benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m["name"] for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    limits_path = HERE / "limits" / f"{workload}.json"
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    sources = {m["name"]: m["source"] for m in bench["end_to_end"] + bench["per_layer"]}
    return dict(name=workload, chips=int(w["chips"]), units=units, sources=sources,
                config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(limits_path)["limits"] if limits_path.exists() else {},
                per_layer=per_layer, end_to_end=end_to_end)


def metric_reader(name: str):
    """metrics/<name>.py's `read`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def slam_config(conf: dict, traffic: dict, seed: int, outdir: str,
                inputdir: str | None = None) -> dict:
    """The frozen config as the run uses it: output under the run's
    temporary directory, the runtime counters on, and the traffic's scene
    or sequence."""
    cfg = copy.deepcopy(conf["config"])
    cfg["outputdir"] = outdir
    cfg.setdefault("debug", {})["get_runtime_stats"] = True
    if traffic["kind"] == "synthetic":
        cfg["synthetic"] = dict(
            n_gaussians=int(traffic["n_gaussians"]), n_frames=int(traffic["n_frames"]),
            seed=seed, orbit_radius=float(traffic["orbit_radius"]),
            textured=bool(traffic.get("textured", False)),
            occluders=int(traffic.get("occluders", 0)),
            noise_std=float(traffic.get("noise_std", 0.0)))
    elif traffic["kind"] == "utmm":
        cfg["inputdir"], cfg["scene"] = inputdir, "sequence"
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    return cfg


def loader_cam(cfg: dict):
    """The camera the loader gives the SLAM: the config's intrinsics scaled
    to the desired size."""
    from . import reference as ref

    c = cfg["cam"]
    h, w = int(cfg["desired_height"]), int(cfg["desired_width"])
    rh, rw = h / c["image_height"], w / c["image_width"]
    return ref.Cam(h, w, c["fx"] * rw, c["fy"] * rh, c["cx"] * rw, c["cy"] * rh)


class Probe:
    """Wrappers around the program's entry points. On the checked frame they
    copy the frame's inputs and outputs to the host (under bundle adjustment
    also the mask of the rows the map step moves, the count of rows appended
    before mapping and the window's poses after the first three pose steps);
    on frame 0 the new Gaussians; while profiling they mark the tracking,
    mapping and kernel calls with record_function spans and copy to the host
    what each kernel launch's bound is counted from, inside a `slambench.rec`
    span whose device activities trace.read_events leaves out."""

    def __init__(self, check_idx: int, track_record: int = 4):
        self.frame = -1
        self.check_idx = check_idx
        self.track_record = track_record   # tracking iterations whose pose and loss are kept
        self.cap: dict = {"check_idx": check_idx}
        self.profiling = False
        self.phase = None
        self.launches: list[dict] = []
        self._last_inputs = None
        self._map = None
        self._rows_in = 0   # the map's rows as the checked frame's mapping began
        self._undo: list = []

    def install(self):
        import mm3dgs_slam_torch.slam.map_opt as map_opt
        import mm3dgs_slam_torch.slam.mapper as mapper_mod
        import mm3dgs_slam_torch.slam.slam as slam_mod
        import mm3dgs_slam_torch.slam.tracker as tracker_mod
        from mm3dgs_slam_torch.ops import kernels

        self._patch(slam_mod.SLAM, "_seed_pose", self._seed_pose)
        self._patch(slam_mod, "track_frame", self._track)
        self._patch(tracker_mod, "tracking_loss_tiles", self._track_loss)
        self._patch(mapper_mod, "optimize_map", self._optimize)
        self._patch(mapper_mod, "new_gaussian_candidates", self._candidates)
        self._patch(mapper_mod.Mapper, "run_frame", self._run_frame)
        self._patch(map_opt, "_grad_and_stats", self._grad_stats)
        self._patch(map_opt, "adam_update", self._adam)
        self._patch(map_opt, "pose_adam", self._pose_adam)
        for name in KERNEL_ENTRIES:
            self._patch(kernels, name, self._launch(name))
        return self

    def uninstall(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo.clear()

    def _patch(self, obj, name, make):
        if not hasattr(obj, name):
            raise RuntimeError(f"the program has no entry point {obj.__name__}.{name}, "
                               "which the benchmark reads")
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._undo.append((obj, name, orig))

    def _span(self, name: str):
        if not self.profiling:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def _checking(self) -> bool:
        return self.frame == self.check_idx

    def _seed_pose(self, orig):
        probe = self

        def seed_pose(slam, idx, *args, **kw):
            if probe._checking():   # the poses the motion model seeds from
                probe.cap["seed_prev"] = [np.array(slam.estimate_pose_list[j], np.float32)
                                          for j in (idx - 1, idx - 2) if j >= 0]
            return orig(slam, idx, *args, **kw)
        return seed_pose

    def _track(self, orig):
        def track_frame(g, pose_init, gt_color, gt_depth, est_depth, ts):
            if self._checking():
                self.cap["track_early"] = []
                self.cap["track_in"] = dict(g=[t.detach().cpu() for t in g],
                                            pose=pose_init.detach().cpu(),
                                            color=gt_color.detach().cpu(),
                                            depth=gt_depth.detach().cpu())
            self.phase = "track"
            with self._span("slambench.track"):
                out = orig(g, pose_init, gt_color, gt_depth, est_depth, ts)
            self.phase = None
            if self._checking():
                self.cap["track_out"] = out[0].detach().cpu()
                self.cap["track_early"] = [(p.cpu(), float(x)) for p, x in
                                           self.cap["track_early"]]
            return out
        return track_frame

    def _track_loss(self, orig):
        import torch

        def tracking_loss_tiles(g, q, T, *args, **kw):
            loss = orig(g, q, T, *args, **kw)
            rec = self.cap.get("track_early")
            if self._checking() and rec is not None and len(rec) < self.track_record:
                rec.append((torch.cat([q.detach(), T.detach()]), loss.detach().clone()))
            return loss
        return tracking_loss_tiles

    def _run_frame(self, orig):
        probe = self

        sig = inspect.signature(orig)

        def run_frame(mapper, *args, **kw):
            if probe._checking():   # the rows before this frame appends any
                probe._rows_in = sig.bind(mapper, *args, **kw).arguments["m"].n
            probe.phase = "map"
            with probe._span("slambench.map"):
                out = orig(mapper, *args, **kw)
            probe.phase = None
            return out
        return run_frame

    def _candidates(self, orig):
        def new_gaussian_candidates(*args, **kw):
            out = orig(*args, **kw)
            if self.frame == 0:
                c = out.candidates
                self.cap["seed"] = dict(xyz=c.xyz.detach().cpu(), mask=c.mask.detach().cpu())
            return out
        return new_gaussian_candidates

    def _optimize(self, orig):
        def optimize_map(st, kf_colors, kf_depths, kf_ests, kf_poses, schedule,
                         camera_extent, ms):
            if self._checking():
                cpu = lambda m: {f: t.detach().cpu() for f, t in m._asdict().items()}  # noqa: E731
                self.cap["map_in"] = dict(
                    leaves=cpu(st.m), mu=cpu(st.adam.mu), nu=cpu(st.adam.nu),
                    step=int(st.adam.step), max_radii=st.max_radii.detach().cpu(),
                    kf_colors=kf_colors.detach().cpu(), kf_depths=kf_depths.detach().cpu(),
                    kf_poses=kf_poses.detach().cpu(), schedule=np.asarray(schedule).copy(),
                    extent=float(camera_extent), n_added=st.m.n - self._rows_in)
                self.cap["ba_mask"] = None if st.ba_mask is None else st.ba_mask.detach().cpu()
                self._map = dict(losses=[], adam_calls=0, poses=[])
            try:
                return orig(st, kf_colors, kf_depths, kf_ests, kf_poses, schedule,
                            camera_extent, ms)
            finally:
                if self._map is not None:
                    self.cap["map_losses"] = [float(x) for x in self._map["losses"]]
                    self.cap["map_poses"] = self._map["poses"]
                self._map = None
        return optimize_map

    def _grad_stats(self, orig):
        def grad_and_stats(*args, **kw):
            out = orig(*args, **kw)
            if self._map is not None and len(self._map["losses"]) < 3:
                self._map["losses"].append(out[0].detach().clone())
            return out
        return grad_and_stats

    def _adam(self, orig):
        def adam_update(m, grads, state, hyper, row_mask=None):
            cap = self._map is not None and self._map["adam_calls"] < 2
            if cap and self._map["adam_calls"] == 0:
                self.cap["map_before"] = {f: t.detach().cpu() for f, t in m._asdict().items()}
                self.cap["map_grad"] = {f: t.detach().cpu() for f, t in grads._asdict().items()}
            out = orig(m, grads, state, hyper, row_mask=row_mask)
            if cap:
                self._map["adam_calls"] += 1
                if self._map["adam_calls"] == 2:
                    self.cap["map_after"] = {f: t.detach().cpu()
                                             for f, t in out[0]._asdict().items()}
            return out
        return adam_update

    def _pose_adam(self, orig):
        def pose_adam(pa, k, g_pose, ms):
            out = orig(pa, k, g_pose, ms)
            if self._map is not None and len(self._map["poses"]) < 3:
                self._map["poses"].append(out.poses.detach().cpu())
            return out
        return pose_adam

    def _launch(self, name: str):
        def make(orig):
            sig = inspect.signature(orig)

            def launch(*args, **kw):
                if not self.profiling:
                    return orig(*args, **kw)
                i = len(self.launches)
                with self._span(f"slambench.k.{i}"):
                    out = orig(*args, **kw)
                with self._span("slambench.rec"):
                    self.launches.append(self._record(name, sig.bind(*args, **kw).arguments))
                return out
            return launch
        return make

    def _record(self, kind: str, a: dict) -> dict:
        """What launch_bounds needs of one launch, on the host: the slot
        reduce's widths, or the compositing launch's rows (xy, conic,
        opacity) and bins, copied once for launches on the same tensors."""
        rec = dict(kind=kind, phase=self.phase)
        if kind == "slot_reduce":
            return dict(rec, nc=a["rows"].shape[1] - 6, n_rows=int(a["n"]))
        packed, pg = a.get("packed", a.get("packed32")), a["pair_gauss"]
        last = self._last_inputs
        if last is None or last[0]() is not packed or last[1]() is not pg:
            host = dict(rows=packed[:, :6].float().cpu(), pair_gauss=pg.long().cpu(),
                        tile_start=a["tile_start"].long().cpu(),
                        tile_count=a["tile_count"].long().cpu())
            last = self._last_inputs = (weakref.ref(packed), weakref.ref(pg), host)
        return dict(rec, nc=int(a["nc"]), inputs=last[2])


def warm_tracking(slam) -> None:
    """One tracking call on frame 0 against the map frame 0 made, its pose
    thrown away: the loop's first tracking call pays one-time costs (some
    seconds on the card) that belong to set-up. Tracking changes nothing of
    the SLAM's state."""
    import mm3dgs_slam_torch.slam.slam as slam_mod

    color, depth, _, _, _ = slam.dataset[0]
    gt_color = slam._dev(np.transpose(color, (2, 0, 1)) / 255.0)
    gt_depth = slam._dev(depth[..., 0])
    slam_mod.track_frame(slam.gaussians.activated(), slam._dev(slam.estimate_pose_list[0]),
                         gt_color, gt_depth, slam._dev(np.zeros_like(depth[..., 0])),
                         slam.track_settings)


def end_to_end(peak_bytes: int, setup_s: float) -> dict:
    """name -> (value, unit): the peak allocated memory over frames 1 ..
    MEM_FRAMES (the same frames in every run, however many the window
    holds), the set-up's seconds. The window's rates, paced by one host
    thread whose speed swings between runs, stand per layer
    (metrics/loop_frames_per_s.py, loop_track_s_per_frame.py)."""
    return dict(peak_mem_gib=(peak_bytes / 2 ** 30, "GiB"), setup_s=(setup_s, "s"))


def host_reading() -> dict:
    """The host's state, read from /proc and this process: the whole
    machine's CPU jiffies (all, idle, steal), the 1-minute load, this
    process's CPU seconds and involuntary context switches."""
    import resource

    out = {}
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        out.update(jiffies=sum(v), idle=v[3] + v[4], steal=v[7] if len(v) > 7 else 0)
        with open("/proc/loadavg") as f:
            out["load1"] = float(f.read().split()[0])
    except OSError:
        pass
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out.update(cpu_s=ru.ru_utime + ru.ru_stime, ivcsw=ru.ru_nivcsw, t=time.perf_counter())
    return out


def host_delta(a: dict, b: dict) -> str:
    """One line of what the host did between two readings: this process's
    CPU seconds per wall second, the machine's busy and stolen shares of
    its CPUs' time, involuntary switches, the load, the CPUs allowed."""
    wall = max(b["t"] - a["t"], 1e-9)
    parts = [f"process cpu {(b['cpu_s'] - a['cpu_s']) / wall:.3f} s/s",
             f"ivcsw {b['ivcsw'] - a['ivcsw']}"]
    if "jiffies" in a and "jiffies" in b:
        dj = max(b["jiffies"] - a["jiffies"], 1)
        parts += [f"machine busy {1 - (b['idle'] - a['idle']) / dj:.4f}",
                  f"steal {(b['steal'] - a['steal']) / dj:.4f}",
                  f"load1 {a.get('load1')} -> {b.get('load1')}"]
    if hasattr(os, "sched_getaffinity"):
        parts.append(f"cpus {len(os.sched_getaffinity(0))} of {os.cpu_count()}")
    return ", ".join(parts)


def launch_bounds(launches: list, cam, device) -> list[dict]:
    """Each recorded launch's bound (bounds.launch_bound) from the work its
    rows and bins need. The slot reduce reads what the rows pass before it
    wrote, so it takes that pass's counts."""
    from . import bounds
    from . import reference as ref

    walks, out, last_rows = {}, [], None
    for rec in launches:
        kind, nc = rec["kind"], rec["nc"]
        if kind == "slot_reduce":
            b, by = bounds.launch_bound(kind, nc, last_rows, n_rows=rec["n_rows"])
        else:
            x = rec["inputs"]
            if id(x) not in walks:
                r = x["rows"].to(device)
                walks[id(x)] = ref.walk_counts(
                    r[:, 0:2], r[:, 2:5], r[:, 5],
                    ref.Bins(*(x[k].to(device) for k in ("pair_gauss", "tile_start",
                                                          "tile_count"))), cam)
            if kind == "composite_bwd_rows":
                last_rows = walks[id(x)]
            b, by = bounds.launch_bound(kind, nc, walks[id(x)])
        out.append(dict(kind=kind, phase=rec["phase"], nc=nc, bound_s=b, bound_by=by))
    return out


def _device_s_by_launch(events: dict, n: int) -> list[float]:
    """Device seconds of each recorded launch: the activities launched from
    inside its span."""
    from . import trace

    return [sum(d[1] - d[0] for d in trace.device_in(events, events["spans"].get(
        f"slambench.k.{i}", []))) * 1e-9 for i in range(n)]


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float | None = None, control: bool = False, witness: bool = False,
             mem_frames: int = MEM_FRAMES, log=print) -> dict:
    """One run: returns the result dict (correct, attempted, failed, metrics,
    device, breakdown, checks) and, under "readings", the check's numbers
    (with `control`, also the control's; with `witness`, the float64
    reference's tracking beside them). `mem_frames` 0 leaves the memory's
    frames after a short window unstepped (the check's readings alone)."""
    import torch

    from . import check, trace
    from . import scene as sc

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    conf, traffic = spec["config"], spec["traffic"]
    seed = int(seed) % (1 << 63)
    check_idx = CHECK_FRAMES[int(np.random.default_rng(seed).integers(len(CHECK_FRAMES)))]
    tmp = tempfile.mkdtemp(prefix="slambench-")
    probe = Probe(check_idx).install()
    synthetic = None
    try:
        # -- set-up: inputs from the seed, the SLAM, frame 0 --------------------
        from mm3dgs_slam_torch.data import synthetic as syn_mod
        from mm3dgs_slam_torch.slam.slam import SLAM

        if traffic["kind"] == "utmm":
            root = os.path.join(tmp, "input")
            cfg = slam_config(conf, traffic, seed, os.path.join(tmp, "out"), root)
            sc.write_utmm(os.path.join(root, "sequence"), traffic, cfg, seed, dev)
            scene = None
        else:
            cfg = slam_config(conf, traffic, seed, os.path.join(tmp, "out"))
            synthetic = sc.SyntheticSequence(traffic, loader_cam(cfg), seed, dev)
            scene = synthetic.scene
            probe._patch(syn_mod, "render_frame", lambda orig: synthetic.renderer())
        if cuda:   # the peak of the program's set-up, not of making the inputs
            torch.cuda.reset_peak_memory_stats(dev)
        probe.track_record = check.track_record(cfg)
        slam = SLAM(cfg, device, scene=scene)
        probe.frame = 0
        slam._step(0)
        warm_tracking(slam)
        slam._sync()
        setup_s = time.perf_counter() - t_start
        setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

        # -- the window -------------------------------------------------------------
        frames, prof_events, mem_peak, mem_rows = [], None, None, None
        host0 = host_reading()
        idx, t_w0 = 1, time.perf_counter()
        t_end = t_w0
        while idx < slam.n_img:
            profiled = traced and idx == PROFILED_FRAME
            tr0, mp0 = slam.tracking_time_sum, slam.mapper.mapping_time_sum
            t0 = time.perf_counter()
            probe.frame = idx
            if profiled:
                from torch.profiler import ProfilerActivity, profile

                probe.profiling = True
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                with profile(activities=acts) as prof:
                    slam._step(idx)
                    slam._sync()
                probe.profiling = False
            else:
                slam._step(idx)
                slam._sync()
            t_end = time.perf_counter()
            if idx == mem_frames:
                mem_rows = slam.n_gaussians()
                if cuda:
                    mem_peak = torch.cuda.max_memory_allocated(dev)
            frames.append(dict(idx=idx, wall_s=t_end - t0, profiled=profiled,
                               track_s=slam.tracking_time_sum - tr0,
                               map_s=slam.mapper.mapping_time_sum - mp0,
                               track_iters=slam.track_settings.iters,
                               map_iters=slam.mapper.num_iter))
            if profiled:
                t_read = time.perf_counter()
                prof_events = trace.read_events(prof)
                log(f"[slambench] trace read in {time.perf_counter() - t_read:.3f} s: events by "
                    f"kind {prof_events['kinds']}", file=sys.stderr)
                del prof
            log(f"[slambench] frame {idx}: {frames[-1]['wall_s']:.3f} s, tracking "
                f"{frames[-1]['track_s']:.3f} s, mapping {frames[-1]['map_s']:.3f} s, "
                f"{slam.n_gaussians()} rows, {len(slam.mapper.keyframes)} keyframes"
                f"{' (profiled)' if profiled else ''}", file=sys.stderr)
            idx += 1
            # a traced window holds the profiled frame and one before it
            if t_end - t_w0 >= seconds and not (traced and idx <= PROFILED_FRAME):
                break
        window_s = t_end - t_w0
        log(f"[slambench] set-up {setup_s:.3f} s, window {window_s:.3f} s over {len(frames)} "
            f"frames; host over the window: {host_delta(host0, host_reading())}",
            file=sys.stderr)
        if idx >= slam.n_img:
            log(f"[slambench] the window reached the sequence's end ({slam.n_img} frames) "
                f"after {window_s:.3f} s", file=sys.stderr)
        # after the window, untimed: on to the checked frame, and to the
        # memory's last frame where the window ended before it
        last = max(check_idx, mem_frames if cuda else 0)
        while idx <= min(last, slam.n_img - 1):
            probe.frame = idx
            slam._step(idx)
            slam._sync()
            if idx == mem_frames:
                mem_rows = slam.n_gaussians()
                if cuda:
                    mem_peak = torch.cuda.max_memory_allocated(dev)
            idx += 1
        if mem_peak is None:   # a CPU run, a traced run or a shorter sequence
            mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

        metrics = {}
        n = len(frames)
        e2e = end_to_end(mem_peak, setup_s)
        if not traced:
            for k in spec["end_to_end"]:
                metrics[k] = {"value": e2e[k][0], "unit": e2e[k][1]}
        device_info = dict(platform="gpu" if cuda else "cpu",
                           kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                           count=1, memory_peak_bytes=int(max(setup_peak, mem_peak)))

        breakdown = None
        if traced and prof_events is not None:
            cam = loader_cam(cfg)
            bounds_ = launch_bounds(probe.launches, cam, dev)
            dev_s = _device_s_by_launch(prof_events, len(bounds_))
            for b, d in zip(bounds_, dev_s):
                b["device_s"] = d
            summary = {}
            for b in bounds_:
                k = f"{b['phase']}.{b['kind']}.nc{b['nc']}.{b['bound_by']}"
                c, bs, ds = summary.get(k, (0, 0.0, 0.0))
                summary[k] = (c + 1, bs + b["bound_s"], ds + b["device_s"])
            log("[slambench] launches (count, bound s, device s): "
                + json.dumps(summary), file=sys.stderr)
            probe.launches = []
            spans = {k: v for k, v in prof_events["spans"].items() if k in (
                "slambench.track", "slambench.map")}
            phases = {}
            for ph in ("track", "map"):
                evs = trace.device_in(prof_events, spans.get(f"slambench.{ph}", []))
                phases[ph] = dict(n_ops=len(evs), busy_s=trace.busy_union_ns(evs) * 1e-9)
            loops = trace.device_in(prof_events, spans.get("slambench.track", [])
                                    + spans.get("slambench.map", []))
            ctx = dict(frames=frames, phases=phases, launches=bounds_,
                       loops_busy_s=trace.busy_union_ns(loops) * 1e-9, map_rows=mem_rows)
            for name in spec["per_layer"]:
                if not cuda and spec["sources"][name] == "device_trace":
                    continue   # no device number from a CPU run
                v = metric_reader(name)(ctx)
                if v is not None:
                    metrics[name] = {"value": v, "unit": spec["units"][name]}
            prof_frame = [f for f in frames if f["profiled"]][0]
            device_info.update(busy_s=trace.busy_union_ns(prof_events["device"]) * 1e-9,
                               window_s=prof_frame["wall_s"])
            breakdown = dict(device_ops=trace.top_device_ops(prof_events["device"]),
                             idle_gaps=trace.idle_gaps(prof_events["device"],
                                                       prof_events["host"]))
            prof_events = None

        # -- the check, once the program's state is freed ---------------------
        slam._frames.close()
        n_img = slam.n_img
        del slam
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        n_in = min(check_idx + 1, n_img)   # the frames the checked frame can have seen
        if synthetic is not None:
            inputs = check.Inputs(synthetic.cam, [synthetic.gt_color_depth(i)
                                                  for i in range(n_in)], synthetic.w2c[0])
        else:
            inputs = check.Inputs(loader_cam(cfg), check.utmm_frames(
                os.path.join(root, "sequence"), cfg, n_in), np.eye(4, dtype=np.float32))
        t_check = time.perf_counter()
        readings = check.compare(probe.cap, inputs, cfg, dev, control=control, witness=witness)
        log(f"[slambench] check of frame {check_idx}: {time.perf_counter() - t_check:.3f} s",
            file=sys.stderr)
        ok, rows = check.judge(readings["program"], spec["limits"], check.numbers_for(cfg))
        result = dict(correct=bool(ok), attempted=n, failed=0 if ok else 1, metrics=metrics,
                      device=device_info)
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
        result["readings"] = readings
        result["check_frame"] = check_idx
        return result
    finally:
        probe.uninstall()
        shutil.rmtree(tmp, ignore_errors=True)

