#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (mm3dgs_slam_torch) on one card.

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero):
  1. device: the card's name and count, and nvidia-smi's name/power limit;
  2. build: the three CUDA kernels from the sources in this checkout;
  3. kernels against their plain PyTorch versions at 640x480, on a map seeded
     from the first synthetic_tum frame (one Gaussian per pixel) seen from
     the second frame's pose: kernel 1 at nc 3/5/6 on black and white
     backgrounds, kernel 2's dpacked, kernel 3's per-tile partials, dq and dT;
     each kernel's count of (tile, pair, warp box)s its per-warp cull keeps
     against the plain count; times from CUDA events, bounds from the walk's
     counts in this data;
  4. the main path: the CLI's code path (`python -m mm3dgs_slam_torch
     --config configs/synthetic_tum.yml`) at full width with the frame count
     cut to a few, launch counts reset just before and read just after;
     results.npz keys, every kernel launched, ATE < 0.03 m, PSNR > 17 dB.
Then one JSON line per the kernels, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
It needs CUDA and the repository around it; without either it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_FRAMES = 5
H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA data sheet (SXM)
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
# The least f32 arithmetic each function needs (comparisons not counted, an
# exp counted as one), from the walk's counts in this run's data (plain
# composite_fwd_plain(count_work=True)). Any exact walk must evaluate the
# pixel-pairs a pixel uses and the one it stops on: each forms dx, dy and the
# conic quadratic (11). The other tested pixel-pairs are skipped, and a cull
# (the kernels' per-warp one) need not evaluate them, so they are not
# charged. A used pixel-pair adds exp, the opacity product and the clamp (3),
# T (2) and w (1), then per function:
OPS_TEST = 11
# forward: acc += w f over nc channels
OPS_FWD_USE = lambda nc: 6 + 2 * nc                           # noqa: E731
# mapping backward: f.dC (2nc), A (2), dalpha (5), dop and dpower (2), the
# xy and conic gradients (13), the feature gradients (nc), and each of the
# 6 + nc field gradients summed over the tile's pixels (then 6 + nc adds
# into dpacked per used (tile, pair))
OPS_BWD_USE = lambda nc: 34 + 4 * nc                          # noqa: E731
# pose backward: as the mapping backward up to the xy and conic gradients,
# then dz (1, or 2 at nc 6) and the 6 (or 7) field gradients summed over
# pixels; the d(mean_cam) contraction, outer product with the world mean and
# the 12 sums are needed once per (tile, pair), after the pixel reduction
OPS_POSE_USE = lambda nc: 35 + 2 * nc + (2 if nc == 6 else 0)  # noqa: E731
OPS_POSE_PAIR = lambda nc: 53 + (2 if nc == 6 else 0)          # noqa: E731
# per pixel, before the backward walks: C.dC (2nc) and dT_fin T_fin (1)
OPS_PIX_BWD = lambda nc: 2 * nc + 1                           # noqa: E731
IMG_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-3)
PARTIAL_ATOL = 1e-5     # of sum |term| per kernel-3 partial (~170 f32 epsilons)
POSE_TOL = dict(atol=1e-4, rtol=5e-4)   # dq, dT: rtol 5e-4 with a tiny atol


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call of fn over reps calls, CUDA events, after warm calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(n_bytes: float, n_ops: float):
    tb, to = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_violation(got, want, atol, rtol):
    """(max |got - want|, whether every entry is within atol + rtol |want|)."""
    import torch

    err = torch.abs(got - want)
    return float(err.max()), bool((err <= atol + rtol * torch.abs(want)).all())


def check_work(name, counter, work):
    """A kernel's work counter [kept, walked] against the plain count."""
    kept, walked = counter.tolist()
    ok = kept == work["warp_pairs"] and walked <= kept
    print(f"[check] {name} work: {kept} (tile, pair, warp box)s kept by the cull, plain "
          f"warp_pairs {work['warp_pairs']} ({'ok' if ok else 'FAIL'}); {walked} (warp, pair)s "
          f"walked", flush=True)
    if not ok:
        fail(f"{name}: {kept} boxes kept (plain warp_pairs {work['warp_pairs']}), "
             f"{walked} walked")
    return kept, walked


def check_scene(cfg, device):
    """Frame 0 of the config's synthetic sequence seeded one Gaussian per
    pixel, projected and binned from frame 1's pose: (activated map, frame
    1's pose, render settings, packed rows [N, 16], bins)."""
    import torch

    from mm3dgs_slam_torch.data.synthetic import SyntheticDataset
    from mm3dgs_slam_torch.models import gaussians as G
    from mm3dgs_slam_torch.ops.binning import build_bins
    from mm3dgs_slam_torch.ops.camera import Camera
    from mm3dgs_slam_torch.ops.pose import w2c_to_pose
    from mm3dgs_slam_torch.ops.render import RenderSettings, project_for_pose
    from mm3dgs_slam_torch.slam.map_ops import new_gaussian_candidates

    cfg = dict(cfg, synthetic=dict(cfg["synthetic"], n_frames=2))
    ds = SyntheticDataset(cfg, desired_height=cfg["desired_height"],
                          desired_width=cfg["desired_width"], device=device)
    rs = RenderSettings(cam=Camera(*ds.cam))
    color, depth, _, c2w0, _ = ds[0]
    c2w1 = ds[1][3]
    gt_color = torch.as_tensor(color.transpose(2, 0, 1) / 255.0, device=device)
    gt_depth = torch.as_tensor(depth[..., 0], device=device)
    pose0 = w2c_to_pose(torch.as_tensor(np.linalg.inv(c2w0), device=device))
    pose1 = w2c_to_pose(torch.as_tensor(np.linalg.inv(c2w1), device=device))
    empty = G.empty_map(0, device)
    stats = new_gaussian_candidates(empty.activated(), pose0, gt_color, gt_depth, rs, True)
    m, _, _ = G.append_gaussians(empty, G.init_adam(empty), stats.candidates)
    g = m.activated()
    with torch.no_grad():
        proj = project_for_pose(g, pose1, rs)
        bins = build_bins(proj, rs.cam)
    return g, pose1, rs, proj.packed.contiguous(), bins


def check_kernels(cfg, device):
    """Phase 3: each kernel against its plain version; returns the rows of
    the kernels line (launches filled in later)."""
    import torch

    from mm3dgs_slam_torch.ops import composite as plain
    from mm3dgs_slam_torch.ops import kernels
    from mm3dgs_slam_torch.ops.projection import conic_pose_jacobian_rows
    from mm3dgs_slam_torch.ops.render import (background, means_cam_soa,
                                              pose_grads_from_partials)

    g, pose1, rs, packed, bins = check_scene(cfg, device)
    n, n_pairs, n_tiles = packed.shape[0], bins.pair_gauss.shape[0], rs.cam.n_tiles
    # the bounds' bytes: each function reads the 6 + nc fields it uses (kernel
    # 3 also the 12 pose columns) of the rows of the Gaussians in some pair
    n_seen = int(torch.unique(bins.pair_gauss).numel())
    print(f"[check] scene: {n} gaussians (frame 0 seeded, one per pixel) at "
          f"{rs.cam.width}x{rs.cam.height}, {n_tiles} tiles, {n_pairs} pairs of "
          f"{n_seen} gaussians, max {int(bins.tile_count.max())} per tile", flush=True)
    args = (bins.pair_gauss, bins.tile_start, bins.tile_count, rs.cam)
    gen = torch.Generator(device=device).manual_seed(0)
    new_work = lambda: torch.zeros(2, dtype=torch.int64, device=device)  # noqa: E731
    rows = []

    # kernel 1 at nc 3, 5, 6 on black and white backgrounds
    worst, ok_all, t_k, t_p = 0.0, True, {}, {}
    for nc in (3, 5, 6):
        counter = new_work()
        acc_k, tfin_k = kernels.composite_fwd(packed, *args, nc, work=counter)
        acc_p, tfin_p, work = plain.composite_fwd_plain(packed, *args, nc, count_work=True)
        for white in (False, True):
            bg = background(rs._replace(white_background=white), device)[:nc][None, :, None]
            err, ok = max_violation(acc_k + tfin_k * bg, acc_p + tfin_p * bg, **IMG_TOL)
            worst, ok_all = max(worst, err), ok_all and ok
            print(f"[check] kernel 1 nc={nc} {'white' if white else 'black'}: "
                  f"max abs err {err:.3e} ({'ok' if ok else 'FAIL'})", flush=True)
        kept, walked = check_work(f"kernel 1 nc={nc}", counter, work)
        t_k[nc] = cuda_ms(lambda: kernels.composite_fwd(packed, *args, nc), 20)
        t_p[nc] = cuda_ms(lambda: plain.composite_fwd_plain(packed, *args, nc), 1, warm=0)
    used, stops, pairs_used = work["used"], work["stops"], work["pairs_used"]
    evaluated = used + stops
    print(f"[check] walk: {work['tested']} pixel-pairs tested by the reference walk, {used} "
          f"used, {stops} stops; {work['pairs_walked']} (tile, pair)s walked, {pairs_used} "
          f"used; (warp, pair)s: {8 * work['pairs_walked']} without a cull, {kept} kept by "
          f"the cull (warp_pairs), {walked} walked, {work['warp_pairs_min']} at least "
          f"(a pixel of the box uses or stops on the pair)", flush=True)
    n_pix = n_tiles * 256
    nc = 5  # the tracking width, the main path's most frequent launch
    fwd_bytes = 4 * (n_seen * (6 + nc) + n_pairs + 2 * n_tiles + n_pix * (nc + 1))
    b, by = bound_ms(fwd_bytes, evaluated * OPS_TEST + used * OPS_FWD_USE(nc))
    print(f"[check] kernel 1 times at nc=3/5/6: kernel {t_k[3]:.4f}/{t_k[5]:.4f}/{t_k[6]:.4f} "
          f"ms, plain {t_p[3]:.1f}/{t_p[5]:.1f}/{t_p[6]:.1f} ms; bound at nc=5 {b:.4f} ms "
          f"({by})", flush=True)
    if not ok_all:
        fail("kernel 1 disagrees with its plain version")
    rows.append(dict(name="composite_fwd", route="cuda",
                     source="mm3dgs_slam_torch/csrc/composite_fwd.cu",
                     replaces="mm3dgs_slam_tpu/ops/pallas_composite.py:368",
                     max_abs_err=worst, ms=t_k[nc], plain_ms=t_p[nc], bound_ms=b,
                     bound_by=by, library_ms=None))

    # kernel 2: dpacked for loss = sum(w * acc) + sum(w_t * tfin), w ~ N(0, 1)
    nc = 3  # the mapping width
    acc, tfin = kernels.composite_fwd(packed, *args, nc)
    dacc = torch.randn(acc.shape, generator=gen, device=device)
    dtfin = torch.randn(tfin.shape, generator=gen, device=device)
    gargs = (packed, *args[:3], acc, tfin, dacc, dtfin, rs.cam, nc)
    counter = new_work()
    d_k = kernels.composite_bwd(*gargs, work=counter)
    d_p = plain.composite_bwd_plain(*gargs)
    scale = float(d_p.abs().max())
    err, ok = max_violation(d_k, d_p, **GRAD_TOL)
    check_work(f"kernel 2 nc={nc}", counter, work)
    tk = cuda_ms(lambda: kernels.composite_bwd(*gargs), 10)
    tp = cuda_ms(lambda: plain.composite_bwd_plain(*gargs), 1, warm=0)
    # out: the 6 + nc gradient fields of every row (the rest of dpacked is zero)
    bwd_bytes = 4 * (n_seen * (6 + nc) + n_pairs + 2 * n_tiles
                     + n_pix * (2 * nc + 2) + n * (6 + nc))
    b, by = bound_ms(bwd_bytes, n_pix * OPS_PIX_BWD(nc) + evaluated * OPS_TEST
                     + used * OPS_BWD_USE(nc) + pairs_used * (6 + nc))
    print(f"[check] kernel 2 nc={nc}: dpacked max abs err {err:.3e} (max |dpacked| "
          f"{scale:.3e}) ({'ok' if ok else 'FAIL'}); kernel {tk:.4f} ms, "
          f"plain {tp:.1f} ms, bound {b:.4f} ms ({by})", flush=True)
    if not ok:
        fail("kernel 2 disagrees with its plain version")
    rows.append(dict(name="composite_bwd", route="cuda",
                     source="mm3dgs_slam_torch/csrc/composite_bwd.cu",
                     replaces="mm3dgs_slam_tpu/ops/pallas_composite.py:626",
                     max_abs_err=err, ms=tk, plain_ms=tp, bound_ms=b, bound_by=by,
                     library_ms=None))

    # kernel 3: the per-tile partials, then dq and dT, at the tracking width
    nc = 5
    with torch.no_grad():
        packed32 = torch.cat([packed, conic_pose_jacobian_rows(
            means_cam_soa(g.xyz, pose1), g.scales, g.rotations, g.xyz, rs.cam)], 1).contiguous()
        acc, tfin = kernels.composite_fwd(packed32, *args, nc)
    dacc = torch.randn(acc.shape, generator=gen, device=device)
    dtfin = torch.randn(tfin.shape, generator=gen, device=device)
    pargs = (packed32, *args[:3], acc, tfin, dacc, dtfin, rs.cam, nc)
    counter = new_work()
    psum_k = kernels.composite_pose_bwd(*pargs, work=counter)
    psum_p, asum_p = plain.composite_pose_bwd_plain(*pargs, abs_sum=True)
    # A tile's 12 partials are sums over its pixel-pairs that cancel heavily
    # (the line below prints by how much), so float sums in another order
    # differ in proportion to the terms, not to the result: the atol is
    # PARTIAL_ATOL of sum |term|, the rtol the gradient one.
    err_t, ok_t = max_violation(psum_k, psum_p, atol=PARTIAL_ATOL * asum_p,
                                rtol=GRAD_TOL["rtol"])
    rel_t = float(((psum_k - psum_p).abs() / asum_p.clamp_min(1e-30)).max())
    cancel = float((asum_p / psum_p.abs().clamp_min(1e-30)).max())
    gk = torch.cat(pose_grads_from_partials(psum_k, pose1[:4]))
    gp = torch.cat(pose_grads_from_partials(psum_p, pose1[:4]))
    err, ok = max_violation(gk, gp, **POSE_TOL)
    kept, walked = check_work(f"kernel 3 nc={nc}", counter, work)
    tk = cuda_ms(lambda: kernels.composite_pose_bwd(*pargs), 10)
    tp = cuda_ms(lambda: plain.composite_pose_bwd_plain(*pargs), 1, warm=0)
    pose_bytes = 4 * (n_seen * (6 + nc + 12) + n_pairs + 2 * n_tiles
                      + n_pix * (2 * nc + 2) + n_tiles * 12)
    b, by = bound_ms(pose_bytes, n_pix * OPS_PIX_BWD(nc) + evaluated * OPS_TEST
                     + used * OPS_POSE_USE(nc) + pairs_used * OPS_POSE_PAIR(nc))
    print(f"[check] kernel 3 nc={nc}: per-tile partials [{n_tiles}, 12] max abs err "
          f"{err_t:.3e}, at most {rel_t:.3e} of sum |term| (max |partial| "
          f"{float(psum_p.abs().max()):.3e}, sum |term| up to {cancel:.3e}x |partial|) "
          f"({'ok' if ok_t else 'FAIL'}); dq {gk[:4].tolist()} vs plain {gp[:4].tolist()}, "
          f"dT {gk[4:].tolist()} vs plain {gp[4:].tolist()}; max abs err {err:.3e} "
          f"({'ok' if ok else 'FAIL'}); {kept} boxes kept, {walked} (warp, pair)s walked; "
          f"kernel {tk:.4f} ms, plain {tp:.1f} ms, bound {b:.4f} ms ({by})", flush=True)
    if not (ok_t and ok):
        fail("kernel 3 disagrees with its plain version")
    rows.append(dict(name="composite_pose_bwd", route="cuda",
                     source="mm3dgs_slam_torch/csrc/composite_pose_bwd.cu",
                     replaces="mm3dgs_slam_tpu/ops/pallas_composite.py:858",
                     max_abs_err=max(err_t, err), ms=tk, plain_ms=tp, bound_ms=b,
                     bound_by=by, library_ms=None))
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not ((ROOT / "mm3dgs_slam_torch" / "csrc").is_dir()
            and (ROOT / "configs" / "synthetic_tum.yml").is_file()):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mm3dgs_slam_torch.__main__ import run
    from mm3dgs_slam_torch.config import load_config
    from mm3dgs_slam_torch.ops import kernels

    # phase 1: device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name}, {count} device(s); nvidia-smi: {smi}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    device = torch.device("cuda", 0)

    # phase 2: build
    t0 = time.perf_counter()
    kernels.build_kernels()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {len(kernels.KERNELS)} kernels "
          f"(nvcc in parallel)", flush=True)
    for k in kernels.KERNELS:
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k.source}: {line.strip()}")

    cfg = load_config(str(ROOT / "configs" / "synthetic_tum.yml"))
    cfg["synthetic"]["n_frames"] = N_FRAMES

    # phase 3: kernels against their plain versions
    rows = check_kernels(cfg, device)

    # phase 4: the main path, the CLI's code path
    with tempfile.TemporaryDirectory() as out:
        cfg["outputdir"] = out
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        slam = run(cfg, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        if slam.failed is not None:
            fail(f"the SLAM run failed: {slam.failed!r}")
        r = np.load(Path(out) / "results.npz", allow_pickle=True)
        keys = {"pose_est", "pose_gt", "keyframes", "ate_rmse", "psnr_list", "ssim_list",
                "lpips_list", "lpips_proxy_list", "avg_tracking_it_time",
                "avg_mapping_it_time", "avg_rendering_time", "binning_overflow_frames"}
        if set(r.files) != keys:
            fail(f"results.npz keys {sorted(r.files)} != {sorted(keys)}")
        ate, psnr = float(r["ate_rmse"]), float(np.mean(r["psnr_list"]))
        frames_s = len(slam.frame_seconds) / sum(slam.frame_seconds)
        print(f"[main] synthetic_tum {cfg['desired_width']}x{cfg['desired_height']}, "
              f"{N_FRAMES} frames, {cfg['tracking']['iters']}/{cfg['mapping']['iters']} "
              f"iterations: ATE {ate:.6f} m, PSNR {psnr:.3f} dB, "
              f"{float(r['avg_tracking_it_time']):.3f} ms/tracking iteration, "
              f"{float(r['avg_mapping_it_time']):.3f} ms/mapping iteration, "
              f"{frames_s:.4f} frames/s (frame loop), run {wall:.1f} s, "
              f"{slam.gaussians.n} gaussians, max memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}",
              flush=True)
        if not all(launches[k["name"]] > 0 for k in rows):
            fail(f"a kernel of the main path was never launched: {launches}")
        if not (ate < 0.03 and psnr > 17.0):
            fail(f"quality gates: ATE {ate} (< 0.03), PSNR {psnr} (> 17)")
    for k in rows:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
