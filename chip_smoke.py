#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (mm3dgs_slam_torch) on one card.

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero):
  1. device: the card's name and count, and nvidia-smi's name/power limit;
  2. build: the four CUDA sources in this checkout (kernel 2's source holds
     its two passes);
  3. kernels against their plain PyTorch versions at 640x480, on a map seeded
     from phase 4's first frame (synthetic_tum on the JAX package's scene,
     one Gaussian per pixel) seen from its second frame's pose: kernel 1 at nc 3/5/6 on black and white
     backgrounds; kernel 2 launched twice, its per-slot rows and dpacked the
     same bits both times, the rows against the plain first pass and
     dpacked against the plain passes (GRAD_TOL), dpacked bit-equal to the
     plain reduce of the kernel's rows, each pass timed alone and both
     together, the slot table's segment lengths (slots per Gaussian: mean,
     p99, max); kernel 3's per-tile partials, dq and dT;
     each kernel's count of (tile, pair, warp box)s its per-warp cull keeps
     against the plain count; times from CUDA events with the card held
     busy while the host queues the timed calls, bounds from the walk's
     counts in this data; the host wall time of one rebin (projection and
     binning); then the slot reduce on the mapping bins the bench times
     (bench.build_scene's 131,072 Gaussians at the identity pose): its
     segment lengths, bit-equal to its second launch and the plain reduce,
     its time beside index_add_'s and its bound; last, kernel 4 (tracking's
     pose rows [N, 32]) on the same map at frame 1's pose (~307k rows):
     columns 0-15 within IMG_TOL of its plain version, the conic Jacobian
     16-24 within GRAD_TOL, 25-31 equal, its time beside its bytes bound and
     the plain version's;
  3b. the same checks at UTMM.yml's 640x330 (the last tile row partial), on
     the first frame of the UT-MM sequence of phase 5 seeded one Gaussian per
     pixel and seen from its second frame: kernel 1 at nc 4 and 5, kernel 2
     at nc 4 (mapping with the depth-estimate loss), kernel 3 at nc 5,
     kernel 4 under UTMM.yml's force_isotropic (scale column 0 for all three);
  3c. the same at replica.yml's 600x340 (37.5 x 21.25 tiles: the last tile
     column 8 pixels wide, the last row 4 high), on the Replica-layout
     sequence of phase 10: kernel 1 at nc 3, 4 and 5, kernel 2 at nc 4 (the
     width replica.yml maps at: its mapping.use_depth_estimate_loss is on),
     kernel 3 at nc 5, kernel 4;
  3d. the three kernels over the tile windows of 2 and 7 ranks (the
     tile-sharded render's launches: grid n_local, tile tile_lo + block) on
     phase 3's scene: every window against its windowed plain version (kernel
     2 launched twice, the same bits), the windows stitched against the
     whole-grid launch, each window launch's time beside its bound;
  4. the main path: the port's golden runner's config and run (`python -m
     mm3dgs_slam_torch.scripts.run_golden --scene
     mm3dgs_slam_torch/assets/jax_scene_synthetic_tum.npz --decomp`, the
     CLI's `run`) on configs/synthetic_tum.yml and the JAX package's own
     scene of it, at full width with the frame count cut to a few, launch
     counts reset just before and read just after; results.npz keys (with
     the frame decomposition's), every kernel launched, ATE < 0.03 m, PSNR >
     17 dB, and the per-frame wall decomposition (its table printed, each
     frame's phases within its wall time);
  5. the UT-MM path: a UT-MM-format sequence of 10 frames written at
     UTMM.yml's native 1280x660 from the synthetic scene (frames by the
     oracle, groundtruth in the robot frame, tf.txt, a 100 Hz IMU stream from
     the trajectory), then the CLI's code path on configs/UTMM.yml (640x330,
     stride 2, IMU seed, Pearson terms, isotropic splats) with inputdir,
     scene, outputdir changed and the timing switch debug.get_runtime_stats
     on; every frame after frame 0 seeded by the IMU model, and from frame 2
     on the IMU seed closer to GT than the zero-velocity seed; every kernel
     launched, ATE < 0.03 m, PSNR > 17 dB;
  5b. the same with the IMU pose prior on (tracking.use_imu_loss at
     tests/test_e2e_imu.py's weights; UTMM.yml leaves it off), 3 frames
     read: the gates of 5, and the frame that, tracked again from its seed on
     the final map without the prior, ends farthest from it, ending nearer
     the seed with the prior than without;
  6. the monocular path: configs/synthetic_tum.yml (3 frames) with
     use_gt_depth false, the synthetic_affine estimator and the
     depth-estimate loss on in tracking and mapping; every kernel launched,
     ATE < 0.06 m, PSNR > 15 dB (tests/test_e2e_mono.py's gates);
  7. splatam: configs/synthetic_tum.yml (5 frames, phase 4's scene) with method splatam and
     debug.create_video on; kernel 3 launched at nc 6 and kernel 2 at nc 4,
     the keyframes {0, 1, 3}, ATE < 0.03 m, PSNR > 17 dB, and the mp4 read
     back with cv2: one 2x3-panel frame per tracked frame;
  8. bundle adjustment: configs/synthetic_tum.yml (5 frames, phase 4's scene) with
     mapping.do_BA and save_iterations [3]; ATE < 0.03 m, PSNR > 17 dB, the
     window poses finite, an earlier keyframe moved by BA (nonzero, below
     0.05 m and 0.05 rad), the mapping rebins and ms/iteration beside phase
     4's; then the port resumed from that checkpoint (poses as saved, the
     keyframe count, a finite evaluation) and the LPIPS proxy of one frame
     on the card against the CPU (relative 1e-4);
  9. TUM: a TUM-layout sequence (rgb/, depth/, rgb.txt, depth.txt,
     groundtruth.txt) of the synthetic scene written at TUM.yml's native
     640x480, then the CLI's code path on configs/TUM.yml (monocular, with
     TinyDPT on assets/tiny_dpt_synthetic.npz in place of MiDaS, crop_edge 8,
     the tum_heuristic depth anchor, the depth-estimate loss in mapping),
     3 frames; every kernel launched, ATE < 0.06 m, PSNR > 15 dB; and the
     data's ceiling PSNR of each frame the loader returns (against the
     oracle's render of the writing scene at the loader's camera and GT
     pose; synthetic_recorded.ceiling_psnr, computed on the CPU in a child
     process while the sequences are written);
 10. Replica: a Replica-layout sequence (JPEG frames, depth PNGs, traj.txt)
     written at replica.yml's native 1200x680, then the CLI's code path on
     configs/replica.yml (600x340, GT depth) with debug.save_keyframes on,
     5 frames; every kernel launched, ATE < 0.03 m, PSNR > 17 dB; its
     ceiling PSNR as phase 9's (after the resize to 600x340);
 11. the eval CLIs on phase 10's output: eval_traj's ATE equal to
     results.npz's (1e-6 m), eval_image's re-render from the saved map on the
     card within 0.01 dB of results.npz's mean PSNR, and one keyframe PNG per
     keyframe within 1 level of its GT colour;
 12. the bench: `python -m mm3dgs_slam_torch.bench` (its kernel check, then
     5 + 2 reps of 100 tracking and 150 mapping iterations on 131,072
     Gaussians at 640x480), its JSON line echoed, a positive frames/s, the
     card's name and power limit in it, every kernel launched in its calls;
 13. the tools on phase 4's output: train_tiny_dpt for 50 steps on the card
     on its frames (the loss falls; the weights load and give a finite
     depth), a PLY save and load of its map (bit-equal; whether the native
     codec ran), capture and restore of its map and Adam state (bit-equal),
     and one offline visualizer view rendered on the card;
 14. the sharded map (run right after phase 4, whose run it is held to):
     `torchrun --standalone --nproc_per_node 2 -m
     mm3dgs_slam_torch.scripts.run_golden --mesh-devices 2` on
     configs/synthetic_tum.yml and phase 4's scene, 3 frames, the two ranks
     sharing the card over gloo; each rank's rows, windowed launches and
     ms/iteration printed; ATE < 0.03 m, PSNR > 17 dB, within 5e-3 m and
     1 dB of phase 4 over the same frames, both ranks' poses bit-equal;
 15. determinism: phase 4's and phase 8's runs again, each through run_golden
     in a fresh process (the two at once, started after phase 3d and done
     before phase 3b, while the TUM, Replica and UT-MM sequences are written
     and no time is read); at the end, results.npz's pose_est, psnr_list,
     ssim_list, lpips_proxy_list and ate_rmse equal and the PLY files
     byte-equal to phases 4's and 8's (both runs' ATE and PSNR printed);
 16. configs/synthetic.yml, the repo's own config (120x160, 8 frames, 40/60
     iterations, rebin_every 1, NIQE keyframes), on the JAX package's scene
     of it (mm3dgs_slam_torch/assets/jax_scene_synthetic.npz): the five
     launches against their plain versions on its frames 0 and 1 (kernel 1
     at nc 3, 5 and 6, kernel 2's rows and reduce at nc 3, kernel 3 at nc 5,
     kernel 4; 80 tiles, under one wave of the card's SMs), then the whole config
     through the CLI's `run` with mapping.do_BA off and then on: ATE < 0.03
     m and PSNR > 17 dB each, each run's drift from GT per frame, both ATEs
     and their ratio printed on one `[synthetic]` line beside phases 8 /
     4's; then the lockstep: the JAX package's whole state after frame 4 of
     the BA run (mm3dgs_slam_torch/assets/jax_state_synthetic_ba_f4.npz)
     restored into a port SLAM on the card, which steps frame 5, and so does
     one with fx and fy one float32 ulp up; the `[synthetic lockstep f5]`
     table holds each beside JAX's frame-5 record (tests/lockstep.py): the
     keyframe decision, the keyframe and the BA window must be JAX's, the
     frame's poses within LOCKSTEP_POSE_ATOL of JAX's.
Phase 3 also holds kernel 3 at nc 6 (splatam tracking) and bundle
adjustment's pose gradient (kernel 2's dpacked chained through the
projection into the pose) against the plain chain; every path's
lpips_proxy_list must be finite. Then one JSON line per the kernels
(launches from phase 4, with each path's counts and the 640x330, 600x340,
120x160 and nc 6 checks beside them), the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
It needs CUDA and the repository around it; without either it exits non-zero
and prints no result.
"""
from __future__ import annotations

import copy
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_FRAMES = 5             # synthetic_tum frames of phases 4, 7 and 8
SHORT_FRAMES = 3         # frames read in phases 5b and 6 (the script's time limit)
UTMM_FRAMES = 10         # written; UTMM.yml's stride 2 reads 5
UTMM_GAUSSIANS = 20000   # the UT-MM sequence's scene (synthetic_tum.yml's count)
RECORDED_GAUSSIANS = 20000   # the TUM and Replica sequences' scene (as UT-MM's)
REPLICA_FRAMES = 5       # written and read in phase 10
# phase 16's lockstep: the largest gap of frame 5's poses to JAX's record
# (PERF.md, PR 12: 3x the larger one-ulp pose gap of the CPU lockstep,
# JAX's 1.849e-4; the port's CPU frame 5 lay 3.41e-5 from JAX's)
LOCKSTEP_POSE_ATOL = 5.5e-4
IMU_PRIOR_WEIGHTS = dict(imu_T_weight=0.5, imu_q_weight=0.5)   # tests/test_e2e_imu.py's
H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA data sheet (SXM)
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
HOLD_CYCLES = 1_000_000         # ~0.5 ms of the card's clock per timed call (cuda_ms)
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


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call of fn over reps calls, CUDA events, after warm calls.
    The card is held busy (torch.cuda._sleep, HOLD_CYCLES a call) while the
    host queues the calls, so that a call that takes the card less time
    than its wrapper takes the host (the slot reduce, index_add_) is timed
    by the card, not by the host."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES * reps)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean host wall ms per call of fn over reps calls, the card synchronized
    before and after (for host-synchronizing code such as build_bins)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float):
    tb, to = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_violation(got, want, atol, rtol):
    """(max |got - want|, whether every entry is within atol + rtol |want|)."""
    import torch

    err = torch.abs(got - want)
    return float(err.max()), bool((err <= atol + rtol * torch.abs(want)).all())


def check_work(name, counter, work, tag="check"):
    """A kernel's work counter [kept, walked] against the plain count."""
    kept, walked = counter.tolist()
    ok = kept == work["warp_pairs"] and walked <= kept
    print(f"[{tag}] {name} work: {kept} (tile, pair, warp box)s kept by the cull, plain "
          f"warp_pairs {work['warp_pairs']} ({'ok' if ok else 'FAIL'}); {walked} (warp, pair)s "
          f"walked", flush=True)
    if not ok:
        fail(f"{name}: {kept} boxes kept (plain warp_pairs {work['warp_pairs']}), "
             f"{walked} walked")
    return kept, walked


def segment_stats(slots, n: int, tag: str) -> dict:
    """Slots per Gaussian of a slot table (its segment lengths) over the
    Gaussians that have any, printed: their count, mean, p99 and max."""
    import torch

    c = slots.gauss_start[1:] - slots.gauss_start[:-1]
    h = c[c > 0].double()
    seg = dict(gaussians=int(h.numel()), mean=float(h.mean()),
               p99=float(torch.quantile(h, 0.99)), max=int(h.max()))
    print(f"[{tag}] slot segments: {seg['gaussians']} of {n} gaussians have slots; slots per "
          f"gaussian mean {seg['mean']:.3f}, p99 {seg['p99']:.0f}, max {seg['max']}", flush=True)
    return seg


def synthetic_frames(cfg, device, scene):
    """Frames 0 and 1 of the config's synthetic sequence rendered from the
    scene .npz at `scene`, and its camera: the main path's own first two
    frames (reuse_synthetic_frames hands phase 4 the same renders)."""
    from mm3dgs_slam_torch.data.synthetic import SyntheticDataset, load_scene

    ds = SyntheticDataset(cfg, desired_height=cfg["desired_height"],
                          desired_width=cfg["desired_width"], device=device,
                          scene=load_scene(scene))
    return ds[0], ds[1], ds.cam


def dataset_frames(cfg):
    """Frames 0 and 1 of the config's recorded sequence through the port's
    loader at the config's size, and the camera from its intrinsics."""
    from mm3dgs_slam_torch.data import get_dataset_type
    from mm3dgs_slam_torch.ops.camera import Camera

    ds = get_dataset_type(cfg["dataset"])(cfg, cfg["inputdir"], cfg["scene"],
                                          stride=cfg["stride"],
                                          desired_height=cfg["desired_height"],
                                          desired_width=cfg["desired_width"])
    f0, f1 = ds[0], ds[1]
    K = f0[2]
    return f0, f1, Camera(cfg["desired_height"], cfg["desired_width"], float(K[0, 0]),
                          float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))


def reuse_synthetic_frames():
    """Phases 4, 7 and 8 read one synthetic sequence (synthetic_tum.yml's
    scene and camera path), which SyntheticDataset renders with the oracle
    at ~10 s a frame for 20,000 Gaussians: render each distinct frame once
    (keyed by the scene's arrays, the pose and the render settings) and hand
    the later runs the same arrays."""
    import hashlib

    from mm3dgs_slam_torch.data import synthetic

    inner, memo = synthetic.render_frame, {}

    def render_frame(scene, w2c, rs):
        h = hashlib.sha1(repr(rs).encode())
        for a in (*scene, w2c):
            h.update(np.ascontiguousarray(a.cpu().numpy() if hasattr(a, "cpu") else a).tobytes())
        key = h.hexdigest()
        if key not in memo:
            memo[key] = inner(scene, w2c, rs)
        return memo[key]

    synthetic.render_frame = render_frame


def check_scene(frames, rs, device):
    """Frame 0 seeded one Gaussian per pixel, projected and binned from frame
    1's pose: (activated map, frame 1's pose, render settings, packed rows
    [N, 16], bins)."""
    import torch

    from mm3dgs_slam_torch.models import gaussians as G
    from mm3dgs_slam_torch.ops.binning import build_bins
    from mm3dgs_slam_torch.ops.pose import w2c_to_pose
    from mm3dgs_slam_torch.ops.render import project_for_pose
    from mm3dgs_slam_torch.slam.map_ops import new_gaussian_candidates

    (color, depth, _, c2w0, _), (_, _, _, c2w1, _) = frames
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


def check_kernels(scene, fwd_ncs=(3, 5, 6), bwd_nc=3, pose_ncs=(5, 6), tag="check"):
    """Each kernel against its plain version on `scene` (check_scene's
    tuple): kernel 1 at each of `fwd_ncs` (its row at nc 5, the tracking
    width), kernel 2 at `bwd_nc`, kernel 3 at each of `pose_ncs`; returns the
    rows of the kernels line (launches filled in later)."""
    import torch

    from mm3dgs_slam_torch.ops import composite as plain
    from mm3dgs_slam_torch.ops import kernels
    from mm3dgs_slam_torch.ops.binning import build_bins, build_slots
    from mm3dgs_slam_torch.ops.projection import conic_pose_jacobian_rows
    from mm3dgs_slam_torch.ops.render import (background, effective_scales, means_cam_soa,
                                              pose_grads_from_partials, project_for_pose)
    from mm3dgs_slam_torch.ops.tolerances import GRAD_TOL, IMG_TOL, PARTIAL_ATOL, POSE_TOL

    g, pose1, rs, packed, bins = scene
    device = packed.device
    n, n_pairs, n_tiles = packed.shape[0], bins.pair_gauss.shape[0], rs.cam.n_tiles
    # the bounds' bytes: each function reads the 6 + nc fields it uses (kernel
    # 3 also the 12 pose columns) of the rows of the Gaussians in some pair
    n_seen = int(torch.unique(bins.pair_gauss).numel())
    print(f"[{tag}] scene: {n} gaussians (frame 0 seeded, one per pixel) at "
          f"{rs.cam.width}x{rs.cam.height}, {n_tiles} tiles ({rs.cam.tiles_x}x"
          f"{rs.cam.tiles_y}, last column {rs.cam.width - 16 * (rs.cam.tiles_x - 1)} pixels "
          f"wide, last row {rs.cam.height - 16 * (rs.cam.tiles_y - 1)} pixels "
          f"high), {n_pairs} pairs of {n_seen} gaussians, max "
          f"{int(bins.tile_count.max())} per tile", flush=True)
    with torch.no_grad():
        t_rebin = wall_ms(lambda: build_bins(project_for_pose(g, pose1, rs), rs.cam), 10)
    print(f"[{tag}] one rebin (project_for_pose + build_bins, as tracking runs it every "
          f"tpu.rebin_every iterations): {t_rebin:.3f} ms host wall", flush=True)
    args = (bins.pair_gauss, bins.tile_start, bins.tile_count, rs.cam)
    gen = torch.Generator(device=device).manual_seed(0)
    new_work = lambda: torch.zeros(2, dtype=torch.int64, device=device)  # noqa: E731
    rows = []

    # kernel 1 at each width on black and white backgrounds
    worst, ok_all, t_k, t_p = 0.0, True, {}, {}
    for nc in fwd_ncs:
        counter = new_work()
        acc_k, tfin_k = kernels.composite_fwd(packed, *args, nc, work=counter)
        acc_p, tfin_p, work = plain.composite_fwd_plain(packed, *args, nc, count_work=True)
        for white in (False, True):
            bg = background(rs._replace(white_background=white), device)[:nc][None, :, None]
            err, ok = max_violation(acc_k + tfin_k * bg, acc_p + tfin_p * bg, **IMG_TOL)
            worst, ok_all = max(worst, err), ok_all and ok
            print(f"[{tag}] kernel 1 nc={nc} {'white' if white else 'black'}: "
                  f"max abs err {err:.3e} ({'ok' if ok else 'FAIL'})", flush=True)
        kept, walked = check_work(f"kernel 1 nc={nc}", counter, work, tag)
        t_k[nc] = cuda_ms(lambda: kernels.composite_fwd(packed, *args, nc), 20)
        t_p[nc] = cuda_ms(lambda: plain.composite_fwd_plain(packed, *args, nc), 1, warm=0)
    used, stops, pairs_used = work["used"], work["stops"], work["pairs_used"]
    evaluated = used + stops
    print(f"[{tag}] walk: {work['tested']} pixel-pairs tested by the reference walk, {used} "
          f"used, {stops} stops; {work['pairs_walked']} (tile, pair)s walked, {pairs_used} "
          f"used; (warp, pair)s: {8 * work['pairs_walked']} without a cull, {kept} kept by "
          f"the cull (warp_pairs), {walked} walked, {work['warp_pairs_min']} at least "
          f"(a pixel of the box uses or stops on the pair)", flush=True)
    n_pix = n_tiles * 256
    nc = 5  # the tracking width, the main path's most frequent launch
    fwd_bytes = 4 * (n_seen * (6 + nc) + n_pairs + 2 * n_tiles + n_pix * (nc + 1))
    b, by = bound_ms(fwd_bytes, evaluated * OPS_TEST + used * OPS_FWD_USE(nc))
    widths = "/".join(str(c) for c in fwd_ncs)
    print(f"[{tag}] kernel 1 times at nc={widths}: kernel "
          f"{'/'.join(f'{t_k[c]:.4f}' for c in fwd_ncs)} ms, plain "
          f"{'/'.join(f'{t_p[c]:.1f}' for c in fwd_ncs)} ms; bound at nc=5 {b:.4f} ms "
          f"({by})", flush=True)
    if not ok_all:
        fail("kernel 1 disagrees with its plain version")
    rows.append(dict(name="composite_fwd", route="cuda",
                     source="mm3dgs_slam_torch/csrc/composite_fwd.cu",
                     replaces="mm3dgs_slam_tpu/ops/pallas_composite.py:368",
                     max_abs_err=worst, ms=t_k[nc], plain_ms=t_p[nc], bound_ms=b,
                     bound_by=by, library_ms=None, work=dict(kept=kept, walked=walked),
                     walk={k: work[k] for k in ("tested", "used", "stops", "pairs_walked",
                                                "pairs_used")}))

    # kernel 2: dpacked for loss = sum(w * acc) + sum(w_t * tfin), w ~ N(0, 1),
    # launched twice (the same bits); its per-slot rows and dpacked against
    # the plain passes, each pass timed alone and the two together
    nc = bwd_nc  # the mapping width
    nf = 6 + nc
    acc, tfin = kernels.composite_fwd(packed, *args, nc)
    dacc = torch.randn(acc.shape, generator=gen, device=device)
    dtfin = torch.randn(tfin.shape, generator=gen, device=device)
    gargs = (packed, *args[:3], acc, tfin, dacc, dtfin, rs.cam, nc)
    slots = build_slots(bins.pair_gauss, n)
    seg = segment_stats(slots, n, tag)
    counter = new_work()
    rows_k = kernels.composite_bwd_rows(*gargs, work=counter)
    rows_k2 = kernels.composite_bwd_rows(*gargs)
    d_k = kernels.slot_reduce(rows_k, slots, n)
    # the second launch of both passes through the composed wrapper
    d_k2 = kernels.composite_bwd(*gargs, slots=slots)
    same = torch.equal(d_k, d_k2) and torch.equal(rows_k, rows_k2)
    rows_p = plain.composite_bwd_pairs_plain(*gargs)
    d_p = plain.slot_reduce_plain(rows_p, slots, n)
    scale = float(d_p.abs().max())
    err_r, ok_r = max_violation(rows_k, rows_p, **GRAD_TOL)
    err, ok = max_violation(d_k, d_p, **GRAD_TOL)
    # the reduce on the kernel's rows: the plain reduce's adds, in its order
    red_eq = torch.equal(d_k, plain.slot_reduce_plain(rows_k, slots, n))
    kept, walked = check_work(f"kernel 2 nc={nc}", counter, work, tag)
    t_both = cuda_ms(lambda: kernels.composite_bwd(*gargs, slots=slots), 10)
    t_rows = cuda_ms(lambda: kernels.composite_bwd_rows(*gargs), 10)
    t_red = cuda_ms(lambda: kernels.slot_reduce(rows_k, slots, n), 10)
    idx, dst = bins.pair_gauss.long(), torch.zeros((n, nf), device=device)
    t_lib = cuda_ms(lambda: dst.index_add_(0, idx, rows_k), 10)
    tp = cuda_ms(lambda: plain.composite_bwd_pairs_plain(*gargs), 1, warm=0)
    tp_red = cuda_ms(lambda: plain.slot_reduce_plain(rows_k, slots, n), 1, warm=0)
    # pass 1 writes the rows [P, 6 + nc]; pass 2 reads them and the slot
    # table and writes dpacked; kernel 2 as a whole does both
    rows_bytes = 4 * (n_seen * nf + n_pairs + 2 * n_tiles + n_pix * (2 * nc + 2) + n_pairs * nf)
    rows_ops = n_pix * OPS_PIX_BWD(nc) + evaluated * OPS_TEST + used * OPS_BWD_USE(nc)
    # the reduce reads the rows, gauss_start and gauss_slot once each (each
    # warp the bounds of its 32 Gaussians and one run of gauss_slot) and
    # writes dpacked once
    red_bytes, red_ops = 4 * (n_pairs * nf + n + 1 + n_pairs + 16 * n), pairs_used * nf
    b, by = bound_ms(rows_bytes, rows_ops)
    b_red, by_red = bound_ms(red_bytes, red_ops)
    b_both, by_both = bound_ms(rows_bytes + red_bytes, rows_ops + red_ops)
    print(f"[{tag}] kernel 2 nc={nc}: per-slot rows [{n_pairs}, {nf}] max abs err {err_r:.3e} "
          f"({'ok' if ok_r else 'FAIL'}), dpacked max abs err {err:.3e} (max |dpacked| "
          f"{scale:.3e}) ({'ok' if ok else 'FAIL'}); two launches "
          f"{'bit-equal' if same else 'DIFFER'}; the reduce of the kernel's rows "
          f"{'bit-equal to' if red_eq else 'DIFFERS from'} the plain reduce's; both passes "
          f"{t_both:.4f} ms (bound {b_both:.4f}, {by_both}), rows {t_rows:.4f} ms (bound "
          f"{b:.4f}, {by}), reduce {t_red:.4f} ms (bound {b_red:.4f}, {by_red}; index_add_ "
          f"{t_lib:.4f} ms); plain rows {tp:.1f} ms, plain reduce {tp_red:.1f} ms", flush=True)
    if not (ok and ok_r):
        fail("kernel 2 disagrees with its plain version")
    if not (same and red_eq):
        fail("kernel 2 is not bit-identical from launch to launch, or its reduce differs "
             "from the plain reduce's adds")
    rows.append(dict(name="composite_bwd", route="cuda",
                     source="mm3dgs_slam_torch/csrc/composite_bwd.cu",
                     replaces="mm3dgs_slam_tpu/ops/pallas_composite.py:626",
                     max_abs_err=err_r, ms=t_rows, plain_ms=tp, bound_ms=b, bound_by=by,
                     library_ms=None, dpacked_max_abs_err=err, both_passes=dict(
                         ms=t_both, bound_ms=b_both, bound_by=by_both), bit_identical=same,
                     work=dict(kept=kept, walked=walked)))
    rows.append(dict(name="slot_reduce", route="cuda",
                     source="mm3dgs_slam_torch/csrc/composite_bwd.cu",
                     replaces="mm3dgs_slam_tpu/ops/pallas_composite.py:1105",
                     max_abs_err=float((d_k - plain.slot_reduce_plain(rows_k, slots, n)).abs()
                                       .max()), ms=t_red, plain_ms=tp_red, bound_ms=b_red,
                     bound_by=by_red, library_ms=t_lib, segments=seg))

    # kernel 3: the per-tile partials, then dq and dT, at each tracking width
    # (nc 5 vigs/mm3dgs, nc 6 splatam); the row holds the first width's
    # numbers and the others' beside them
    k3 = {}
    with torch.no_grad():
        packed32 = torch.cat([packed, conic_pose_jacobian_rows(
            means_cam_soa(g.xyz, pose1), effective_scales(g.scales, rs), g.rotations, g.xyz,
            rs.cam)], 1).contiguous()
    for nc in pose_ncs:
        with torch.no_grad():
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
        kept, walked = check_work(f"kernel 3 nc={nc}", counter, work, tag)
        tk = cuda_ms(lambda: kernels.composite_pose_bwd(*pargs), 10)
        tp = cuda_ms(lambda: plain.composite_pose_bwd_plain(*pargs), 1, warm=0)
        pose_bytes = 4 * (n_seen * (6 + nc + 12) + n_pairs + 2 * n_tiles
                          + n_pix * (2 * nc + 2) + n_tiles * 12)
        b, by = bound_ms(pose_bytes, n_pix * OPS_PIX_BWD(nc) + evaluated * OPS_TEST
                         + used * OPS_POSE_USE(nc) + pairs_used * OPS_POSE_PAIR(nc))
        print(f"[{tag}] kernel 3 nc={nc}: per-tile partials [{n_tiles}, 12] max abs err "
              f"{err_t:.3e}, at most {rel_t:.3e} of sum |term| (max |partial| "
              f"{float(psum_p.abs().max()):.3e}, sum |term| up to {cancel:.3e}x |partial|) "
              f"({'ok' if ok_t else 'FAIL'}); dq {gk[:4].tolist()} vs plain {gp[:4].tolist()}, "
              f"dT {gk[4:].tolist()} vs plain {gp[4:].tolist()}; max abs err {err:.3e} "
              f"({'ok' if ok else 'FAIL'}); {kept} boxes kept, {walked} (warp, pair)s walked; "
              f"kernel {tk:.4f} ms, plain {tp:.1f} ms, bound {b:.4f} ms ({by})", flush=True)
        if not (ok_t and ok):
            fail(f"kernel 3 at nc {nc} disagrees with its plain version")
        k3[nc] = dict(max_abs_err=max(err_t, err), ms=tk, plain_ms=tp, bound_ms=b, bound_by=by,
                      work=dict(kept=kept, walked=walked))
    row = dict(name="composite_pose_bwd", route="cuda",
               source="mm3dgs_slam_torch/csrc/composite_pose_bwd.cu",
               replaces="mm3dgs_slam_tpu/ops/pallas_composite.py:858",
               **k3[pose_ncs[0]], library_ms=None)
    for nc in pose_ncs[1:]:
        row[f"nc{nc}"] = k3[nc]
    rows.append(row)
    return rows


def check_pose_rows(scene, tag="check"):
    """Kernel 4 against its plain version on `scene` (check_scene's tuple:
    the map at frame 1's pose, under the scene's own force_isotropic):
    columns 0-15 within IMG_TOL, the conic Jacobian 16-24 within GRAD_TOL,
    the world mean and the zeros 25-31 equal; its time beside its bytes
    bound and the plain version's. Returns the kernels line's row."""
    import torch

    from mm3dgs_slam_torch.ops import kernels
    from mm3dgs_slam_torch.ops.projection import pose_rows_plain
    from mm3dgs_slam_torch.ops.render import isotropic
    from mm3dgs_slam_torch.ops.tolerances import GRAD_TOL, IMG_TOL

    g, pose1, rs, _, _ = scene
    n = g.xyz.shape[0]
    iso = isotropic(rs)
    args = (g, pose1[:4], pose1[4:], rs.cam, iso)
    with torch.no_grad():
        rows_k = kernels.pose_rows(*args)
        rows_p = pose_rows_plain(*args)
        tk = cuda_ms(lambda: kernels.pose_rows(*args), 20)
        tp = cuda_ms(lambda: pose_rows_plain(*args), 3)
    err_i, ok_i = max_violation(rows_k[:, :16], rows_p[:, :16], **IMG_TOL)
    err_j, ok_j = max_violation(rows_k[:, 16:25], rows_p[:, 16:25], **GRAD_TOL)
    exact = torch.equal(rows_k[:, 25:], rows_p[:, 25:])
    # each input read once (xyz, scales, rotation, opacity, 12 B of the SH
    # row; q and T), the [n, 32] rows written once. A row's ~350 f32
    # operations take under a fifth of its bytes' time: the bound is bytes.
    b, by = bound_ms(n * (12 + 12 + 16 + 4 + 12 + 128) + 28, 0)
    print(f"[{tag}] kernel 4 (pose rows) on {n} rows{' (isotropic)' if iso else ''}: columns "
          f"0-15 max abs err {err_i:.3e} "
          f"({'ok' if ok_i else 'FAIL'}), Jacobian 16-24 max abs err {err_j:.3e} (max |J| "
          f"{float(rows_p[:, 16:25].abs().max()):.3e}) ({'ok' if ok_j else 'FAIL'}), 25-31 "
          f"{'equal' if exact else 'DIFFER'}; kernel {tk:.4f} ms, plain {tp:.1f} ms, bound "
          f"{b:.4f} ms ({by})", flush=True)
    if not (ok_i and ok_j and exact):
        fail(f"{tag}: kernel 4 disagrees with its plain version")
    return dict(name="pose_rows", route="cuda", source="mm3dgs_slam_torch/csrc/pose_rows.cu",
                replaces=None, rows=n, max_abs_err=max(err_i, err_j), ms=tk, plain_ms=tp,
                bound_ms=b, bound_by=by, library_ms=None)


def add_pose_rows_entry(rows, scene, key, tag):
    """check_pose_rows on `scene`, kept in the kernels line's pose_rows row
    under `key`."""
    r = check_pose_rows(scene, tag=tag)
    next(k for k in rows if k["name"] == "pose_rows")[key] = {
        f: r[f] for f in SIZE_KEYS if f in r}


def check_bench_bins(device, nc=3, tag="check bench bins"):
    """Phase 3's slot reduce on the mapping bins the bench times:
    bench.build_scene's 131,072 Gaussians at 640x480 binned at the identity
    pose, kernel 2's rows at `nc` for a random dacc and dtfin; the segment
    lengths, the reduce bit-equal to its second launch and to the plain
    reduce of the same rows, its time beside index_add_'s and its bound.
    Returns the kernels line's entry."""
    import torch

    from mm3dgs_slam_torch import bench
    from mm3dgs_slam_torch.ops import composite as plain
    from mm3dgs_slam_torch.ops import kernels
    from mm3dgs_slam_torch.ops.binning import build_bins, build_slots
    from mm3dgs_slam_torch.ops.render import RenderSettings, project_for_pose

    m, cam = bench.build_scene(bench.N_GAUSSIANS, (bench.H, bench.W), device=device)
    with torch.no_grad():
        proj = project_for_pose(m.activated(), torch.tensor(bench.IDENTITY, device=device),
                                RenderSettings(cam=cam))
        bins = build_bins(proj, cam)
    packed, n = proj.packed.contiguous(), m.n
    args = (packed, bins.pair_gauss, bins.tile_start, bins.tile_count, cam)
    acc, tfin = kernels.composite_fwd(*args, nc)
    gen = torch.Generator(device=device).manual_seed(4)
    rows = kernels.composite_bwd_rows(*args[:4], acc, tfin,
                                      torch.randn(acc.shape, generator=gen, device=device),
                                      torch.randn(tfin.shape, generator=gen, device=device),
                                      cam, nc)
    slots = build_slots(bins.pair_gauss, n)
    seg = segment_stats(slots, n, tag)
    d1 = kernels.slot_reduce(rows, slots, n)
    d2 = kernels.slot_reduce(rows, slots, n)
    d_p = plain.slot_reduce_plain(rows, slots, n)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    same = torch.equal(bits(d1), bits(d2)) and torch.equal(bits(d1), bits(d_p))
    t_red = cuda_ms(lambda: kernels.slot_reduce(rows, slots, n), 10)
    idx, dst = bins.pair_gauss.long(), torch.zeros((n, rows.shape[1]), device=device)
    t_lib = cuda_ms(lambda: dst.index_add_(0, idx, rows), 10)
    tp = cuda_ms(lambda: plain.slot_reduce_plain(rows, slots, n), 1, warm=0)
    n_pairs, nf = rows.shape
    # each input read once (rows, the slot table), dpacked written once; the
    # adds are those of the slots whose row is not all zero
    b, by = bound_ms(4 * (n_pairs * nf + n + 1 + n_pairs + 16 * n),
                     int((rows != 0).any(1).sum()) * nf)
    print(f"[{tag}] {n} gaussians at {cam.width}x{cam.height}, {n_pairs} pairs, nc={nc}: reduce "
          f"{t_red:.4f} ms (bound {b:.4f}, {by}; index_add_ {t_lib:.4f} ms; plain {tp:.1f} ms); "
          f"two launches and the plain reduce {'bit-equal' if same else 'DIFFER'}", flush=True)
    if not same:
        fail(f"{tag}: the slot reduce is not bit-equal to its second launch or the plain reduce")
    return dict(n=n, pairs=n_pairs, nc=nc, ms=t_red, library_ms=t_lib, plain_ms=tp,
                bound_ms=b, bound_by=by, max_abs_err=float((d1 - d_p).abs().max()),
                segments=seg)


def check_windows(scene, worlds=(2, 7), tag="check 3d"):
    """Phase 3d, on phase 3's scene: each kernel launched over the tile
    windows of W ranks, as the tile-sharded render launches it (kernel 1 at
    nc 5, kernel 2 at nc 3, kernel 3 at nc 5): every window against its
    windowed plain version, the windows stitched against the whole-grid
    launch (kernel 1's outputs and kernel 3's partials compared bit for
    bit, kernel 2's dpacked summed over the windows within GRAD_TOL), and
    each window launch's CUDA-event time beside its bound, worked out from
    the window's walk counts as check_kernels's bounds are. Returns
    {kernel name: {"W<n>": {...}}} for the kernels line."""
    import torch

    from mm3dgs_slam_torch.ops import composite as plain
    from mm3dgs_slam_torch.ops import kernels
    from mm3dgs_slam_torch.ops.binning import build_bins, build_slots
    from mm3dgs_slam_torch.ops.projection import conic_pose_jacobian_rows
    from mm3dgs_slam_torch.ops.render import effective_scales, means_cam_soa, project_for_pose
    from mm3dgs_slam_torch.parallel.mesh import tiles_per_shard
    from mm3dgs_slam_torch.ops.tolerances import GRAD_TOL, IMG_TOL, PARTIAL_ATOL

    g, pose1, rs, packed, bins = scene
    cam, device = rs.cam, packed.device
    with torch.no_grad():
        proj = project_for_pose(g, pose1, rs)
        packed32 = torch.cat([packed, conic_pose_jacobian_rows(
            means_cam_soa(g.xyz, pose1), effective_scales(g.scales, rs), g.rotations, g.xyz,
            cam)], 1).contiguous()
    args = (bins.pair_gauss, bins.tile_start, bins.tile_count)
    gen = torch.Generator(device=device).manual_seed(3)
    out = {"composite_fwd": {}, "composite_bwd": {}, "slot_reduce": {},
           "composite_pose_bwd": {}}
    for world in worlds:
        tpb = tiles_per_shard(cam, world)
        n_pad = world * tpb
        acc5, tfin5 = kernels.composite_fwd(packed32, *args, cam, 5)
        acc3, tfin3 = kernels.composite_fwd(packed, *args, cam, 3)
        d5 = torch.randn((n_pad, 5, 256), generator=gen, device=device)
        dt = torch.randn((n_pad, 1, 256), generator=gen, device=device)
        d3 = d5[:, :3].contiguous()
        whole = cam.n_tiles
        psum = kernels.composite_pose_bwd(packed32, *args, acc5, tfin5, d5[:whole], dt[:whole],
                                          cam, 5)
        dpacked = kernels.composite_bwd(packed, *args, acc3, tfin3, d3[:whole], dt[:whole],
                                        cam, 3)
        stitched, psums, asums, dsum = [], [], [], torch.zeros_like(dpacked)
        res = {k: dict(ms=[], bound_ms=[], bound_by=[], max_abs_err=0.0) for k in out}
        res["composite_bwd"]["both_ms"] = []
        for r in range(world):
            lo, sl = r * tpb, slice(r * tpb, (r + 1) * tpb)
            wb = build_bins(proj, cam, lo, tpb)
            wargs = (wb.pair_gauss, wb.tile_start, wb.tile_count, cam)
            win = dict(tile_lo=lo, n_local=tpb)
            n_tiles_w = max(min(tpb, cam.n_tiles - lo), 0)
            n_pix, n_pairs = n_tiles_w * 256, wb.pair_gauss.shape[0]
            n_seen = int(torch.unique(wb.pair_gauss).numel())
            a, t = kernels.composite_fwd(packed32, *wargs, 5, **win)
            ap, tp, work = plain.composite_fwd_plain(packed32, *wargs, 5, count_work=True, **win)
            e_f = max(float((a - ap).abs().max()), float((t - tp).abs().max()))
            ok_f = (max_violation(a, ap, **IMG_TOL)[1] and max_violation(t, tp, **IMG_TOL)[1])
            used, ev, pu = work["used"], work["used"] + work["stops"], work["pairs_used"]
            pa = (packed32, *wargs[:3], a, t, d5[sl], dt[sl], cam, 5)
            pk = kernels.composite_pose_bwd(*pa, **win)
            pp, asum = plain.composite_pose_bwd_plain(*pa, abs_sum=True, **win)
            e_p, ok_p = max_violation(pk, pp, atol=PARTIAL_ATOL * asum, rtol=GRAD_TOL["rtol"])
            a3, t3 = kernels.composite_fwd(packed, *wargs, 3, **win)
            ba = (packed, *wargs[:3], a3, t3, d3[sl], dt[sl], cam, 3)
            slots = build_slots(wb.pair_gauss, packed.shape[0])
            rk = kernels.composite_bwd_rows(*ba, **win)
            rk2 = kernels.composite_bwd_rows(*ba, **win)
            dk = kernels.slot_reduce(rk, slots, packed.shape[0], windowed=True)
            dk2 = kernels.composite_bwd(*ba, **win, slots=slots)
            rp = plain.composite_bwd_pairs_plain(*ba, **win)
            e_b, ok_b = max_violation(dk, plain.slot_reduce_plain(rp, slots, packed.shape[0]),
                                      **GRAD_TOL)
            e_r, ok_r = max_violation(rk, rp, **GRAD_TOL)
            same = torch.equal(dk, dk2) and torch.equal(rk, rk2)
            if not (ok_f and ok_p and ok_b and ok_r):
                fail(f"{tag}: W={world} window {r}: a windowed kernel disagrees with its plain "
                     f"version (errors {e_f:.3e}, {e_b:.3e} (rows {e_r:.3e}), {e_p:.3e})")
            if not same:
                fail(f"{tag}: W={world} window {r}: two launches of kernel 2 differ")
            stitched.append(torch.cat([a, t], 1))
            psums.append(pk)
            asums.append(asum)
            dsum += dk
            n_all = packed.shape[0]
            times = (cuda_ms(lambda: kernels.composite_fwd(packed32, *wargs, 5, **win), 10),
                     cuda_ms(lambda: kernels.composite_bwd_rows(*ba, **win), 10),
                     cuda_ms(lambda: kernels.slot_reduce(rk, slots, n_all), 10),
                     cuda_ms(lambda: kernels.composite_pose_bwd(*pa, **win), 10))
            t_both = cuda_ms(lambda: kernels.composite_bwd(*ba, **win, slots=slots), 10)
            bounds = (
                bound_ms(4 * (n_seen * 11 + n_pairs + 2 * tpb + n_pix * 6),
                         ev * OPS_TEST + used * OPS_FWD_USE(5)),
                bound_ms(4 * (n_seen * 9 + n_pairs + 2 * tpb + n_pix * 8 + n_pairs * 9),
                         n_pix * OPS_PIX_BWD(3) + ev * OPS_TEST + used * OPS_BWD_USE(3)),
                bound_ms(4 * (n_pairs * 9 + n_all + 1 + n_pairs + 16 * n_all), pu * 9),
                bound_ms(4 * (n_seen * 23 + n_pairs + 2 * tpb + n_pix * 12 + tpb * 12),
                         n_pix * OPS_PIX_BWD(5) + ev * OPS_TEST + used * OPS_POSE_USE(5)
                         + pu * OPS_POSE_PAIR(5)))
            res["composite_bwd"]["both_ms"].append(t_both)
            for k, tk, (b, by), e in zip(out, times, bounds, (e_f, e_r, e_b, e_p)):
                res[k]["ms"].append(tk)
                res[k]["bound_ms"].append(b)
                res[k]["bound_by"].append(by)
                res[k]["max_abs_err"] = max(res[k]["max_abs_err"], e)
            print(f"[{tag}] W={world} window {r} (tiles {lo}-{lo + tpb - 1}, {n_tiles_w} in the "
                  f"grid, {n_pairs} pairs): kernel 1 nc=5 {times[0]:.4f} ms (bound "
                  f"{bounds[0][0]:.4f}), kernel 2 nc=3 both passes {t_both:.4f} ms, rows "
                  f"{times[1]:.4f} ms (bound {bounds[1][0]:.4f}), reduce {times[2]:.4f} ms (bound "
                  f"{bounds[2][0]:.4f}), two launches bit-equal; kernel 3 nc=5 {times[3]:.4f} ms "
                  f"(bound {bounds[3][0]:.4f}); max abs err against the windowed plain versions "
                  f"{e_f:.3e}, {e_r:.3e} (rows) / {e_b:.3e} (dpacked), {e_p:.3e} (ok)", flush=True)
        st, ps = torch.cat(stitched), torch.cat(psums)
        diff_f = float((st[:whole] - torch.cat([acc5, tfin5], 1)).abs().max())
        diff_p = float((ps[:whole] - psum).abs().max())
        eq_f = torch.equal(st[:whole], torch.cat([acc5, tfin5], 1))
        eq_p = torch.equal(ps[:whole], psum)
        pad_ok = (bool((st[whole:, :5] == 0).all()) and bool((st[whole:, 5] == 1.0).all())
                  and bool((ps[whole:] == 0).all()))
        e_d, ok_d = max_violation(dsum, dpacked, **GRAD_TOL)
        print(f"[{tag}] W={world} stitched against the whole-grid launch: kernel 1 "
              f"{'bit-equal' if eq_f else f'differs by up to {diff_f:.3e}'}, kernel 3's "
              f"partials {'bit-equal' if eq_p else f'differ by up to {diff_p:.3e}'}, kernel 2's "
              f"summed dpacked max abs err {e_d:.3e} ({'ok' if ok_d else 'FAIL'}); the "
              f"{n_pad - whole} pad tiles {'acc 0, T 1, partials 0' if pad_ok else 'WRONG'}",
              flush=True)
        if not (ok_d and pad_ok and max_violation(st[:whole], torch.cat([acc5, tfin5], 1),
                                                   **IMG_TOL)[1]
                and max_violation(ps[:whole], psum, atol=PARTIAL_ATOL * torch.cat(asums)[:whole],
                                  rtol=GRAD_TOL["rtol"])[1]):
            fail(f"{tag}: W={world}: the stitched windows disagree with the whole grid")
        for k in out:
            out[k][f"W{world}"] = dict(res[k], ms_sum=sum(res[k]["ms"]),
                                       ms_max=max(res[k]["ms"]))
        out["composite_bwd"][f"W{world}"]["bit_identical"] = True
        out["composite_fwd"][f"W{world}"]["bit_equal_to_whole"] = eq_f
        out["composite_pose_bwd"][f"W{world}"]["bit_equal_to_whole"] = eq_p
        out["composite_bwd"][f"W{world}"]["summed_err_to_whole"] = e_d
    return out


MESH_RANKS = 2          # phase 14: ranks sharing the one card


def run_mesh(scene_npz, outdir, main_cfg):
    """Phase 14: `torchrun --standalone --nproc_per_node 2` runs run_golden
    on configs/synthetic_tum.yml with tpu.mesh_devices 2 (the sharded map:
    each rank its rows and its tile window, the two ranks sharing the card
    over gloo) on phase 4's N_FRAMES frames of its scene, so the two runs
    track the same frames. Gates: the run exits 0; ATE < 0.03 m and PSNR >
    17 dB; within 5e-3 m ATE and 1 dB mean PSNR (over the same eval frames)
    of phase 4's run; both ranks' poses bit-equal (each rank prints a hash
    of its pose list); every kernel launched over a window on each rank.
    Prints the camera-centre distance between the two runs' poses, frame by
    frame. Returns each rank's windowed launch counts."""
    from mm3dgs_slam_torch.eval.ate import camera_centers

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(MESH_RANKS), "-m", "mm3dgs_slam_torch.scripts.run_golden",
           "--config", str(ROOT / "configs" / "synthetic_tum.yml"), "--scene", scene_npz,
           "--outdir", str(outdir), "--frames", str(N_FRAMES),
           "--mesh-devices", str(MESH_RANKS)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for ln in p.stdout.splitlines():
        if "[mesh]" in ln or "[rank " in ln:
            print(f"[mesh2] {ln}", flush=True)
    if p.returncode != 0:
        print(p.stdout[-4000:], p.stderr[-8000:], sep="\n", file=sys.stderr)
        fail(f"mesh2: torchrun exited {p.returncode}")
    # The ranks share torchrun's stdout, so a summary need not start a line
    # or end one: each is read from its marker to the end of its object.
    ranks, decoder = {}, json.JSONDecoder()
    for mt in re.finditer(r"\[rank (\d+)/\d+\] ", p.stdout):
        try:
            ranks[int(mt.group(1))] = decoder.raw_decode(p.stdout, mt.end())[0]
        except json.JSONDecodeError as e:
            fail(f"mesh2: rank {mt.group(1)}'s summary does not parse ({e})")
    if sorted(ranks) != list(range(MESH_RANKS)):
        fail(f"mesh2: rank summaries {sorted(ranks)}")
    r = np.load(Path(outdir) / "results.npz", allow_pickle=True)
    m = np.load(Path(main_cfg["outputdir"]) / "results.npz", allow_pickle=True)
    if r["pose_gt"].shape != m["pose_gt"].shape or not np.array_equal(r["pose_gt"],
                                                                      m["pose_gt"]):
        fail("mesh2: phase 14 and phase 4 did not run the same frames")
    ate, psnr = float(r["ate_rmse"]), float(np.mean(r["psnr_list"]))
    ate_main, psnr_main = float(m["ate_rmse"]), float(np.mean(m["psnr_list"]))
    apart = np.linalg.norm(camera_centers(r["pose_est"])[:, 4:]
                           - camera_centers(m["pose_est"])[:, 4:], axis=1)
    hashes = {ranks[k]["pose_sha1"] for k in ranks}
    print(f"[mesh2] {MESH_RANKS} ranks on one card, {N_FRAMES} frames: ATE {ate:.6f} m "
          f"(phase 4 {ate_main:.6f}), PSNR {psnr:.3f} dB over {len(r['psnr_list'])} eval "
          f"frames (phase 4 {psnr_main:.3f}); camera centres apart from phase "
          f"4's by frame {[float(f'{d:.3g}') for d in apart]} m; gaussians by rank "
          f"{[ranks[k]['gaussians'] for k in sorted(ranks)]}; ms per tracking / mapping "
          f"iteration by rank {[(ranks[k]['ms_track'], ranks[k]['ms_map']) for k in sorted(ranks)]}"
          f"; windowed launches by rank {[ranks[k]['launches_windowed'] for k in sorted(ranks)]};"
          f" poses bit-equal across ranks: {len(hashes) == 1}; torchrun wall {wall:.1f} s",
          flush=True)
    if len(hashes) != 1:
        fail(f"mesh2: the ranks' poses differ ({hashes})")
    if not all(v > 0 for k in ranks for v in ranks[k]["launches_windowed"].values()):
        fail("mesh2: a kernel was never launched over a window")
    if not (ate < 0.03 and psnr > 17.0):
        fail(f"mesh2: quality gates: ATE {ate} (< 0.03), PSNR {psnr} (> 17)")
    if not (abs(ate - ate_main) < 5e-3 and abs(psnr - psnr_main) < 1.0):
        fail(f"mesh2: against phase 4: ATE {ate} vs {ate_main}, PSNR {psnr} vs {psnr_main}")
    return {f"mesh2_rank{k}": ranks[k]["launches_windowed"] for k in sorted(ranks)}


def check_ba_chain(scene, nc=3, tag="check"):
    """Bundle adjustment's pose gradient on `scene`: the port's path
    (autograd through composite_packed, kernel 2's dpacked, into the pose of
    the projection) against the same chain through the plain backward. The
    chain is J^T dpacked with J = d packed / d pose [7, N, 16] by
    forward-mode AD; the per-Gaussian terms cancel, so the atol is BA_ATOL
    of their sum |term|. Returns the largest error over sum |term|."""
    import torch

    from mm3dgs_slam_torch.ops import composite as plain
    from mm3dgs_slam_torch.ops import kernels
    from mm3dgs_slam_torch.ops.render import composite_packed, project_for_pose
    from mm3dgs_slam_torch.ops.tolerances import BA_ATOL, POSE_TOL

    g, pose1, rs, packed, bins = scene
    device = packed.device
    args = (bins.pair_gauss, bins.tile_start, bins.tile_count)
    gen = torch.Generator(device=device).manual_seed(1)
    acc, tfin = kernels.composite_fwd(packed, *args, rs.cam, nc)
    dacc = torch.randn(acc.shape, generator=gen, device=device)
    dtfin = torch.randn(tfin.shape, generator=gen, device=device)
    pose = pose1.clone().requires_grad_(True)
    acc2, tfin2 = composite_packed(project_for_pose(g, pose, rs).packed, bins, rs.cam, nc)
    (g_path,) = torch.autograd.grad((acc2 * dacc).sum() + (tfin2 * dtfin).sum(), pose)
    with torch.no_grad():
        eye = torch.eye(7, device=device)
        J = torch.stack([torch.func.jvp(lambda p: project_for_pose(g, p, rs).packed,
                                        (pose1,), (eye[j],))[1] for j in range(7)])
        gargs = (packed, *args, acc, tfin, dacc, dtfin, rs.cam, nc)
        terms_p = J * plain.composite_bwd_plain(*gargs)
        g_k = (J * kernels.composite_bwd(*gargs)).sum((1, 2))
        g_p, asum = terms_p.sum((1, 2)), terms_p.abs().sum((1, 2))
    tol = BA_ATOL * asum + POSE_TOL["rtol"] * g_p.abs()
    rel = float(((g_k - g_p).abs() / asum).max())
    ok = bool(((g_k - g_p).abs() <= tol).all() and ((g_path - g_p).abs() <= tol).all())
    print(f"[{tag}] BA pose gradient through kernel 2 nc={nc}: path {g_path.tolist()}, chain "
          f"{g_k.tolist()} vs plain {g_p.tolist()}; max abs err {float((g_k - g_p).abs().max()):.3e}"
          f" (path {float((g_path - g_p).abs().max()):.3e}), at most {rel:.3e} of sum |term| "
          f"(sum |term| up to {float((asum / g_p.abs().clamp_min(1e-30)).max()):.3e}x |gradient|)"
          f" ({'ok' if ok else 'FAIL'})", flush=True)
    if not ok:
        fail("the BA pose gradient through kernel 2 disagrees with the plain chain")
    return rel


RESULT_KEYS = {"pose_est", "pose_gt", "keyframes", "ate_rmse", "psnr_list", "ssim_list",
               "lpips_list", "lpips_proxy_list", "avg_tracking_it_time",
               "avg_mapping_it_time", "avg_rendering_time", "binning_overflow_frames"}


def drive(run, kernels, tag, cfg, ate_max, psnr_min, extra_keys=frozenset()):
    """One path through the CLI's code path: launch counts set to 0 just
    before and read just after; results.npz keys (RESULT_KEYS and
    `extra_keys`), every kernel launched and the quality gates. Returns
    (launch counts, the SLAM, launch counts by nc)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slam = run(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    by_nc = kernels.launch_counts_by_nc()
    if slam.failed is not None:
        fail(f"{tag}: the SLAM run failed: {slam.failed!r}")
    r = np.load(Path(cfg["outputdir"]) / "results.npz", allow_pickle=True)
    if set(r.files) != RESULT_KEYS | extra_keys:
        fail(f"{tag}: results.npz keys {sorted(r.files)} != "
             f"{sorted(RESULT_KEYS | extra_keys)}")
    if not (len(r["lpips_proxy_list"]) and np.isfinite(r["lpips_proxy_list"]).all()):
        fail(f"{tag}: lpips_proxy_list {r['lpips_proxy_list']} is not all finite")
    ate, psnr = float(r["ate_rmse"]), float(np.mean(r["psnr_list"]))
    frames_s = len(slam.frame_seconds) / sum(slam.frame_seconds)
    print(f"[{tag}] {cfg['scene']} {cfg['desired_width']}x{cfg['desired_height']}, "
          f"{slam.n_img} frames, {cfg['tracking']['iters']}/{cfg['mapping']['iters']} "
          f"iterations: ATE {ate:.6f} m, PSNR {psnr:.3f} dB, "
          f"{float(r['avg_tracking_it_time']):.3f} ms/tracking iteration, "
          f"{float(r['avg_mapping_it_time']):.3f} ms/mapping iteration, "
          f"{frames_s:.4f} frames/s (frame loop), run {wall:.1f} s, "
          f"{slam.gaussians.n} gaussians, max memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}, by nc "
          f"{by_nc}; LPIPS proxy {np.mean(r['lpips_proxy_list']):.6f}", flush=True)
    if not all(v > 0 for v in launches.values()):
        fail(f"{tag}: a kernel of the path was never launched: {launches}")
    if not (ate < ate_max and psnr > psnr_min):
        fail(f"{tag}: quality gates: ATE {ate} (< {ate_max}), PSNR {psnr} (> {psnr_min})")
    return launches, slam, by_nc


DECOMP_KEYS = frozenset({"frame_decomp", "frame_decomp_phases", "frame_decomp_rows"})


def check_decomp(slam, cfg):
    """Phase 4's frame decomposition: the phases of every frame, each frame's
    within its wall time; prints the rows' medians per phase."""
    r = np.load(Path(cfg["outputdir"]) / "results.npz", allow_pickle=True)
    phases, rows = list(r["frame_decomp_phases"]), r["frame_decomp_rows"]
    walls = np.asarray(slam.frame_seconds)
    med = {p: round(float(np.median(rows[1:, j] if len(rows) > 2 else rows[:, j])), 6)
           for j, p in enumerate(phases)}
    print(f"[decomp] per-frame phase seconds (median of frames 1-{len(rows) - 1}): {med}; "
          f"frame walls {np.round(walls, 3).tolist()} s, phases sum "
          f"{np.round(rows.sum(1), 3).tolist()} s", flush=True)
    if not ({"data", "track", "map.optimize"} <= set(phases) and rows.shape[0] == slam.n_img
            and (rows.sum(1) <= walls).all()):
        fail(f"decomp: phases {phases}, rows {rows.shape}, sums {rows.sum(1)} against the "
             f"frame walls {walls}")


def run_bench():
    """Phase 12: the bench in its own process; returns its JSON line's dict."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "mm3dgs_slam_torch.bench"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        fail(f"bench: exit {p.returncode}: {p.stderr[-2000:]}")
    line = lines[-1]
    print(f"[bench] {line}", flush=True)
    out = json.loads(line)
    d = out["detail"]
    print(f"[bench] {out['value']} frames/s, {d['track_ms_per_iter']:.3f} ms per tracking and "
          f"{d['map_ms_per_iter']:.3f} ms per mapping iteration; launches per call "
          f"{d['launches']}; {time.perf_counter() - t0:.1f} s", flush=True)
    track, mapping = d["launches"]["track"], d["launches"]["map"]
    if not (out["value"] > 0 and d["device"] and d["power_limit_w"]
            and track["composite_fwd"] > 0 and track["composite_pose_bwd"] > 0
            and mapping["composite_fwd"] > 0 and mapping["composite_bwd"] > 0):
        fail(f"bench: {line}")
    return out


def check_tools(cfg, slam, scene, tmp, kernels, device="cuda"):
    """Phase 13, on phase 4's run: train_tiny_dpt on its frames, the PLY
    codec, capture / restore and one offline visualizer view, on `device`."""
    import contextlib
    import io
    import re

    import cv2
    import torch
    import yaml

    from mm3dgs_slam_torch.eval.depth_est import TinyDPT
    from mm3dgs_slam_torch.models import gaussians as G
    from mm3dgs_slam_torch.models import ply_io
    from mm3dgs_slam_torch.scripts import train_tiny_dpt, visualizer

    t0 = time.perf_counter()
    yml = Path(tmp) / "main.yml"
    yml.write_text(yaml.safe_dump(cfg))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_tiny_dpt.main(["--config", str(yml), "--out", str(Path(tmp) / "dpt.npz"),
                             "--steps", "50", "--scene", scene, "--device", device])
    losses = {int(a): float(b) for a, b in re.findall(r"step (\d+): ssi_loss=([0-9.]+)",
                                                       out.getvalue())}
    color = slam.dataset[0][0].transpose(2, 0, 1) / 255.0
    est = TinyDPT(str(Path(tmp) / "dpt.npz"), device).estimate_depth(color)
    ok_dpt = (losses.get(49, np.inf) < losses.get(0, 0.0) and est.device.type == device
              and bool(torch.isfinite(est).all()))
    print(f"[tools] train_tiny_dpt 50 steps on {device}: ssi_loss {losses}; estimate "
          f"{tuple(est.shape)} in [{float(est.min()):.4f}, {float(est.max()):.4f}]", flush=True)

    d = G.to_numpy_dict(slam.gaussians)
    n_rest = (cfg["mapping"]["sh_degree"] + 1) ** 2 - 1
    d["features_rest"] = d["features_rest"][:, :n_rest]
    t1 = time.perf_counter()
    ply_io.save_ply(str(Path(tmp) / "map.ply"), **d)
    t_save = time.perf_counter() - t1
    back = ply_io.load_ply(str(Path(tmp) / "map.ply"))
    ok_ply = all(np.array_equal(back[k], v) for k, v in d.items())
    print(f"[tools] PLY of the map ({slam.gaussians.n} gaussians): native codec "
          f"{'loaded' if ply_io.native_loaded() else 'not loaded (numpy path)'}, saved in "
          f"{t_save * 1e3:.1f} ms, read back {'bit-equal' if ok_ply else 'DIFFERENT'}",
          flush=True)

    G.capture(slam.gaussians, slam.adam, Path(tmp) / "capture.npz")
    m, adam = G.restore(Path(tmp) / "capture.npz", device=device)
    ok_cap = adam.step == slam.adam.step and all(
        torch.equal(a, b) for x, y in ((m, slam.gaussians), (adam.mu, slam.adam.mu),
                                       (adam.nu, slam.adam.nu)) for a, b in zip(x, y))
    print(f"[tools] capture/restore: {m.n} rows, step {adam.step}, "
          f"{'bit-equal' if ok_cap else 'DIFFERENT'}", flush=True)

    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        visualizer.main(["--config", str(yml), "--iteration", str(slam.n_img), "--frames", "1",
                         "--device", device])
    view_launches = kernels.launch_counts()["composite_fwd"]
    png = cv2.imread(str(Path(cfg["outputdir"]) / "visualizer" / "view_0000.png"))
    ok_view = (png is not None and png.shape == (cfg["desired_height"],
                                                 2 * cfg["desired_width"], 3)
               and view_launches > 0 and float(png.std()) > 1.0)
    print(f"[tools] visualizer view: {None if png is None else png.shape}, kernel 1 launched "
          f"{view_launches} time(s); phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    if not (ok_dpt and ok_ply and ok_cap and ok_view):
        fail(f"tools: train_tiny_dpt {ok_dpt}, PLY {ok_ply}, capture {ok_cap}, view {ok_view}")


def count_map_rebins():
    """Count the mapping loop's rebins (calls of map_opt._map_bins) from
    here on: returns a one-element list that each call increments."""
    from mm3dgs_slam_torch.slam import map_opt

    n, inner = [0], map_opt._map_bins

    def counted(*a, **k):
        n[0] += 1
        return inner(*a, **k)

    map_opt._map_bins = counted
    return n


def video_frames(path) -> list:
    import cv2

    cap = cv2.VideoCapture(str(path))
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    return shapes


def check_splatam(slam, by_nc, cfg):
    """splatam's launches at its widths, its keyframes and the debug video."""
    if not (by_nc["composite_pose_bwd"].get(6, 0) > 0 and by_nc["composite_bwd"].get(4, 0) > 0):
        fail(f"splatam: kernel 3 at nc 6 or kernel 2 at nc 4 never launched: {by_nc}")
    kfs = [kf.idx for kf in slam.mapper.keyframes]
    shapes = video_frames(Path(cfg["outputdir"]) / "debug_video.mp4")
    want = [(2 * cfg["desired_height"], 3 * cfg["desired_width"], 3)] * (slam.n_img - 1)
    print(f"[splatam] keyframes {kfs}; debug_video.mp4: {len(shapes)} frames of "
          f"{shapes[0] if shapes else None}", flush=True)
    if kfs != [0, 1, 3]:
        fail(f"splatam: keyframes {kfs}, not [0, 1, 3]")
    if shapes != want:
        fail(f"splatam: the video holds {len(shapes)} frames {set(shapes)}, not "
             f"{len(want)} of {want[0]}")


def check_ba(slam, rebins, ms_it, main_rebins, main_ms_it):
    """BA's window poses: finite, and at least one keyframe of an earlier
    frame than the last moved by BA after its own frame, by less than 0.05 m
    and 0.05 rad."""
    poses = np.stack([kf.pose for kf in slam.mapper.keyframes])
    if not (np.isfinite(poses).all() and np.isfinite(slam.estimate_pose_list).all()):
        fail("BA: a window pose is not finite")
    moved = []
    for kf in (k for k in slam.mapper.keyframes if k.idx < slam.n_img - 1):
        own = slam.estimate_pose_list[kf.idx]     # the pose after its own frame
        q1, q2 = own[:4] / np.linalg.norm(own[:4]), kf.pose[:4] / np.linalg.norm(kf.pose[:4])
        angle = 2 * np.arccos(min(abs(float(q1 @ q2)), 1.0))
        moved.append((kf.idx, float(np.linalg.norm(kf.pose[4:] - own[4:])), angle))
    print(f"[ba] keyframe moves by BA after their own frame (idx, |dT| m, angle rad): "
          f"{[(i, round(t, 7), round(a, 7)) for i, t, a in moved]}; mapping rebins "
          f"{rebins} at {ms_it:.3f} ms/mapping iteration (synthetic_tum without BA: "
          f"{main_rebins} at {main_ms_it:.3f})", flush=True)
    if not any((t > 0 or a > 0) and t < 0.05 and a < 0.05 for _, t, a in moved):
        fail(f"BA: no earlier keyframe moved by a nonzero amount below 0.05: {moved}")


def check_resume(cfg, slam0, scene=None):
    """The port resumed from `save_iterations` [3] of the BA run: restored
    poses equal to the saved ones, the keyframe count, a finite
    evaluation; then LPIPS-proxy on the card against the CPU on one frame."""
    import torch

    from mm3dgs_slam_torch.eval.lpips import lpips_proxy
    from mm3dgs_slam_torch.slam.slam import SLAM

    from mm3dgs_slam_torch.data.synthetic import load_scene

    r = np.load(Path(cfg["outputdir"]) / "results.npz", allow_pickle=True)
    slam = SLAM(dict(cfg, iteration=3), device="cuda", scene=load_scene(scene))
    n = len(r["pose_est"])
    psnrs, ssims, _, proxies = slam.evaluate_images(n)
    print(f"[resume] {slam.gaussians.n} gaussians from iteration_3, {len(slam.mapper.keyframes)} "
          f"keyframes (saved {len(r['keyframes'])}); re-evaluated PSNR {np.mean(psnrs):.3f} dB, "
          f"SSIM {np.mean(ssims):.4f}, LPIPS proxy {np.mean(proxies):.6f}", flush=True)
    if not np.array_equal(slam.estimate_pose_list[:n], r["pose_est"]):
        fail("resume: the restored poses differ from the saved ones")
    if not len(slam.mapper.keyframes) == len(r["keyframes"]) == len(slam0.mapper.keyframes):
        fail("resume: the keyframe count differs from the saved one")
    if not (slam.gaussians.n > 0 and np.isfinite(psnrs + ssims + proxies).all()):
        fail("resume: the re-evaluation is not finite")
    img, _ = slam.render_eval(n - 1)
    color = slam.dataset[n - 1][0]
    gt = torch.as_tensor(np.transpose(color, (2, 0, 1)) / 255.0, dtype=torch.float32,
                         device=img.device)
    on_card, on_cpu = lpips_proxy(img, gt), lpips_proxy(img.cpu(), gt.cpu())
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    print(f"[lpips] proxy of frame {n - 1} at {img.shape[2]}x{img.shape[1]}: card {on_card!r}, "
          f"CPU {on_cpu!r}, relative difference {rel:.3e}", flush=True)
    if not rel <= 1e-4:
        fail("lpips: the proxy on the card differs from the CPU's by more than 1e-4")


def check_eval_clis(cfg):
    """Phase 11, on phase 10's output: eval_traj's ATE against results.npz's,
    eval_image's re-render on the card against its PSNR, and the keyframe
    PNGs of debug.save_keyframes against the keyframes' GT colour."""
    import cv2

    from mm3dgs_slam_torch.scripts.eval_image import evaluate
    from mm3dgs_slam_torch.scripts.eval_traj import trajectory_ates

    out = Path(cfg["outputdir"])
    r = np.load(out / "results.npz", allow_pickle=True)
    t0 = time.perf_counter()
    t = trajectory_ates(r["pose_est"], r["pose_gt"])
    d_ate = abs(t["ate_w2c"] - float(r["ate_rmse"]))
    last = len(r["pose_est"])
    psnrs, ssims, _, proxies = evaluate(cfg, last, "cuda")
    d_psnr = abs(float(np.mean(psnrs)) - float(np.mean(r["psnr_list"])))
    worst, names = 0.0, sorted(p.name for p in (out / "keyframes").glob("*.png"))
    for kf in r["keyframes"]:
        png = cv2.imread(str(out / "keyframes" / f"{kf['idx']:05d}.png"))
        if png is None:
            fail(f"eval: no keyframe PNG for keyframe {kf['idx']}")
        want = np.clip(kf["gt_color"], 0, 1).transpose(1, 2, 0) * 255.0
        worst = max(worst, float(np.abs(png[:, :, ::-1].astype(np.float64) - want).max()))
    print(f"[eval] eval_traj: ATE {t['ate_w2c']:.9f} m (results.npz {float(r['ate_rmse']):.9f}, "
          f"|diff| {d_ate:.3e}), camera centres {t['ate_c2w']:.9f} m; eval_image --iteration "
          f"{last} on the card: PSNR {np.mean(psnrs):.4f} dB (results.npz "
          f"{np.mean(r['psnr_list']):.4f}, |diff| {d_psnr:.3e}), SSIM {np.mean(ssims):.4f}, LPIPS "
          f"proxy {np.mean(proxies):.6f}; keyframe PNGs {names} for keyframes "
          f"{[int(kf['idx']) for kf in r['keyframes']]}, at most {worst:.3f} levels from the GT "
          f"colour; {time.perf_counter() - t0:.1f} s", flush=True)
    if not d_ate <= 1e-6:
        fail(f"eval_traj: ATE {t['ate_w2c']} differs from results.npz's {float(r['ate_rmse'])}")
    if not d_psnr <= 0.01:
        fail(f"eval_image: PSNR {np.mean(psnrs)} differs from results.npz's by {d_psnr} dB")
    if len(names) != len(r["keyframes"]) or not worst <= 1.0:
        fail(f"save_keyframes: {len(names)} PNGs for {len(r['keyframes'])} keyframes, "
             f"{worst} levels from the GT colour")


def start_reruns(runs, tmp):
    """Phase 15, first half: each (tag, config, scene .npz) of `runs` run
    through run_golden in a fresh process with its output under `tmp` (the
    runs at once, sharing the card, while the caller writes the recorded
    sequences, where no time is read). Returns the runs for wait_reruns and
    compare_reruns; the processes are killed if the script exits first."""
    import atexit

    import yaml

    started = []
    for tag, cfg, scene in runs:
        out = Path(tmp) / f"rerun_{tag}"
        yml = Path(tmp) / f"rerun_{tag}.yml"
        yml.write_text(yaml.safe_dump(dict(cfg, outputdir=str(out))))
        log = open(Path(tmp) / f"rerun_{tag}.log", "w")
        p = subprocess.Popen([sys.executable, "-m", "mm3dgs_slam_torch.scripts.run_golden",
                              "--config", str(yml), "--scene", scene], cwd=ROOT, stdout=log,
                             stderr=subprocess.STDOUT)
        log.close()
        started.append((tag, Path(cfg["outputdir"]), out, p))
    atexit.register(lambda: [p.kill() for *_, p in started if p.poll() is None])
    return started, time.perf_counter()


def wait_reruns(reruns):
    """Wait for start_reruns's processes (900 s in all); each must exit 0."""
    started, t0 = reruns
    for tag, _, out, p in started:
        try:
            code = p.wait(timeout=max(1.0, 900.0 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            fail(f"rerun {tag}: no result within 900 s")
        if code != 0:
            print(Path(f"{out}.log").read_text()[-6000:], file=sys.stderr)
            fail(f"rerun {tag}: run_golden exited {code}")
    print(f"[rerun] {len(started)} runs in fresh processes done {time.perf_counter() - t0:.1f} s "
          f"after their start", flush=True)


def compare_reruns(reruns):
    """Phase 15, second half, once the first runs exist: each rerun the same
    bits as its first run (diff_results.same_bits: results.npz's pose_est,
    psnr_list, ssim_list, lpips_proxy_list and ate_rmse np.array_equal, the
    PLY files byte-equal). Prints both runs' ATE and PSNR first."""
    from mm3dgs_slam_torch.scripts.diff_results import same_bits

    for tag, first, out, _ in reruns[0]:
        a = np.load(first / "results.npz", allow_pickle=True)
        b = np.load(out / "results.npz", allow_pickle=True)
        print(f"[rerun] {tag}: first run ATE {float(a['ate_rmse'])!r} m, PSNR "
              f"{float(np.mean(a['psnr_list']))!r} dB; rerun in a fresh process ATE "
              f"{float(b['ate_rmse'])!r} m, PSNR {float(np.mean(b['psnr_list']))!r} dB; "
              f"the same bits:", flush=True)
        if not same_bits(str(first), str(out)):
            fail(f"rerun {tag}: the rerun differs from the first run")


def imu_seed_errors(slam, tag, camera_centers):
    """Gate and print an IMU-seeded run's seeds: every frame after frame 0
    seeded, and on frames 2 on (frame 1 seeds a zero velocity) the IMU seed's
    camera-centre error against GT below that of the zero-velocity seed (the
    previous tracked pose)."""
    seeded = np.flatnonzero(~np.isnan(slam.seed_pose_list[:, 0])).tolist()
    if seeded != list(range(1, slam.n_img)):
        fail(f"{tag}: the motion model seeded frames {seeded}, not 1..{slam.n_img - 1}")
    gt_c = camera_centers(slam.gt_pose_list)[:, 4:]
    est_c = camera_centers(slam.estimate_pose_list)[:, 4:]
    seed_err = np.linalg.norm(camera_centers(slam.seed_pose_list[1:])[:, 4:] - gt_c[1:], axis=1)
    still_err = np.linalg.norm(est_c[:-1] - gt_c[1:], axis=1)
    track_err = np.linalg.norm(est_c[1:] - gt_c[1:], axis=1)
    print(f"[{tag}] per tracked frame, camera-centre error against GT (m): IMU seed "
          f"{np.array2string(seed_err, precision=5)}, zero-velocity seed "
          f"{np.array2string(still_err, precision=5)}, tracked "
          f"{np.array2string(track_err, precision=5)}", flush=True)
    if not (seed_err[1:] < still_err[1:]).all():
        fail(f"{tag}: the IMU seed is no closer to GT than the zero-velocity seed on frames 2 on")


def prior_pull(slam, camera_centers):
    """The IMU prior's own effect, apart from the run's chaos: every tracked
    frame tracked again on the final map from its seed, without and with the
    prior; on the frame that ends farthest from its seed without it (by the
    prior's weighted value), the value must end lower with it.
    The rotation term is flat within 9.8e-4 rad of the seed (rel_pose_loss's
    clamp at 1 - 1e-7, which float32 rounds to 1 - 1.2e-7), so a frame that
    tracks to within that of its seed gives the prior little to pull and its
    two values differ by Adam's last steps, either way."""
    import torch

    from mm3dgs_slam_torch.ops.losses import rel_pose_loss
    from mm3dgs_slam_torch.slam.tracker import track_frame

    ts0 = slam.track_settings

    def retrack(idx, on):
        color, depth, _, _, _ = slam.dataset[idx]
        color = torch.as_tensor(np.transpose(color, (2, 0, 1)) / 255.0, dtype=torch.float32,
                                device=slam.device)
        depth = torch.as_tensor(depth[..., 0], device=slam.device)
        seed = torch.as_tensor(slam.seed_pose_list[idx], device=slam.device)
        pose, _ = track_frame(slam.gaussians.activated(), seed, color, depth,
                              torch.zeros_like(depth), ts0._replace(use_imu_loss=on))
        if not torch.isfinite(pose).all():
            fail(f"utmm+prior: frame {idx} tracked to a non-finite pose (prior {on})")
        t_err, q_err = (float(v) for v in rel_pose_loss(pose, seed))
        c = camera_centers(np.stack([pose.cpu().numpy(), seed.cpu().numpy()]))[:, 4:]
        return (ts0.imu_T_weight * t_err + ts0.imu_q_weight * q_err, t_err ** 0.5, q_err,
                float(np.linalg.norm(c[0] - c[1])))

    both = {idx: (retrack(idx, False), retrack(idx, True)) for idx in range(1, slam.n_img)}
    for i, (off, on) in both.items():
        print(f"[utmm+prior] frame {i} tracked again on the final map from its seed, without / "
              f"with the prior: weighted prior {off[0]:.3e} / {on[0]:.3e}; |dT| "
              f"{off[1]:.5f} / {on[1]:.5f}, angle {off[2]:.5f} / {on[2]:.5f} rad, "
              f"camera centre {off[3]:.5f} / {on[3]:.5f} m from the seed's", flush=True)
    idx = max(both, key=lambda i: both[i][0][0])
    out = both[idx]
    print(f"[utmm+prior] gated on frame {idx}, the farthest from its seed without the prior",
          flush=True)
    if not out[1][0] < out[0][0]:
        fail("utmm+prior: the IMU prior did not pull the tracked pose towards its seed")


SIZE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "segments",
             "work", "walk")


def add_size_entries(rows, size_rows, key, ncs):
    """Copy check_kernels's numbers at another size (`size_rows`) into the
    kernels line's rows under `key`, with the width each entry is at."""
    for k, r in zip(rows, size_rows):
        k[key] = {f: r[f] for f in SIZE_KEYS if f in r}
        k[key]["nc"] = ncs[k["name"]]


def _ceiling_child(jobs, out_path):
    """start_ceilings's process: synthetic_recorded.ceiling_psnr of each
    (tag, config) on the CPU, written to out_path as {tag: [dB, ...]}."""
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(2)
    from mm3dgs_slam_torch.data.synthetic_recorded import ceiling_psnr

    Path(out_path).write_text(json.dumps({tag: ceiling_psnr(cfg, "cpu") for tag, cfg in jobs}))


def start_ceilings(jobs, tmp):
    """The data's own PSNR ceiling of each written sequence of `jobs` ((tag,
    config)s; printed by phases 9 and 10): one oracle render per loaded
    frame, on the CPU in a child process, while the main process writes
    the UT-MM sequence and the reruns of phase 15 hold the card (no time is
    read then). Returns the handle for wait_ceilings; the child is killed if
    the script exits first."""
    import atexit
    import multiprocessing

    out = Path(tmp) / "ceilings.json"
    p = multiprocessing.get_context("spawn").Process(target=_ceiling_child,
                                                     args=(jobs, str(out)))
    p.start()
    atexit.register(lambda: p.kill() if p.is_alive() else None)
    return p, out, time.perf_counter()


def wait_ceilings(started) -> dict:
    """start_ceilings's {tag: [dB, ...]}, once its process has ended with 0."""
    p, out, t0 = started
    p.join(timeout=max(1.0, 900.0 - (time.perf_counter() - t0)))
    if p.is_alive() or p.exitcode != 0:
        fail(f"ceiling: the ceiling PSNR process did not end with 0 ({p.exitcode})")
    print(f"[ceiling] the ceiling PSNRs done {time.perf_counter() - t0:.1f} s after their start",
          flush=True)
    return json.loads(out.read_text())


def print_ceiling(tag, ceil, cfg, slam):
    """A recorded path's ceiling PSNR per loaded frame, beside the SLAM's
    PSNR on its eval frames; the ceiling must cover every frame the SLAM
    read and be finite."""
    r = np.load(Path(cfg["outputdir"]) / "results.npz", allow_pickle=True)
    print(f"[{tag}] ceiling PSNR (each loaded frame against the oracle's render of the writing "
          f"scene at the loader's camera and GT pose) {[round(v, 3) for v in ceil]} dB, mean "
          f"{np.mean(ceil):.3f}; the SLAM's PSNR {[round(float(v), 3) for v in r['psnr_list']]}"
          f" dB, mean {float(np.mean(r['psnr_list'])):.3f}", flush=True)
    if not (len(ceil) == slam.n_img and np.isfinite(ceil).all()):
        fail(f"{tag}: the ceiling PSNR {ceil} does not cover the {slam.n_img} frames read")


def run_synthetic_yml(run, kernels, tmp, device, rows, rebins, main_cfg, ba_cfg):
    """Phase 16: configs/synthetic.yml, the repo's own config (120x160, 8
    frames, 40 / 60 iterations, tpu.rebin_every 1, NIQE keyframes, 800
    Gaussians), on the JAX package's scene of it. First the five launches
    against their plain versions on its frames 0 and 1 (kernel 1 at nc 3, 5
    and 6, kernel 2's rows and reduce at nc 3, kernel 3 at nc 5, kernel 4), their
    numbers added to the kernels line's rows as synthetic_120x160; then the
    whole config through drive, with mapping.do_BA off and then on, each
    ATE < 0.03 m and PSNR > 17 dB. Prints both ATEs, their ratio beside
    phases 8 / 4's at 640x480, and each run's PSNR, ms per iteration and
    mapping rebins. Returns the two runs' launch counts."""
    from mm3dgs_slam_torch.config import load_config
    from mm3dgs_slam_torch.data.synthetic import jax_scene_path
    from mm3dgs_slam_torch.ops.render import RenderSettings

    t0 = time.perf_counter()
    scene = str(jax_scene_path("synthetic"))
    cfg = load_config(str(ROOT / "configs" / "synthetic.yml"))
    cfg["outputdir"] = str(Path(tmp) / "out_synthetic")
    f0, f1, cam = synthetic_frames(cfg, device, scene)
    sscene = check_scene((f0, f1), RenderSettings(cam=cam), device)
    srows = check_kernels(sscene, fwd_ncs=(3, 5, 6), bwd_nc=3, pose_ncs=(5,),
                          tag="check 120x160")
    add_size_entries(rows, srows, "synthetic_120x160", {
        "composite_fwd": 5, "composite_bwd": 3, "slot_reduce": 3, "composite_pose_bwd": 5})
    add_pose_rows_entry(rows, sscene, "synthetic_120x160", "check 120x160")
    bcfg = copy.deepcopy(cfg)
    bcfg["outputdir"] = str(Path(tmp) / "out_synthetic_ba")
    bcfg["mapping"]["do_BA"] = True
    on_scene = lambda c, dev: run(c, dev, scene=scene)  # noqa: E731
    out = {}
    for tag, c in (("synthetic", cfg), ("synthetic+ba", bcfg)):
        rebins[0] = 0
        launches, _, _ = drive(on_scene, kernels, tag, c, ate_max=0.03, psnr_min=17.0)
        r = np.load(Path(c["outputdir"]) / "results.npz", allow_pickle=True)
        print(f"[{tag}] drift from GT per frame (camera centres, unaligned): "
              f"{drift_from_gt(r['pose_est'], r['pose_gt'])} m", flush=True)
        out[tag] = dict(launches=launches, ate=float(r["ate_rmse"]),
                        psnr=float(np.mean(r["psnr_list"])), rebins=rebins[0],
                        ms=(float(r["avg_tracking_it_time"]), float(r["avg_mapping_it_time"])))
    big = [float(np.load(Path(c["outputdir"]) / "results.npz")["ate_rmse"])
           for c in (main_cfg, ba_cfg)]
    a, b = out["synthetic"], out["synthetic+ba"]
    print(f"[synthetic] configs/synthetic.yml {cfg['desired_width']}x{cfg['desired_height']} on "
          f"the JAX scene, {cfg['synthetic']['n_frames']} frames, "
          f"{cfg['tracking']['iters']}/{cfg['mapping']['iters']} iterations: ATE without BA "
          f"{a['ate']!r} m, with BA {b['ate']!r} m, ratio {b['ate'] / a['ate']:.4f} (640x480, "
          f"phases 8 / 4: {big[1] / big[0]:.4f}); PSNR {a['psnr']:.3f} / {b['psnr']:.3f} dB; ms "
          f"per tracking / mapping iteration {a['ms'][0]:.3f} / {a['ms'][1]:.3f} without BA, "
          f"{b['ms'][0]:.3f} / {b['ms'][1]:.3f} with; mapping rebins {a['rebins']} / "
          f"{b['rebins']}", flush=True)
    lockstep_frame5(bcfg, scene, device)
    print(f"[synthetic] phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    return a["launches"], b["launches"]


def drift_from_gt(pose_est, pose_gt) -> list:
    """Per-frame distance of the estimated camera centres from GT, m."""
    from mm3dgs_slam_torch.eval.ate import camera_centers

    d = np.linalg.norm(camera_centers(pose_est)[:, 4:] - camera_centers(pose_gt)[:, 4:], axis=1)
    return [float(f"{v:.4g}") for v in d]


def lockstep_frame5(bcfg, scene, device):
    """Phase 16's lockstep: the JAX package's whole state after frame 4 of
    configs/synthetic.yml with BA (mm3dgs_slam_torch/assets/
    jax_state_synthetic_ba_f4.npz) restored into a port SLAM on the card,
    which steps frame 5; so does a second one with fx and fy one float32 ulp
    up. Prints the record of each beside JAX's (tests/lockstep.py's table,
    `[synthetic lockstep f5]` lines) and gates the keyframe decision, the
    keyframe and the BA window on JAX's, and every pose of the frame within
    LOCKSTEP_POSE_ATOL of JAX's."""
    sys.path.insert(0, str(ROOT / "tests"))
    from lockstep import POSES, read_asset, step_recorded, table

    from mm3dgs_slam_torch.data.synthetic import load_scene
    from mm3dgs_slam_torch.slam.slam import SLAM
    from mm3dgs_slam_torch.slam.state import restore_state

    t0 = time.perf_counter()
    state, jax_rec = read_asset(ROOT / "mm3dgs_slam_torch" / "assets" /
                                "jax_state_synthetic_ba_f4.npz")
    recs = {"jax": jax_rec}
    frame = recs["jax"]["frame"]
    for tag, move in (("card", False), ("card_ulp", True)):
        c = copy.deepcopy(bcfg)
        c["outputdir"] = f"{bcfg['outputdir']}_lockstep_{tag}"
        if move:
            for k in ("fx", "fy"):
                c["cam"][k] = float(np.nextafter(np.float32(c["cam"][k]), np.float32(np.inf)))
        slam = SLAM(c, device=device, scene=load_scene(scene))
        restore_state(slam, state)
        t1 = time.perf_counter()
        recs[tag] = step_recorded(slam, frame)
        print(f"[synthetic lockstep f5] {tag}: frame {frame} in {time.perf_counter() - t1:.2f} s",
              flush=True)
        slam._frames.close()
    lines, gaps = table(recs, (("card - JAX", "card", "jax"),
                               ("card - card 1ulp", "card", "card_ulp")),
                        "synthetic lockstep f5")
    print("\n".join(lines), flush=True)
    for k in ("kf_decision", "keyframe", "window_frames"):
        if not gaps[("card - JAX", k)][0]:
            fail(f"lockstep f5: {k} {recs['card'][k]} on the card, {recs['jax'][k]} in JAX")
    pose_gap = max(gaps[("card - JAX", k)][1] for k in POSES)
    print(f"[synthetic lockstep f5] the frame's poses within {pose_gap:.3e} of JAX's (bound "
          f"{LOCKSTEP_POSE_ATOL:.1e}); the lockstep {time.perf_counter() - t0:.1f} s", flush=True)
    if not pose_gap <= LOCKSTEP_POSE_ATOL:
        fail(f"lockstep f5: poses {pose_gap} from JAX's, above {LOCKSTEP_POSE_ATOL}")


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
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from mm3dgs_slam_torch.__main__ import run
    from mm3dgs_slam_torch.config import load_config
    from mm3dgs_slam_torch.data.synthetic import jax_scene_path
    from mm3dgs_slam_torch.scripts import run_golden
    from mm3dgs_slam_torch.eval.ate import camera_centers
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
    sources = {k.source: k.ptxas_log for k in kernels.KERNELS}
    print(f"[build] {time.perf_counter() - t0:.1f} s for {len(kernels.KERNELS)} entry points "
          f"in {len(sources)} sources (nvcc in parallel)", flush=True)
    for source, log in sources.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {source}: {line.strip()}")

    from mm3dgs_slam_torch.data.synthetic_recorded import (write_synthetic_replica,
                                                           write_synthetic_tum)
    from mm3dgs_slam_torch.data.synthetic_utmm import write_synthetic_utmm
    from mm3dgs_slam_torch.ops.render import RenderSettings

    cfg = load_config(str(ROOT / "configs" / "synthetic_tum.yml"))
    cfg["synthetic"]["n_frames"] = N_FRAMES
    reuse_synthetic_frames()
    # the JAX package's scene of synthetic_tum.yml: phases 3, 4, 7, 8 and 13
    scene_npz = str(jax_scene_path("synthetic_tum"))

    # phase 3: kernels against their plain versions, on phase 4's frames 0 and 1
    f0, f1, cam = synthetic_frames(cfg, device, scene_npz)
    scene = check_scene((f0, f1), RenderSettings(cam=cam), device)
    rows = check_kernels(scene)
    bench_bins = check_bench_bins(device)
    next(k for k in rows if k["name"] == "slot_reduce")["bench_bins"] = bench_bins
    ba_rel = check_ba_chain(scene)
    # phase 3d: the three kernels over the tile windows of 2 and 7 ranks
    t0 = time.perf_counter()
    windowed = check_windows(scene)
    for k in rows:
        k["windowed_640x480"] = windowed[k["name"]]
    print(f"[check 3d] {time.perf_counter() - t0:.1f} s", flush=True)
    rows.append(check_pose_rows(scene))
    del scene

    with tempfile.TemporaryDirectory() as tmp:
        # the configs of phases 4 and 8, whose runs phase 15 repeats in fresh
        # processes: started here, while the UT-MM and Replica sequences are
        # written
        cfg = run_golden.golden_config(str(ROOT / "configs" / "synthetic_tum.yml"),
                                       str(Path(tmp) / "out_main"), decomp=True,
                                       frames=N_FRAMES)
        bcfg = load_config(str(ROOT / "configs" / "synthetic_tum.yml"))
        bcfg["synthetic"]["n_frames"] = N_FRAMES
        bcfg.update(outputdir=str(Path(tmp) / "out_ba"), save_iterations=[3])
        bcfg["mapping"]["do_BA"] = True
        reruns = start_reruns([("main", cfg, scene_npz), ("ba", bcfg, scene_npz)], tmp)

        # the TUM sequence of phase 9, at TUM.yml's native 640x480
        tcfg = load_config(str(ROOT / "configs" / "TUM.yml"))
        tcfg.update(inputdir=str(Path(tmp) / "tum"), scene="synthetic",
                    outputdir=str(Path(tmp) / "out_tum"), dpt_model="tiny_dpt",
                    dpt_weights=str(ROOT / "assets" / "tiny_dpt_synthetic.npz"),
                    synthetic=dict(n_gaussians=RECORDED_GAUSSIANS, seed=1, orbit_radius=0.12))
        t0 = time.perf_counter()
        write_synthetic_tum(str(Path(tcfg["inputdir"]) / tcfg["scene"]), tcfg, SHORT_FRAMES,
                            device=device)
        print(f"[tum] wrote {SHORT_FRAMES} frames at {tcfg['cam']['image_width']}x"
              f"{tcfg['cam']['image_height']} ({RECORDED_GAUSSIANS} gaussians) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # the Replica sequence of phases 3c and 10, at replica.yml's native
        # 1200x680 (the loader reads it at 600x340)
        rcfg = load_config(str(ROOT / "configs" / "replica.yml"))
        rcfg.update(inputdir=str(Path(tmp) / "replica"), scene="synthetic",
                    outputdir=str(Path(tmp) / "out_replica"),
                    synthetic=dict(n_gaussians=RECORDED_GAUSSIANS, seed=1, orbit_radius=0.12))
        rcfg["debug"]["save_keyframes"] = True
        t0 = time.perf_counter()
        write_synthetic_replica(str(Path(rcfg["inputdir"]) / rcfg["scene"]), rcfg,
                                REPLICA_FRAMES, device=device)
        print(f"[replica] wrote {REPLICA_FRAMES} frames at {rcfg['cam']['image_width']}x"
              f"{rcfg['cam']['image_height']} ({RECORDED_GAUSSIANS} gaussians, JPEG) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ceilings = start_ceilings([("tum", tcfg), ("replica", rcfg)], tmp)

        # the UT-MM sequence of phases 3b and 5, at UTMM.yml's native size
        ucfg = load_config(str(ROOT / "configs" / "UTMM.yml"))
        ucfg.update(inputdir=str(Path(tmp) / "utmm"), scene="synthetic",
                    outputdir=str(Path(tmp) / "out_utmm"),
                    synthetic=dict(n_gaussians=UTMM_GAUSSIANS, seed=1, orbit_radius=0.12))
        ucfg["debug"]["get_runtime_stats"] = True
        t0 = time.perf_counter()
        write_synthetic_utmm(str(Path(ucfg["inputdir"]) / ucfg["scene"]), ucfg, UTMM_FRAMES,
                             device=device)
        print(f"[utmm] wrote {UTMM_FRAMES} frames at {ucfg['cam']['image_width']}x"
              f"{ucfg['cam']['image_height']} ({UTMM_GAUSSIANS} gaussians, 30 fps, 100 Hz "
              f"IMU) in {time.perf_counter() - t0:.1f} s", flush=True)

        # the reruns of phase 15 and the ceilings end before any time is read again
        wait_reruns(reruns)
        ceil = wait_ceilings(ceilings)

        # phase 3b: the kernels at 640x330, at the widths of the UT-MM path
        u0, u1, ucam = dataset_frames(ucfg)
        urs = RenderSettings(cam=ucam, force_isotropic=ucfg["pipeline"]["force_isotropic"])
        uscene = check_scene((u0, u1), urs, device)
        urows = check_kernels(uscene, fwd_ncs=(4, 5), bwd_nc=4, pose_ncs=(5,),
                              tag="check 640x330")
        add_size_entries(rows, urows, "utmm_640x330", {
            "composite_fwd": 5, "composite_bwd": 4, "slot_reduce": 4, "composite_pose_bwd": 5})
        add_pose_rows_entry(rows, uscene, "utmm_640x330", "check 640x330")
        del uscene

        # phase 3c: the kernels at 600x340, with its partial tile column
        t0 = time.perf_counter()
        r0, r1, rcam = dataset_frames(rcfg)
        rscene = check_scene((r0, r1), RenderSettings(cam=rcam), device)
        rrows = check_kernels(rscene, fwd_ncs=(3, 4, 5), bwd_nc=4, pose_ncs=(5,),
                              tag="check 600x340")
        add_size_entries(rows, rrows, "replica_600x340", {
            "composite_fwd": 5, "composite_bwd": 4, "slot_reduce": 4, "composite_pose_bwd": 5})
        add_pose_rows_entry(rows, rscene, "replica_600x340", "check 600x340")
        del rscene
        print(f"[check 600x340] {time.perf_counter() - t0:.1f} s", flush=True)

        # phase 4: the main path, through run_golden on the JAX package's
        # scene of synthetic_tum.yml, with the frame decomposition
        on_scene = lambda c, dev: run(c, dev, scene=scene_npz)  # noqa: E731
        rebins = count_map_rebins()
        launches, main_slam, _ = drive(on_scene, kernels, "main", cfg, ate_max=0.03,
                                       psnr_min=17.0, extra_keys=DECOMP_KEYS)
        check_decomp(main_slam, cfg)
        main_rebins = rebins[0]
        main_ms_it = float(np.load(Path(cfg["outputdir"]) / "results.npz")["avg_mapping_it_time"])

        # phase 14: the sharded map on two ranks sharing the card, under torchrun
        t0 = time.perf_counter()
        mesh_paths = run_mesh(scene_npz, Path(tmp) / "out_mesh2", cfg)
        print(f"[mesh2] phase 14: {time.perf_counter() - t0:.1f} s", flush=True)

        # phase 5: the UT-MM path (IMU seed, Pearson terms, 640x330)
        utmm, slam, _ = drive(run, kernels, "utmm", ucfg, ate_max=0.03, psnr_min=17.0)
        imu_seed_errors(slam, "utmm", camera_centers)

        # phase 5b: the same sequence with the IMU pose prior on, at
        # tests/test_e2e_imu.py's weights (UTMM.yml leaves it off)
        pcfg = copy.deepcopy(ucfg)
        pcfg["outputdir"] = str(Path(tmp) / "out_utmm_prior")
        pcfg["early_stop_idx"] = 2 * SHORT_FRAMES   # stride 2
        pcfg["tracking"].update(use_imu_loss=True, **IMU_PRIOR_WEIGHTS)
        prior, pslam, _ = drive(run, kernels, "utmm+prior", pcfg, ate_max=0.03, psnr_min=17.0)
        imu_seed_errors(pslam, "utmm+prior", camera_centers)
        prior_pull(pslam, camera_centers)

        # phase 6: the monocular path
        mcfg = load_config(str(ROOT / "configs" / "synthetic_tum.yml"))
        mcfg["synthetic"]["n_frames"] = SHORT_FRAMES
        mcfg.update(use_gt_depth=False, dpt_model="synthetic_affine",
                    outputdir=str(Path(tmp) / "out_mono"))
        for blk in ("tracking", "mapping"):
            mcfg[blk]["use_depth_estimate_loss"] = True
        mono, _, _ = drive(run, kernels, "mono", mcfg, ate_max=0.06, psnr_min=15.0)

        # phase 7: splatam (tracking at nc 6, mapping at nc 4), with the
        # debug video on
        scfg = load_config(str(ROOT / "configs" / "synthetic_tum.yml"))
        scfg["synthetic"]["n_frames"] = N_FRAMES
        scfg.update(method="splatam", outputdir=str(Path(tmp) / "out_splatam"))
        scfg["debug"]["create_video"] = True
        splatam, sslam, s_by_nc = drive(on_scene, kernels, "splatam", scfg, ate_max=0.03,
                                        psnr_min=17.0)
        check_splatam(sslam, s_by_nc, scfg)

        # phase 8: bundle adjustment, a checkpoint at frame 3, then the
        # port resumed from it
        rebins[0] = 0
        ba, bslam, _ = drive(on_scene, kernels, "ba", bcfg, ate_max=0.03, psnr_min=17.0)
        ba_ms_it = float(np.load(Path(bcfg["outputdir"]) / "results.npz")["avg_mapping_it_time"])
        check_ba(bslam, rebins[0], ba_ms_it, main_rebins, main_ms_it)
        check_resume(bcfg, bslam, scene_npz)

        # phase 9: TUM (monocular, TinyDPT, crop_edge 8, tum_heuristic)
        t0 = time.perf_counter()
        tum, tslam, _ = drive(run, kernels, "tum", tcfg, ate_max=0.06, psnr_min=15.0)
        print_ceiling("tum", ceil["tum"], tcfg, tslam)
        print(f"[tum] phase 9: {time.perf_counter() - t0:.1f} s", flush=True)

        # phase 10: Replica (GT depth, 600x340), keyframe PNGs on
        t0 = time.perf_counter()
        replica, rslam, _ = drive(run, kernels, "replica", rcfg, ate_max=0.03, psnr_min=17.0)
        print_ceiling("replica", ceil["replica"], rcfg, rslam)
        print(f"[replica] keyframes {[kf.idx for kf in rslam.mapper.keyframes]}; phase 10: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # phase 11: the eval CLIs on phase 10's output
        check_eval_clis(rcfg)

        # phase 12: the bench, in its own process
        bench = run_bench()

        # phase 13: the tools on phase 4's run
        check_tools(cfg, main_slam, scene_npz, tmp, kernels)

        # phase 16: configs/synthetic.yml on its JAX scene, BA off and on
        syn, syn_ba = run_synthetic_yml(run, kernels, tmp, device, rows, rebins, cfg, bcfg)

        # phase 15: phase 4's and phase 8's runs against their reruns
        compare_reruns(reruns)

    paths = {"synthetic_tum": launches, "utmm": utmm, "utmm_prior": prior, "mono": mono,
             "splatam": splatam, "ba": ba, "tum": tum, "replica": replica,
             "synthetic_yml": syn, "synthetic_yml_ba": syn_ba,
             "bench_track": bench["detail"]["launches"]["track"],
             "bench_map": bench["detail"]["launches"]["map"]}
    print(f"[launches] per path: {paths}; splatam by nc {s_by_nc}", flush=True)
    for k in rows:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        k["launches_windowed_by_path"] = {p: c[k["name"]] for p, c in mesh_paths.items()
                                          if k["name"] in c}
        if k["name"] == "composite_pose_bwd":
            k["nc6"]["launches_splatam"] = s_by_nc[k["name"]].get(6, 0)
        if k["name"] == "composite_bwd":
            k["ba_pose_grad_err_of_abs_sum"] = ba_rel
    print(f"[time] the script took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
