"""Headline benchmark of the port: tracking + mapping frames/s on one card
(JAX counterpart: bench.py at the repository root, the same workload and the
same one JSON line).

    python -m mm3dgs_slam_torch.bench

The reference's iteration budget (100 tracking + 150 mapping Adam iterations
per frame) at 640x480 on a synthetic map of 131,072 pixel-scale surfels
(`__graft_entry__._build_scene`'s distributions: fx = fy = 70, z ~ U(1.5, 5),
pixel-uniform x and y, isotropic log-scale log(z / 70), logit-0 opacity,
uniform RGB, drawn from numpy), end to end: render, loss, backward, Adam,
with the JAX bench's settings (vigs tracking with GT depth, rebin_every 10;
mapping over K = 8 keyframes of the same GT with the grouped schedule,
rebin_every 25). Each timed call ends in `torch.cuda.synchronize()`; the
median of 5 reps after 2 warm-ups is kept, each rep's inputs varied (the
tracking seed by 1e-3 (i + 1) in T_x, the keyframe poses by 1e-4 (i + 1)).

First a kernel check (the JAX bench's `kernel_grad_check`), on a 2,048-Gaussian
120x160 scene: kernel 1 against its plain version, kernel 2's opacity
gradient (its dpacked chained through the projection) and kernel 3's per-tile
partials and dq/dT at nc 5 and 6, at chip_smoke.py phase 3's tolerances. A
miss exits non-zero before anything is timed. Without a card `main` exits
non-zero; the building blocks (`build_scene`, `make_inputs`, `track_once`,
`map_once`) take a device, so they also run on the CPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"};
detail holds ms per tracking and mapping iteration, every rep's seconds, the
launches of each kernel in one tracking and one mapping call, the kernel
check's errors, and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from .models import gaussians as G
from .ops import composite as plain
from .ops import kernels
from .ops.binning import build_bins
from .ops.camera import Camera
from .ops.projection import conic_pose_jacobian_rows
from .ops.render import (RenderSettings, background, effective_scales, from_tiles,
                         means_cam_soa, pose_grads_from_partials, project_for_pose, render,
                         tile_pixel_valid)
from .ops.sh import rgb_to_sh
from .ops.tolerances import GRAD_TOL, IMG_TOL, PARTIAL_ATOL, POSE_TOL
from .slam.map_opt import MapOptSettings, MapState, optimize_map
from .slam.tracker import TrackSettings, track_frame

N_GAUSSIANS = 1 << 17      # ~131k live Gaussians (a mapped room)
H, W = 480, 640
TRACK_ITERS = 100
MAP_ITERS = 150
BASELINE_FPS = 30.0        # north star: real-time tracking + mapping
REPS, WARM = 5, 2
K = 8                      # mapping window: keyframes of the same GT
EXTENT = 10.0
IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
HYPER = G.MapOptHyper(lr_xyz=1e-4, lr_features_dc=2.5e-3, lr_features_rest=1.25e-4,
                      lr_scaling=1e-3, lr_rotation=1e-3, lr_opacity=5e-2, lr_rgb=2.5e-3)


class KernelCheckError(Exception):
    """A kernel disagrees with its plain version."""


def _require(ok: bool, msg: str):
    if not ok:
        raise KernelCheckError(msg)


def draw_scene_arrays(n: int, cam_hw, seed: int = 0) -> dict:
    """The scene's random draws (z, px, py, rgb) from numpy, float32."""
    h, w = cam_hw
    rng = np.random.default_rng(seed)
    out = dict(z=rng.uniform(1.5, 5.0, n), px=rng.uniform(0.0, w, n),
               py=rng.uniform(0.0, h, n), rgb=rng.uniform(0.0, 1.0, (n, 3)))
    return {k: v.astype(np.float32) for k, v in out.items()}


def build_scene(n: int, cam_hw=(64, 80), seed: int = 0, arrays: dict | None = None,
                device="cuda"):
    """(GaussianMap of n rows, Camera): pixel-scale surfels with logit-0
    opacity, what the mapper's new-Gaussian init makes (projective scale
    z / f). `arrays` (z, px, py, rgb) replaces the numpy draws."""
    h, w = cam_hw
    cam = Camera(height=h, width=w, fx=70.0, fy=70.0, cx=w / 2 - 0.5, cy=h / 2 - 0.5)
    a = draw_scene_arrays(n, cam_hw, seed) if arrays is None else arrays
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in a.items()}
    z = t["z"]
    xyz = torch.stack([(t["px"] - cam.cx) / cam.fx * z, (t["py"] - cam.cy) / cam.fy * z, z], -1)
    log_scale = torch.log(z / ((cam.fx + cam.fy) / 2.0))
    zeros = lambda *s: torch.zeros((n,) + s, dtype=torch.float32, device=device)  # noqa: E731
    rot = zeros(4)
    rot[:, 0] = 1.0
    m = G.GaussianMap(xyz=xyz, features_dc=rgb_to_sh(t["rgb"])[:, None, :],
                      features_rest=zeros(1, 3), scaling=log_scale[:, None].expand(n, 3).clone(),
                      rotation=rot, opacity=zeros(1), rgb=zeros(3))
    return m, cam


def make_inputs(m: G.GaussianMap, cam: Camera):
    """The GT of the identity pose: (render settings, base pose, colour
    clipped to [0, 1] [3, H, W], depth = z / max(silhouette, 1e-6) [H, W])."""
    rs = RenderSettings(cam=cam)
    base = torch.tensor(IDENTITY, dtype=torch.float32, device=m.xyz.device)
    with torch.no_grad():
        out = render(m.activated(), base, rs)
    gt_color = torch.clamp(out["render"], 0, 1)
    gt_depth = out["depth"][0] / torch.clamp(out["depth"][1], min=1e-6)
    return rs, base, gt_color, gt_depth


def track_once(m: G.GaussianMap, inputs, i: int, iters: int = TRACK_ITERS):
    """One tracking call from the base pose jittered by 1e-3 (i + 1) in T_x:
    (pose, last loss)."""
    rs, base, gt_color, gt_depth = inputs
    seed = base.clone()
    seed[4] += 1e-3 * (i + 1)
    ts = TrackSettings(rs=rs, iters=iters, method="vigs", use_gt_depth=True,
                       position_lr=0.001, rotation_lr=0.003, rebin_every=10)
    return track_frame(m.activated(), seed, gt_color, gt_depth, torch.zeros_like(gt_depth), ts)


def map_once(m: G.GaussianMap, inputs, i: int, iters: int = MAP_ITERS, k: int = K):
    """One mapping call over k keyframes of the GT, their poses the base
    moved by 1e-4 (i + 1) in T_x, fresh Adam and statistics, the grouped
    schedule sort(arange(iters) % k), extent 10: the MapState after it."""
    rs, base, gt_color, gt_depth = inputs
    poses = base[None].repeat(k, 1)
    poses[:, 4] += 1e-4 * (i + 1)
    colors = gt_color[None].expand(k, -1, -1, -1).contiguous()
    depths = gt_depth[None].expand(k, -1, -1).contiguous()
    z = torch.zeros((m.n,), dtype=torch.float32, device=m.xyz.device)
    schedule = np.sort(np.arange(iters, dtype=np.int32) % k)
    st = MapState(m, G.init_adam(m), z, z.clone(), z.clone())
    ms = MapOptSettings(rs=rs, iters=iters, method="vigs", use_gt_depth=True,
                        lambda_dssim=0.2, hyper=HYPER, rebin_every=25)
    return optimize_map(st, colors, depths, torch.zeros_like(depths), poses, schedule,
                        EXTENT, ms)


def _close(got, want, atol, rtol):
    """(max |got - want|, all within atol + rtol |want|)."""
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def kernel_check(device="cuda") -> dict:
    """Kernels 1-3 against their plain versions on the card, on a
    2,048-Gaussian 120x160 scene at the identity pose. Raises
    KernelCheckError on a miss; returns the largest errors."""
    m, cam = build_scene(1 << 11, (120, 160), device=device)
    rs = RenderSettings(cam=cam)
    pose = torch.tensor(IDENTITY, dtype=torch.float32, device=device)
    opacity = m.opacity.clone().requires_grad_(True)
    g = m._replace(opacity=opacity).activated()
    proj = project_for_pose(g, pose, rs)
    with torch.no_grad():
        bins = build_bins(proj, cam)
    packed = proj.packed
    args = (bins.pair_gauss, bins.tile_start, bins.tile_count, cam)
    out = {}

    # kernel 1 and kernel 2 at the mapping width: loss = sum_c (c + 1) img_c
    nc = 3
    pk = packed.detach().contiguous()
    acc_k, tfin_k = kernels.composite_fwd(pk, *args, nc)
    acc_p, tfin_p = plain.composite_fwd_plain(pk, *args, nc)
    out["fwd_err"], ok = _close(acc_k, acc_p, **IMG_TOL)
    _require(ok, f"kernel 1 disagrees with its plain version: {out['fwd_err']:.3e}")
    a = acc_k.clone().requires_grad_(True)
    tf = tfin_k.clone().requires_grad_(True)
    img = from_tiles(a + tf * background(rs, device)[:nc][None, :, None], cam)
    w = torch.arange(1.0, nc + 1.0, device=device)[:, None, None]
    dacc, dtfin = torch.autograd.grad((img * w).sum(), (a, tf))
    gargs = (pk, *args[:3], acc_k, tfin_k, dacc, dtfin, cam, nc)
    d_k, d_p = kernels.composite_bwd(*gargs), plain.composite_bwd_plain(*gargs)
    (g_k,) = torch.autograd.grad(packed, opacity, d_k, retain_graph=True)
    (g_p,) = torch.autograd.grad(packed, opacity, d_p)
    out["opacity_grad_err"], ok = _close(g_k, g_p, **GRAD_TOL)
    out["opacity_grad_max"] = float(g_p.abs().max())
    _require(ok, f"kernel 2's opacity gradient disagrees: {out['opacity_grad_err']:.3e}")

    # kernel 3 at both tracking widths: loss = sum |out| over valid pixels
    with torch.no_grad():
        g = m.activated()
        packed32 = torch.cat([pk, conic_pose_jacobian_rows(
            means_cam_soa(g.xyz, pose), effective_scales(g.scales, rs), g.rotations, g.xyz,
            cam)], 1).contiguous()
    valid = tile_pixel_valid(cam, device)[:, None, :]
    for nc in (5, 6):
        with torch.no_grad():
            acc, tfin = kernels.composite_fwd(packed32, *args, nc)
        a = acc.clone().requires_grad_(True)
        tf = tfin.clone().requires_grad_(True)
        res = a + tf * background(rs, device)[:nc][None, :, None]
        dacc, dtfin = torch.autograd.grad((res.abs() * valid).sum(), (a, tf))
        pargs = (packed32, *args[:3], acc, tfin, dacc, dtfin, cam, nc)
        psum_k = kernels.composite_pose_bwd(*pargs)
        psum_p, asum = plain.composite_pose_bwd_plain(*pargs, abs_sum=True)
        err_t, ok_t = _close(psum_k, psum_p, PARTIAL_ATOL * asum, GRAD_TOL["rtol"])
        gk = torch.cat(pose_grads_from_partials(psum_k, pose[:4]))
        gp = torch.cat(pose_grads_from_partials(psum_p, pose[:4]))
        err, ok = _close(gk, gp, **POSE_TOL)
        out[f"pose_partials_err_nc{nc}"], out[f"dq_dT_err_nc{nc}"] = err_t, err
        _require(ok_t and ok, f"kernel 3 at nc {nc} disagrees: partials {err_t:.3e}, "
                              f"dq/dT {err:.3e}")
    return out


def power_limit() -> tuple[str, float | None]:
    """nvidia-smi's name/power-limit line and the limit in W (None if unread)."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    try:
        return line, float(line.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        return line, None


def _timed(fn) -> float:
    """Host seconds of fn(), the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); the bench "
              "times the card and has no CPU mode", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi, watts = power_limit()
    try:
        check = kernel_check(device)
    except KernelCheckError as e:
        print(f"bench: kernel check failed: {e}", file=sys.stderr)
        return 1

    m, cam = build_scene(N_GAUSSIANS, (H, W), device=device)
    inputs = make_inputs(m, cam)
    launches = {}
    track_s = []
    for i in range(REPS + WARM):
        kernels.reset_launch_counts()
        track_s.append(_timed(lambda: track_once(m, inputs, i)))
    launches["track"] = kernels.launch_counts()
    map_s = []
    for i in range(REPS + WARM):
        kernels.reset_launch_counts()
        map_s.append(_timed(lambda: map_once(m, inputs, i)))
    launches["map"] = kernels.launch_counts()
    track_med = sorted(track_s[WARM:])[REPS // 2]
    map_med = sorted(map_s[WARM:])[REPS // 2]
    fps = 1.0 / (track_med + map_med)
    print(json.dumps({
        "metric": "synthetic_640x480_track100+map150_fps",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "detail": {
            "track_ms_per_iter": track_med / TRACK_ITERS * 1e3,
            "map_ms_per_iter": map_med / MAP_ITERS * 1e3,
            "n_gaussians": N_GAUSSIANS,
            "track_s": track_s, "map_s": map_s, "warm": WARM,
            "launches": launches,
            "kernel_check": check,
            "device": torch.cuda.get_device_name(device), "nvidia_smi": smi,
            "power_limit_w": watts,
            "torch": torch.__version__, "cuda": torch.version.cuda,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
