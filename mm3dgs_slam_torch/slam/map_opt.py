"""Map optimization: the mapper's inner loop (JAX counterpart:
slam/map_opt.py:457 `optimize_map`; reference slam/mapper.py:718-950).

Per iteration: render the scheduled keyframe in tile layout at nc = 3
(JAX map_opt.py:150-207) -> (1-lambda) L1 + lambda (1 - SSIM) on the
assembled rgb -> gradients through kernel 2 -> torch-semantics Adam over
every map leaf. Reproduced semantics, quirks included:

  * bins are rebuilt exactly where the JAX `plan_segments` cuts: prune
    iterations, keyframe switches and every `rebin_every` iterations of a
    run on one keyframe,
  * max_radii2D and the densification stats update every iteration while
    iteration <= densify_until_iter (mapper.py:887-898); the xy gradient
    reaches them through a zero `screen_offset` added to the projected xy
    (JAX map_opt.py:142-145),
  * pruning at i >= densify_from_iter and i % pruning_interval == 0 (and
    i <= densify_until_iter); the reference swaps its torch parameters
    during prune, which orphans that iteration's gradients, so the map
    Adam step is a no-op on prune iterations (mapper.py:900-909).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.gaussians import (AdamState, GaussianMap, MapOptHyper, adam_update,
                                prune_compact, prune_mask_reference)
from ..ops.binning import build_bins
from ..ops.losses import l1_loss, pearson_loss, ssim
from ..ops.render import (RenderSettings, background, composite_packed, from_tiles,
                          project_for_pose, tile_pixel_valid, to_tiles)


class MapOptSettings(NamedTuple):
    rs: RenderSettings
    iters: int
    use_gt_depth: bool = True
    use_depth_estimate_loss: bool = False
    pearson_weight: float = 0.0
    lambda_dssim: float = 0.2
    min_opacity: float = 0.005
    size_threshold: float | None = 100.0
    pruning_interval: int = 50
    densify_from_iter: int = 0
    densify_until_iter: int = 50
    hyper: MapOptHyper | None = None
    rebin_every: int = 1


class MapState(NamedTuple):
    m: GaussianMap
    adam: AdamState
    max_radii: torch.Tensor   # [N] f32
    grad_accum: torch.Tensor  # [N] f32 (xyz_gradient_accum)
    denom: torch.Tensor       # [N] f32
    last_loss: float = 0.0


def map_loss(m: GaussianMap, screen_offset, pose, gt_color, gt_depth, est_depth,
             bins, ms: MapOptSettings):
    """Loss and (radius, visible) for one keyframe; differentiable in the
    map leaves and `screen_offset` [N, 2]."""
    rs = ms.rs
    proj = project_for_pose(m.activated(), pose, rs)
    packed = torch.cat([proj.packed[:, :2] + screen_offset, proj.packed[:, 2:]], dim=1)
    nc = 4 if ms.use_depth_estimate_loss else 3
    acc, tfin = composite_packed(packed, bins, rs.cam, nc)
    out_t = acc + tfin * background(rs, acc.device)[:nc][None, :, None]
    image = from_tiles(out_t[:, :3], rs.cam)
    lam = ms.lambda_dssim
    loss = (1 - lam) * l1_loss(image, gt_color) + lam * (1.0 - ssim(image, gt_color))
    if ms.use_depth_estimate_loss:
        depth_t = out_t[:, 3]
        valid = tile_pixel_valid(rs.cam, acc.device)
        if ms.use_gt_depth:
            gt_depth_t = to_tiles(gt_depth, rs.cam)
            loss = loss + ms.pearson_weight * pearson_loss(
                depth_t, gt_depth_t, mask=(gt_depth_t > 0) & valid, invert_estimate=False)
        else:
            loss = loss + ms.pearson_weight * pearson_loss(
                depth_t, to_tiles(est_depth, rs.cam), mask=valid, invert_estimate=False)
    return loss, proj.radius, proj.radius > 0


def _map_bins(m: GaussianMap, pose, ms: MapOptSettings):
    with torch.no_grad():
        return build_bins(project_for_pose(m.activated(), pose, ms.rs), ms.rs.cam)


def _grad_and_stats(st: MapState, bins, pose, i, gt_color, gt_depth, est_depth,
                    ms: MapOptSettings):
    """One iteration's loss, map gradients and densification-stats update."""
    leaves = [t.detach().requires_grad_(True) for t in st.m]
    m = GaussianMap(*leaves)
    screen = torch.zeros((m.n, 2), dtype=torch.float32, device=m.xyz.device,
                         requires_grad=True)
    loss, radii, visible = map_loss(m, screen, pose, gt_color, gt_depth, est_depth, bins, ms)
    grads = torch.autograd.grad(loss, leaves + [screen], allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves + [screen], grads)]
    gm, g_screen = GaussianMap(*grads[:-1]), grads[-1]
    if i <= ms.densify_until_iter:
        max_radii = torch.where(visible, torch.maximum(st.max_radii, radii.to(torch.float32)),
                                st.max_radii)
        grad_accum = st.grad_accum + torch.where(visible, torch.linalg.norm(g_screen, dim=-1), 0.0)
        denom = st.denom + visible.to(torch.float32)
    else:
        max_radii, grad_accum, denom = st.max_radii, st.grad_accum, st.denom
    return loss.detach(), gm, max_radii, grad_accum, denom


def is_prune_iter(i: int, ms: MapOptSettings) -> bool:
    return (i >= ms.densify_from_iter and i % ms.pruning_interval == 0
            and i <= ms.densify_until_iter)


def plan_segments(schedule, ms: MapOptSettings):
    """("prune"|"opt", keyframe slot, first iteration, length) runs: cut at
    prune iterations, keyframe switches and every `rebin_every` iterations
    (JAX map_opt.py:433-455). Bins are built once per segment."""
    sched = np.asarray(schedule)
    rebin = max(int(ms.rebin_every), 1)
    segs, i = [], 0
    while i < len(sched):
        if is_prune_iter(i, ms):
            segs.append(("prune", int(sched[i]), i, 1))
            i += 1
            continue
        j = i + 1
        while (j < len(sched) and j - i < rebin and sched[j] == sched[i]
               and not is_prune_iter(j, ms)):
            j += 1
        segs.append(("opt", int(sched[i]), i, j - i))
        i = j
    return segs


def optimize_map(st: MapState, kf_colors, kf_depths, kf_ests, kf_poses, schedule,
                 camera_extent: float, ms: MapOptSettings) -> MapState:
    """Run the scheduled iterations. kf_colors [K, 3, H, W], kf_depths and
    kf_ests [K, H, W], kf_poses [K, 7]; `schedule` [iters] indexes K."""
    for kind, k, base_i, n in plan_segments(schedule, ms):
        pose = kf_poses[k]
        bins = _map_bins(st.m, pose, ms)
        for i in range(base_i, base_i + n):
            loss, gm, max_radii, grad_accum, denom = _grad_and_stats(
                st, bins, pose, i, kf_colors[k], kf_depths[k], kf_ests[k], ms)
            if kind == "prune":
                pmask = prune_mask_reference(st.m, camera_extent, ms.min_opacity,
                                             max_radii, ms.size_threshold)
                m, adam, idx = prune_compact(st.m, st.adam, ~pmask)
                st = MapState(m, adam, max_radii[idx], grad_accum[idx], denom[idx], loss)
            else:
                with torch.no_grad():
                    m, adam = adam_update(st.m, gm, st.adam, ms.hyper)
                st = MapState(m, adam, max_radii, grad_accum, denom, loss)
    return st
