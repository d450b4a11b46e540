"""Map optimization: the mapper's inner loop (JAX counterpart:
slam/map_opt.py:457 `optimize_map`; reference slam/mapper.py:718-950).

Per iteration: render the scheduled keyframe in tile layout at nc = 3
(JAX map_opt.py:150-207) -> (1-lambda) L1 + lambda (1 - SSIM) on the
assembled rgb -> gradients through kernel 2 -> torch-semantics Adam over
every map leaf. splatam renders at nc = 4 and adds the masked mean depth
error to half the image loss. Bundle adjustment (`do_BA`) makes the window's
poses [K, 7] a gradient leaf too: kernel 2's xy, conic and depth gradients
reach them through the projection. Reproduced semantics, quirks included:

  * bins are rebuilt exactly where the JAX `plan_segments` cuts: prune
    iterations, keyframe switches and every `rebin_every` iterations of a
    run on one keyframe (under BA every iteration: the poses move),
  * max_radii2D and the densification stats update every iteration while
    iteration <= densify_until_iter (mapper.py:887-898); the xy gradient
    reaches them through a zero `screen_offset` added to the projected xy
    (JAX map_opt.py:142-145),
  * pruning at i >= densify_from_iter and i % pruning_interval == 0 (and
    i <= densify_until_iter); the reference swaps its torch parameters
    during prune, which orphans that iteration's gradients, so the map
    Adam step is a no-op on prune iterations (mapper.py:900-909); splatam
    prunes at i in {0, 20} on opacity and world size alone,
  * under BA the map gradients of the rows outside `ba_mask` are zeroed
    before the map Adam (their moments still decay), and the pose Adam
    (`pose_adam`) steps on every iteration, prune iterations included.

The state holds this rank's rows of the map sharded over `ms.mesh` (JAX
map_opt.py:134-146, 209-216, 253-266, 392-400): the bins are this rank's
tile window of the gathered projection, the loss reads the image gathered
from every rank's window (parallel/tile_sharded.py), the prune is
shard-local and BA's pose gradient is summed over the ranks, so every rank
takes the same pose step. The default mesh is one process
(parallel.mesh.SINGLE), where every collective is the identity.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.gaussians import (AdamState, GaussianMap, MapOptHyper, adam_update,
                                prune_mask_reference)
from ..ops.binning import build_slots
from ..ops.losses import l1_loss, masked_mean, pearson_loss, ssim
from ..ops.render import (RenderSettings, background, composite_packed, from_tiles,
                          project_for_pose, tile_pixel_valid, to_tiles)
from ..parallel.mesh import SINGLE, Mesh
from ..parallel.shard_local import prune_compact_sharded
from ..parallel.sharded import gather_rows, replicate_proj
from ..parallel.tile_sharded import build_window_bins, gather_tiles


class MapOptSettings(NamedTuple):
    rs: RenderSettings
    iters: int
    method: str = "vigs"
    use_gt_depth: bool = True
    use_depth_estimate_loss: bool = False
    pearson_weight: float = 0.0
    lambda_dssim: float = 0.2
    min_opacity: float = 0.005
    size_threshold: float | None = 100.0
    pruning_interval: int = 50
    densify_from_iter: int = 0
    densify_until_iter: int = 50
    do_BA: bool = False
    cam_t_lr: float = 0.001
    cam_q_lr: float = 0.003
    hyper: MapOptHyper | None = None
    rebin_every: int = 1
    mesh: Mesh = SINGLE   # the ranks the map is sharded over


class MapState(NamedTuple):
    m: GaussianMap
    adam: AdamState
    max_radii: torch.Tensor   # [N] f32
    grad_accum: torch.Tensor  # [N] f32 (xyz_gradient_accum)
    denom: torch.Tensor       # [N] f32
    last_loss: float = 0.0
    ba_mask: torch.Tensor | None = None  # [N] bool, BA: the rows the map Adam moves
    kf_poses: torch.Tensor | None = None  # [K, 7] the window's poses after the run


def map_loss(m: GaussianMap, screen_offset, pose, gt_color, gt_depth, est_depth,
             bins, ms: MapOptSettings, counts=None):
    """Loss and (radius, visible) for one keyframe; differentiable in the
    map leaves and `screen_offset` [N, 2]. `bins` are `_map_bins`'s: this
    rank's window bins and their slot table; `counts` every rank's row
    count."""
    tile_bins, slots = bins
    rs = ms.rs
    proj = project_for_pose(m.activated(), pose, rs)
    packed = torch.cat([proj.packed[:, :2] + screen_offset, proj.packed[:, 2:]], dim=1)
    splatam = ms.method == "splatam"
    nc = 4 if (splatam or ms.use_depth_estimate_loss) else 3
    lo, n_local = ms.mesh.window(rs.cam)
    acc, tfin = composite_packed(gather_rows(packed, ms.mesh, counts), tile_bins, rs.cam, nc,
                                 lo, n_local, slots)
    out_t = gather_tiles(acc + tfin * background(rs, acc.device)[:nc][None, :, None],
                         ms.mesh, rs.cam)
    image = from_tiles(out_t[:, :3], rs.cam)
    lam = ms.lambda_dssim
    loss = (1 - lam) * l1_loss(image, gt_color) + lam * (1.0 - ssim(image, gt_color))
    if splatam:
        depth_t = out_t[:, 3]
        gt_depth_t = to_tiles(gt_depth, rs.cam)
        mask = (gt_depth_t > 0) & ~torch.isnan(depth_t) & tile_pixel_valid(rs.cam, acc.device)
        loss = masked_mean(torch.abs(gt_depth_t - depth_t), mask) + 0.5 * loss
    elif ms.use_depth_estimate_loss:
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


def _map_bins(m: GaussianMap, pose, ms: MapOptSettings, counts=None):
    """(this rank's window bins at `pose`, their slot table): kernel 2's
    reduce order, built once per segment with the bins."""
    with torch.no_grad():
        proj = replicate_proj(project_for_pose(m.activated(), pose, ms.rs), ms.mesh, counts)
        bins = build_window_bins(proj, ms.rs.cam, ms.mesh)
        return bins, build_slots(bins.pair_gauss, proj.packed.shape[0])


def _grad_and_stats(st: MapState, bins, pose, i, gt_color, gt_depth, est_depth,
                    ms: MapOptSettings, counts=None):
    """One iteration's loss, map gradients, pose gradient (None unless BA)
    and densification-stats update."""
    leaves = [t.detach().requires_grad_(True) for t in st.m]
    m = GaussianMap(*leaves)
    screen = torch.zeros((m.n, 2), dtype=torch.float32, device=m.xyz.device,
                         requires_grad=True)
    wrt = leaves + [screen]
    if ms.do_BA:
        pose = pose.detach().requires_grad_(True)
        wrt.append(pose)
    loss, radii, visible = map_loss(m, screen, pose, gt_color, gt_depth, est_depth, bins, ms,
                                    counts)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(wrt, grads)]
    gm, g_screen = GaussianMap(*grads[:len(leaves)]), grads[len(leaves)]
    g_pose = grads[-1] if ms.do_BA else None
    if g_pose is not None:
        # each rank's rows give a share of the window pose's gradient
        g_pose = ms.mesh.sum_replicated(g_pose)
    if i <= ms.densify_until_iter:
        max_radii = torch.where(visible, torch.maximum(st.max_radii, radii.to(torch.float32)),
                                st.max_radii)
        grad_accum = st.grad_accum + torch.where(visible, torch.linalg.norm(g_screen, dim=-1), 0.0)
        denom = st.denom + visible.to(torch.float32)
    else:
        max_radii, grad_accum, denom = st.max_radii, st.grad_accum, st.denom
    return loss.detach(), gm, g_pose, max_radii, grad_accum, denom


class PoseAdam(NamedTuple):
    """BA's Adam over the window's poses: one step counter for the frame,
    moments per slot."""

    poses: torch.Tensor   # [K, 7]
    m: torch.Tensor       # [K, 7]
    v: torch.Tensor       # [K, 7]
    step: int = 0


def pose_adam(pa: PoseAdam, k: int, g_pose, ms: MapOptSettings) -> PoseAdam:
    """One step with slot k's gradient (JAX map_opt.py `_pose_adam`;
    mapper.py:768-780, 940-942): every slot's moments decay and every slot
    moves by its momentum; q and T take cam_q_lr and cam_t_lr; eps 1e-15;
    the bias corrections in float32, as there."""
    step = pa.step + 1
    dev = pa.poses.device
    sf = torch.tensor(float(step), dtype=torch.float32, device=dev)
    bc1 = 1.0 - torch.tensor(0.9, device=dev) ** sf
    bc2 = 1.0 - torch.tensor(0.999, device=dev) ** sf
    gp = torch.zeros_like(pa.poses)
    gp[k] = g_pose
    m = 0.9 * pa.m + 0.1 * gp
    v = 0.999 * pa.v + 0.001 * gp * gp
    lr = torch.tensor([ms.cam_q_lr] * 4 + [ms.cam_t_lr] * 3, dtype=torch.float32, device=dev)
    upd = lr * (m / bc1) / (torch.sqrt(v) / torch.sqrt(bc2) + 1e-15)
    return PoseAdam(pa.poses - upd, m, v, step)


def is_prune_iter(i: int, ms: MapOptSettings) -> bool:
    if ms.method == "splatam":
        return i <= 20 and i % 20 == 0
    return (i >= ms.densify_from_iter and i % ms.pruning_interval == 0
            and i <= ms.densify_until_iter)


def plan_segments(schedule, ms: MapOptSettings):
    """("prune"|"opt", keyframe slot, first iteration, length) runs: cut at
    prune iterations, keyframe switches and every `rebin_every` iterations
    (JAX map_opt.py:433-455; under BA every iteration). Bins are built
    once per segment."""
    sched = np.asarray(schedule)
    rebin = 1 if ms.do_BA else max(int(ms.rebin_every), 1)
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
    kf_ests [K, H, W], kf_poses [K, 7]; `schedule` [iters] indexes K. The
    returned state's kf_poses are the window's poses, moved under BA."""
    pa = PoseAdam(kf_poses, torch.zeros_like(kf_poses), torch.zeros_like(kf_poses))
    mesh = ms.mesh
    counts = mesh.row_counts(st.m.n)
    for kind, k, base_i, n in plan_segments(schedule, ms):
        bins = _map_bins(st.m, pa.poses[k], ms, counts)
        for i in range(base_i, base_i + n):
            loss, gm, g_pose, max_radii, grad_accum, denom = _grad_and_stats(
                st, bins, pa.poses[k], i, kf_colors[k], kf_depths[k], kf_ests[k], ms, counts)
            if kind == "prune":
                size = None if ms.method == "splatam" else ms.size_threshold
                pmask = prune_mask_reference(st.m, camera_extent, ms.min_opacity,
                                             max_radii, size)
                m, adam, extras = prune_compact_sharded(
                    st.m, st.adam, ~pmask, mesh,
                    extras=(max_radii, grad_accum, denom, st.ba_mask))
                counts = mesh.row_counts(m.n)
                st = MapState(m, adam, *extras[:3], loss, extras[3])
            else:
                with torch.no_grad():
                    m, adam = adam_update(st.m, gm, st.adam, ms.hyper, row_mask=st.ba_mask)
                st = MapState(m, adam, max_radii, grad_accum, denom, loss, st.ba_mask)
            if ms.do_BA:
                with torch.no_grad():
                    pa = pose_adam(pa, k, g_pose, ms)
    return st._replace(kf_poses=pa.poses)
