"""Camera tracking: Adam on the 7-DoF pose against a frozen map (JAX
counterpart: slam/tracker.py:388 `track_frame`; reference
slam/tracker.py:45-266).

  * vigs/mm3dgs loss in the compositor's channel-major tile layout
    (JAX `tracking_loss_tiles`, tracker.py:136-216): L1 over the pixels
    with silhouette > 0.99, at nc = 5 (E[z^2] feeds only splatam), plus the
    optional Pearson depth term and the optional IMU prior (`rel_pose_loss`
    against the seed, its gradient stopped; tracker.py:146-155),
  * splatam loss at nc = 6: masked SUMS of |depth error| and 0.5 |rgb
    error| over the pixels with GT depth > 0, silhouette > 0.99 and a
    finite depth and uncertainty E[z^2] - z^2 (its gradient stopped; it
    feeds only that mask); no Pearson term and no IMU prior
    (tracker.py:110-126),
  * gradients from the fused pose backward (kernel 3), the IMU prior's
    added by autograd beside them,
  * separate Adam groups for q and T with torch defaults (tracker.py:233-246),
  * bins rebuilt when i % rebin_every == 0 at the pose with its gradient
    stopped,
  * the returned pose is the LAST iteration's, reproducing the reference's
    ineffective best-candidate rebinding (tracker.py:167-181).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.binning import build_bins
from ..ops.losses import masked_mean, masked_sum, pearson_loss, rel_pose_loss
from ..ops.render import (ActivatedGaussians, RenderSettings, project_for_pose,
                          render_tiles_pose, tile_pixel_valid, to_tiles)


class TrackSettings(NamedTuple):
    """Tracking configuration (cfg['tracking'] + method flags)."""

    rs: RenderSettings
    iters: int
    method: str = "vigs"            # 'vigs' | 'mm3dgs' (one loss) | 'splatam'
    use_gt_depth: bool = True
    use_depth_estimate_loss: bool = False
    pearson_weight: float = 0.0
    use_imu_loss: bool = False
    imu_T_weight: float = 0.0
    imu_q_weight: float = 0.0
    position_lr: float = 0.001
    rotation_lr: float = 0.003
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8               # torch.optim.Adam default
    rebin_every: int = 1


def tracking_loss_tiles(g: ActivatedGaussians, q, T, gt_color_t, gt_depth_t,
                        est_depth_t, valid, initial_pose, ts: TrackSettings, bins):
    """The tracking loss in tile layout [n_tiles, C, 256]; `initial_pose`
    [7] is the seed the IMU prior pulls towards."""
    out = render_tiles_pose(g, q, T, ts.rs, bins, nc=6 if ts.method == "splatam" else 5)
    image, depth, silhouette = out[:, :3], out[:, 3], out[:, 4]
    presence = (silhouette > 0.99) & valid
    if ts.method == "splatam":
        uncertainty = (out[:, 5] - depth * depth).detach()
        mask = (gt_depth_t > 0) & ~torch.isnan(depth) & ~torch.isnan(uncertainty) & presence
        return (masked_sum(torch.abs(gt_depth_t - depth), mask)
                + 0.5 * masked_sum(torch.abs(gt_color_t - image), mask[:, None]))
    loss = masked_mean(torch.abs(image - gt_color_t), presence[:, None])
    if ts.use_depth_estimate_loss:
        if ts.use_gt_depth:
            loss = loss + ts.pearson_weight * pearson_loss(
                depth, gt_depth_t, mask=presence & (gt_depth_t > 0), invert_estimate=True)
        else:
            loss = loss + ts.pearson_weight * pearson_loss(
                depth, est_depth_t, mask=presence, invert_estimate=True)
    if ts.use_imu_loss:
        t_err, q_err = rel_pose_loss(torch.cat([q, T]), initial_pose)
        loss = loss + ts.imu_T_weight * t_err + ts.imu_q_weight * q_err
    return loss


def track_frame(g: ActivatedGaussians, pose_init, gt_color, gt_depth, est_depth,
                ts: TrackSettings):
    """Optimize the pose for `ts.iters` Adam steps. Returns (pose, last_loss).

    g: the frozen map; pose_init [7]; gt_color [3, H, W]; gt_depth and
    est_depth [H, W] (est_depth may be zeros when unused)."""
    cam = ts.rs.cam
    g = ActivatedGaussians(*(t.detach() for t in g))
    gt_color_t = to_tiles(gt_color, cam)
    gt_depth_t = to_tiles(gt_depth, cam)
    est_depth_t = to_tiles(est_depth, cam)
    valid = tile_pixel_valid(cam, gt_color.device)

    initial_pose = pose_init.detach().clone()
    q = pose_init[:4].detach().clone()
    T = pose_init[4:].detach().clone()
    mq, vq = torch.zeros_like(q), torch.zeros_like(q)
    mT, vT = torch.zeros_like(T), torch.zeros_like(T)
    rebin = max(int(ts.rebin_every), 1)
    loss = torch.zeros((), device=q.device)
    bins = None
    for i in range(ts.iters):
        if i % rebin == 0:
            with torch.no_grad():
                bins = build_bins(project_for_pose(g, torch.cat([q, T]), ts.rs), cam)
        qv = q.requires_grad_(True)
        Tv = T.requires_grad_(True)
        loss = tracking_loss_tiles(g, qv, Tv, gt_color_t, gt_depth_t, est_depth_t,
                                   valid, initial_pose, ts, bins)
        gq, gT = torch.autograd.grad(loss, (qv, Tv))
        with torch.no_grad():
            step = i + 1
            bc1 = 1.0 - ts.b1 ** step
            bc2_sqrt = (1.0 - ts.b2 ** step) ** 0.5
            mq = ts.b1 * mq + (1 - ts.b1) * gq
            vq = ts.b2 * vq + (1 - ts.b2) * gq * gq
            q = q.detach() - ts.rotation_lr * (mq / bc1) / (torch.sqrt(vq) / bc2_sqrt + ts.eps)
            mT = ts.b1 * mT + (1 - ts.b1) * gT
            vT = ts.b2 * vT + (1 - ts.b2) * gT * gT
            T = T.detach() - ts.position_lr * (mT / bc1) / (torch.sqrt(vT) / bc2_sqrt + ts.eps)
    return torch.cat([q, T]).detach(), loss.detach()
