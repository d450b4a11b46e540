"""Mapper geometry: depth/silhouette renders, covisibility, new-Gaussian
candidates (JAX counterpart: slam/map_ops.py; reference
slam/mapper.py:103-716)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.gaussians import NewGaussians
from ..ops.camera import Camera
from ..ops.depth import backproject_all_pixels, project_points_fraction_inside, torch_style_median
from ..ops.pose import pose_to_w2c
from ..ops.render import ActivatedGaussians, RenderSettings, project_for_pose, render
from ..ops.sh import rgb_to_sh


@torch.no_grad()
def render_depth_sil(g: ActivatedGaussians, pose, rs: RenderSettings):
    """(depth, silhouette, visibility_filter) of a no-grad render."""
    out = render(g, pose, rs)
    return out["depth"][0], out["depth"][1], out["visibility_filter"]


def keyframe_world_points(depth, silhouette, pose, cam: Camera):
    """World points of a keyframe's rendered depth and their validity:
    silhouette <= 0.99 or depth <= 0 is invalid, and points at the camera
    origin are dropped (mapper.py:141-167, 175-203)."""
    d = torch.where(silhouette > 0.99, depth, torch.zeros_like(depth))
    pts = backproject_all_pixels(d, pose_to_w2c(pose), cam.fx, cam.fy, cam.cx, cam.cy)
    near_origin = torch.all(torch.abs(torch.round(pts, decimals=4)) == 0.0, dim=-1)
    return pts, (d > 0).reshape(-1) & ~near_origin


def covisibility_fraction(pts, valid, candidate_pose, cam: Camera, edge: int = 0):
    return project_points_fraction_inside(
        pts, valid, pose_to_w2c(candidate_pose), cam.fx, cam.fy, cam.cx, cam.cy,
        cam.height, cam.width, edge)


@torch.no_grad()
def covis_check_last_kf(g, last_pose, est_pose, rs: RenderSettings):
    """need_new_keyframe's covisibility test (mapper.py:141-167): the last
    keyframe's rendered points, fraction visible from the current pose."""
    depth, sil, _ = render_depth_sil(g, last_pose, rs)
    pts, valid = keyframe_world_points(depth, sil, last_pose, rs.cam)
    return covisibility_fraction(pts, valid, est_pose, rs.cam)


@torch.no_grad()
def kf_world_points(g, pose, rs: RenderSettings):
    depth, sil, _ = render_depth_sil(g, pose, rs)
    return keyframe_world_points(depth, sil, pose, rs.cam)


class NewGaussianStats(NamedTuple):
    candidates: NewGaussians
    non_presence: torch.Tensor  # [H, W] bool (before the depth-validity AND)
    n_new: int


@torch.no_grad()
def new_gaussian_candidates(g: ActivatedGaussians, pose, gt_color, depth,
                            rs: RenderSettings, first_frame: bool,
                            method: str = "vigs") -> NewGaussianStats:
    """One candidate per pixel and the mask of which to add
    (initialize_new_gaussians, mapper.py:495-688):
    non-presence = silhouette < 0.5 OR depth error > 10x its median (splatam:
    render depth > depth AND depth error > 50x its median);
    candidates: back-projected center, RGB->SH color, identity rotation,
    logit-0 opacity, isotropic log scale from the pixel footprint."""
    cam = rs.cam
    H, W = cam.height, cam.width
    if first_frame:
        non_presence = torch.ones((H, W), dtype=torch.bool, device=depth.device)
    else:
        out = render(g, pose, rs)
        render_depth, silhouette = out["depth"][0], out["depth"][1]
        depth_error = torch.abs(depth - render_depth) * (depth > 0)
        med = torch_style_median(depth_error)
        if method == "splatam":
            non_presence_depth = (render_depth > depth) & (depth_error > 50 * med)
        else:
            non_presence_depth = depth_error > 10 * med
        non_presence = (silhouette < 0.5) | non_presence_depth
    mask = non_presence.reshape(-1) & (depth.reshape(-1) > 0)

    pts = backproject_all_pixels(depth, pose_to_w2c(pose), cam.fx, cam.fy, cam.cx, cam.cy)
    cols = gt_color.permute(1, 2, 0).reshape(-1, 3)
    scale_gaussian = depth.reshape(-1) / ((cam.fx + cam.fy) / 2.0)
    log_scale = torch.log(torch.sqrt(torch.clamp(scale_gaussian ** 2, min=1e-20)))
    M = H * W
    rest = max(g.shs.shape[1] - 1, 1)
    candidates = NewGaussians(
        xyz=pts,
        features_dc=rgb_to_sh(cols)[:, None, :],
        features_rest=torch.zeros((M, rest, 3), dtype=torch.float32, device=depth.device),
        scaling=log_scale[:, None].expand(M, 3).contiguous(),
        rotation=torch.tensor([1.0, 0, 0, 0], device=depth.device).expand(M, 4).contiguous(),
        opacity=torch.zeros((M, 1), dtype=torch.float32, device=depth.device),
        rgb=cols.contiguous(),
        mask=mask,
    )
    return NewGaussianStats(candidates, non_presence, int(mask.sum()))


@torch.no_grad()
def covisible_gaussian_mask(g: ActivatedGaussians, poses, rs: RenderSettings,
                            min_kf: int = 2):
    """[N] bool: the Gaussians visible (projected radius > 0) from at least
    `min_kf` of the window's poses [K, 7] (mapper.py:690-716). Visibility
    is taken from the projection alone, as the reference's
    visibility_filter is: no composite runs."""
    count = torch.zeros(g.xyz.shape[0], dtype=torch.int32, device=g.xyz.device)
    for pose in poses:
        count += (project_for_pose(g, pose, rs).radius > 0).to(torch.int32)
    return count >= min_kf
