"""Depth utilities the mapper uses (JAX counterpart: ops/depth.py):
torch-style median, back-projection and the covisibility fraction. The
monocular-depth fit (`get_scale_shift_ls`) is not ported yet."""
from __future__ import annotations

import torch


def torch_style_median(x):
    """Lower of the two middle elements (what the reference's
    torch.Tensor.median() returns; its keyframe masks depend on it)."""
    flat, _ = torch.sort(x.reshape(-1))
    return flat[(flat.shape[0] - 1) // 2]


def backproject_all_pixels(depth, w2c, fx, fy, cx, cy):
    """Every pixel of a [H, W] depth map -> world points [H*W, 3]
    (slam/mapper.py:175-203,409-493)."""
    H, W = depth.shape
    yg, xg = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                            torch.arange(W, dtype=torch.float32, device=depth.device),
                            indexing="ij")
    pts_cam = torch.stack([(xg - cx) / fx * depth, (yg - cy) / fy * depth, depth],
                          dim=-1).reshape(-1, 3)
    c2w = torch.linalg.inv(w2c)
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def project_points_fraction_inside(pts, valid, w2c, fx, fy, cx, cy,
                                   height: int, width: int, edge: int = 0):
    """Fraction of valid world points that project inside another view
    (the covisibility metric of slam/mapper.py:205-240)."""
    p_cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = p_cam[:, 2] + 1e-5
    u = (fx * p_cam[:, 0] + cx * p_cam[:, 2]) / z
    v = (fy * p_cam[:, 1] + cy * p_cam[:, 2]) / z
    inside = (u < width - edge) & (u > edge) & (v < height - edge) & (v > edge) & (z > 0)
    vf = valid.to(torch.float32)
    return torch.sum(inside.to(torch.float32) * vf) / torch.clamp(torch.sum(vf), min=1.0)
