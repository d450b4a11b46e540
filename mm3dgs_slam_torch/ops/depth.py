"""Depth utilities (JAX counterpart: ops/depth.py): torch-style median,
back-projection, the covisibility fraction, the monocular-depth
scale/shift fit (`get_scale_shift_ls`) and the debug video's colormap
(`depth_to_rgb_np`)."""
from __future__ import annotations

import numpy as np
import torch


def torch_style_median(x):
    """Lower of the two middle elements (what the reference's
    torch.Tensor.median() returns; its keyframe masks depend on it)."""
    flat, _ = torch.sort(x.reshape(-1))
    return flat[(flat.shape[0] - 1) // 2]


def get_scale_shift_ls(est_depth, render_depth, mask=None):
    """Weighted closed-form least squares of (scale, shift) in
    1/render ~= scale * est + shift over the masked pixels with a positive
    inverse render (utils/depth_utils.py:44-99); metric depth is then
    1 / (scale * est + shift) (slam/SLAM.py:423,448)."""
    inv_render = 1.0 / render_depth
    w = inv_render > 0
    if mask is not None:
        w = mask & w
    w = w.to(torch.float32).reshape(-1)
    e = est_depth.reshape(-1)
    z = torch.where(w > 0, inv_render.reshape(-1), torch.zeros((), device=e.device))
    s11 = torch.sum(w * e * e)
    s12 = torch.sum(w * e)
    s22 = torch.sum(w)
    b1 = torch.sum(w * e * z)
    b2 = torch.sum(w * z)
    det = s11 * s22 - s12 * s12
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    return (s22 * b1 - s12 * b2) / det, (s11 * b2 - s12 * b1) / det


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


def depth_to_rgb_np(depth, min_depth=None, max_depth=None):
    """Depth [H, W] -> viridis RGB [3, H, W] float32 on the host
    (utils/depth_utils.py:14-34). The 256-entry table is OpenCV's viridis,
    within 2e-3 of matplotlib's, indexed as matplotlib indexes it."""
    import cv2

    depth = np.asarray(depth, np.float64)
    lo = float(depth.min()) if min_depth is None else min_depth
    hi = float(depth.max()) if max_depth is None else max_depth
    norm = np.clip((depth - lo) / max(hi - lo, 1e-12), 0, 1)
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_VIRIDIS)
    lut = lut[:, 0, ::-1].astype(np.float32) / 255.0   # BGR -> RGB
    return np.transpose(lut[np.minimum((norm * 256).astype(np.int64), 255)], (2, 0, 1))
