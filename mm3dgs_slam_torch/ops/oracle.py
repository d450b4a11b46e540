"""Exact reference compositor: the port's semantic oracle (JAX counterpart:
ops/oracle.py:41-69).

Replays the reference CUDA rasterizer's per-pixel front-to-back loop over
depth-sorted Gaussians: alpha = min(0.99, op * exp(power)); skip the pixel
when power > 0 or alpha < 1/255; stop (and freeze T) when T * (1 - alpha) <
1e-4; composite a Gaussian only into the tiles its getRect box overlaps.

A Gaussian changes no pixel outside its getRect box, so each step updates
only that box's pixel slice: the same result as a dense pass over the whole
image, at the cost of the box. O(sum of box areas) — for tests and for
rendering the synthetic dataset's frames.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera import TILE, Camera
from .projection import ProjectedGaussians


def tile_rect_np(xy: np.ndarray, radius: np.ndarray, cam: Camera):
    """getRect in tile units, float32 like the binning (host numpy)."""
    r = radius.astype(np.float32)
    t = np.float32(TILE)
    x0 = np.clip(np.floor((xy[:, 0] - r) / t), 0, cam.tiles_x).astype(np.int64)
    x1 = np.clip(np.floor((xy[:, 0] + r + t - 1) / t), 0, cam.tiles_x).astype(np.int64)
    y0 = np.clip(np.floor((xy[:, 1] - r) / t), 0, cam.tiles_y).astype(np.int64)
    y1 = np.clip(np.floor((xy[:, 1] + r + t - 1) / t), 0, cam.tiles_y).astype(np.int64)
    return x0, x1, y0, y1


@torch.no_grad()
def composite_oracle(proj: ProjectedGaussians, cam: Camera,
                     bg: torch.Tensor) -> torch.Tensor:
    """Returns [C, H, W] composited features (+ T * bg per channel)."""
    H, W = cam.height, cam.width
    dev = proj.xy.device
    C = proj.feat.shape[-1]
    order = torch.argsort(proj.depth, stable=True)
    xy = proj.xy[order].cpu().numpy()
    radius = proj.radius[order].cpu().numpy()
    conic = proj.conic[order].cpu().numpy()
    opac = proj.opacity[order].cpu().numpy()
    feat = proj.feat[order]
    x0, x1, y0, y1 = tile_rect_np(xy, radius, cam)
    # pixel box, clipped to the image (pixels beyond it do not exist here)
    bx0, bx1 = x0 * TILE, np.minimum(x1 * TILE, W)
    by0, by1 = y0 * TILE, np.minimum(y1 * TILE, H)
    keep = (radius > 0) & (bx1 > bx0) & (by1 > by0)

    pixx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    pixy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    T = torch.ones((H, W), dtype=torch.float32, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    acc = torch.zeros((C, H, W), dtype=torch.float32, device=dev)
    # Python floats hold the float32 values exactly; torch computes in f32
    for i in np.nonzero(keep)[0].tolist():
        ys, xs = slice(by0[i], by1[i]), slice(bx0[i], bx1[i])
        dx = float(xy[i, 0]) - pixx[ys, xs]
        dy = float(xy[i, 1]) - pixy[ys, xs]
        a, b, c = (float(v) for v in conic[i])
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(float(opac[i]) * torch.exp(power), max=0.99)
        Tb, db = T[ys, xs], done[ys, xs]
        contribute = (power <= 0.0) & (alpha >= 1.0 / 255.0)
        alpha = torch.where(contribute, alpha, torch.zeros_like(alpha))
        T_test = Tb * (1.0 - alpha)
        newly_done = contribute & (T_test < 1e-4) & ~db
        use = contribute & ~db & ~newly_done
        w = torch.where(use, alpha * Tb, torch.zeros_like(alpha))
        acc[:, ys, xs] += w[None] * feat[i][:, None, None]
        T[ys, xs] = torch.where(use, T_test, Tb)
        done[ys, xs] = db | newly_done
    return acc + T[None] * bg[:, None, None]
