"""Loss functions for tracking and mapping (JAX counterpart: ops/losses.py).

Masked losses are weighted reductions with 0/1 weights, which give the
value of the reference's boolean fancy-indexing (e.g. slam/tracker.py:129).
"""
from __future__ import annotations

import torch

from .pose import quat_multiply

_EPS_COUNT = 1e-12


def masked_mean(x, mask):
    """Mean of x over the elements where mask (broadcastable) is True."""
    if mask is None:
        return torch.mean(x)
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=_EPS_COUNT)


def masked_sum(x, mask):
    return torch.sum(x * torch.broadcast_to(mask, x.shape).to(x.dtype))


def l1_loss(pred, gt, mask=None):
    """L1; a [H, W] mask applies across channels (utils/loss_utils.py:64-68)."""
    diff = torch.abs(pred - gt)
    if mask is None:
        return torch.mean(diff)
    return masked_mean(diff, mask[None] if mask.dim() == 2 and diff.dim() == 3 else mask)


def pearson_corrcoef(x, y, mask=None):
    """Pearson correlation of flattened x vs y, optionally mask-weighted."""
    x = x.reshape(-1)
    y = y.reshape(-1)
    w = torch.ones_like(x) if mask is None else mask.reshape(-1).to(x.dtype)
    n = torch.clamp(torch.sum(w), min=_EPS_COUNT)
    dx = (x - torch.sum(x * w) / n) * w
    dy = (y - torch.sum(y * w) / n) * w
    cov = torch.sum(dx * dy)
    # The square root of the clamped product: the JAX package's value, but on
    # an empty mask (product 0) the gradient is 0, not 0 * inf = NaN. Tracking
    # meets an empty mask when the pose leaves the bins it reuses between
    # rebins (tpu.rebin_every), and a NaN there poisons the pose.
    return cov / torch.sqrt(torch.clamp(torch.sum(dx * dx) * torch.sum(dy * dy),
                                        min=_EPS_COUNT * _EPS_COUNT))


def pearson_loss(render, estimate, mask=None, invert_estimate: bool = True):
    """1 - Pearson depth loss (utils/loss_utils.py:43-61); with
    ``invert_estimate`` the min over the -est and 1/(est+200) hypotheses."""
    if invert_estimate:
        a = 1.0 - pearson_corrcoef(-estimate, render, mask)
        b = 1.0 - pearson_corrcoef(1.0 / (estimate + 200.0), render, mask)
        return torch.minimum(a, b)
    return 1.0 - pearson_corrcoef(estimate, render, mask)


def rel_pose_loss(camera_pose, initial_pose):
    """(translation L2-sum, quaternion geodesic angle) between two 7-vector
    poses (utils/loss_utils.py:20-40). The arccos argument is clamped
    strictly inside 1: tracking starts at the seed, where |diff[0]| is 1 and
    d/dx arccos is infinite, so an exact clamp at 1 would give the first
    Adam step a NaN gradient; inside the clamp the angle's gradient is 0."""
    t_err = torch.sum((camera_pose[4:] - initial_pose[4:]) ** 2)
    gtconj = initial_pose[:4] * initial_pose.new_tensor([1.0, -1.0, -1.0, -1.0])
    diff = quat_multiply(camera_pose[:4], gtconj)
    diff = diff / torch.clamp(torch.linalg.norm(diff), min=1e-12)
    angle_err = 2.0 * torch.arccos(torch.clamp(torch.abs(diff[0]), 0.0, 1.0 - 1e-7))
    return t_err, angle_err


def _banded(n: int, g: torch.Tensor, half: int):
    i = torch.arange(n, device=g.device)[:, None]
    j = torch.arange(n, device=g.device)[None, :]
    d = i - j + half
    return torch.where((d >= 0) & (d <= 2 * half), g[torch.clamp(d, 0, 2 * half)],
                       torch.zeros((), device=g.device))


def ssim(img1, img2, window_size: int = 11):
    """SSIM with an 11x11 sigma-1.5 Gaussian window, zero-padded
    (utils/loss_utils.py:95-154). The separable window runs as two banded
    float32 matmuls (the JAX package's formulation), which keeps it out of
    cuDNN's TF32 convolutions. Inputs [C, H, W]."""
    xs = torch.arange(window_size, dtype=torch.float32, device=img1.device)
    g = torch.exp(-((xs - window_size // 2) ** 2) / (2.0 * 1.5 ** 2))
    g = g / torch.sum(g)
    half = window_size // 2
    bw = _banded(img1.shape[2], g, half)
    bh = _banded(img1.shape[1], g, half)

    def conv(x):
        return torch.matmul(bh.T, torch.matmul(x, bw))

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def psnr(img1, img2):
    """PSNR over flattened pixels (utils/image_utils.py:14-19)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
