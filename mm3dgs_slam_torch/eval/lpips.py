"""LPIPS-VGG perceptual distance on the SLAM's device (JAX counterpart:
eval/lpips.py; reference lpipsPyTorch/__init__.py:6-21).

  * `lpips` reads VGG16 conv weights and LPIPS linear heads from the .npz
    named by `MM3DGS_LPIPS_WEIGHTS` (keys `conv{i}_w` [O, I, 3, 3],
    `conv{i}_b` [O], `lin{b}_w` [C]) and is NaN without it: nothing is
    downloaded;
  * `lpips_proxy` runs the same graph on deterministic random weights (He
    init from `numpy.random.default_rng(0)`, uniform heads), the same numbers
    as the JAX package's: always finite, comparable only with itself.

Both reproduce the reference's vendored lpipsPyTorch: [0, 1] images are
z-scored directly (no [-1, 1] rescale) and each feature map is normalized by
x / (||x|| + 1e-10) over channels. Convolutions run in full f32 (TF32 off),
so the card and the CPU agree.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

_VGG_LAYERS = [2, 2, 3, 3, 3]  # conv counts per block (VGG16)
_FEAT_CHANNELS = [64, 128, 256, 512, 512]
_SHIFT = [-0.030, -0.088, -0.188]
_SCALE = [0.458, 0.448, 0.450]


class LPIPS(torch.nn.Module):
    """The VGG16 LPIPS graph over one weights dict (numpy arrays)."""

    def __init__(self, w: dict):
        super().__init__()
        n_conv = sum(_VGG_LAYERS)
        self.convs = torch.nn.ModuleList()
        for li in range(n_conv):
            k = torch.as_tensor(np.asarray(w[f"conv{li}_w"], np.float32))
            conv = torch.nn.Conv2d(k.shape[1], k.shape[0], 3, padding=1)
            conv.weight.data.copy_(k)
            conv.bias.data.copy_(torch.as_tensor(np.asarray(w[f"conv{li}_b"], np.float32)))
            self.convs.append(conv)
        for b in range(len(_VGG_LAYERS)):
            self.register_buffer(f"lin{b}", torch.as_tensor(np.asarray(w[f"lin{b}_w"], np.float32)))
        self.register_buffer("shift", torch.tensor(_SHIFT)[:, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[:, None, None])
        self.requires_grad_(False)

    def features(self, x):
        """x [3, H, W] z-scored -> the 5 block outputs (after ReLU)."""
        feats, h, li = [], x[None], 0
        for block, n in enumerate(_VGG_LAYERS):
            for _ in range(n):
                h = F.relu(self.convs[li](h))
                li += 1
            feats.append(h)
            if block < len(_VGG_LAYERS) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats

    @torch.no_grad()
    def forward(self, img1, img2):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            fx = self.features((img1 - self.shift) / self.scale)
            fy = self.features((img2 - self.shift) / self.scale)
        total = torch.zeros((), device=img1.device)
        for b, (a, c) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
            c = c / (torch.linalg.norm(c, dim=1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{b}")
            total = total + torch.mean(torch.sum((a - c) ** 2 * lin[None, :, None, None], dim=1))
        return total


def proxy_weights() -> dict:
    """Deterministic random VGG16 weights (He init, seed 0) and uniform unit
    heads, drawn in the JAX package's order."""
    rng = np.random.default_rng(0)
    w, li, in_c = {}, 0, 3
    for block, n in enumerate(_VGG_LAYERS):
        out_c = _FEAT_CHANNELS[block]
        for _ in range(n):
            std = float(np.sqrt(2.0 / (in_c * 9)))
            w[f"conv{li}_w"] = rng.normal(0.0, std, (out_c, in_c, 3, 3)).astype(np.float32)
            w[f"conv{li}_b"] = np.zeros((out_c,), np.float32)
            in_c = out_c
            li += 1
        w[f"lin{block}_w"] = np.full((out_c,), 1.0 / out_c, np.float32)
    return w


@lru_cache(maxsize=4)
def _network(path: str | None, device: str) -> LPIPS:
    w = proxy_weights() if path is None else dict(np.load(path))
    return LPIPS(w).to(device)


def _distance(path: str | None, img1, img2) -> float:
    """On the first image's device (the CPU for numpy arrays)."""
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32).to(a.device)
    return float(_network(path, str(a.device))(a, b))


def lpips(img1, img2) -> float:
    """Perceptual distance of two [3, H, W] images in [0, 1]; NaN when
    `MM3DGS_LPIPS_WEIGHTS` names no file."""
    path = os.environ.get("MM3DGS_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return float("nan")
    return _distance(os.path.abspath(path), img1, img2)


def lpips_proxy(img1, img2) -> float:
    """The always-finite random-VGG16 distance (labeled `lpips_proxy`)."""
    return _distance(None, img1, img2)
