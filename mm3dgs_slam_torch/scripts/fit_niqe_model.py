"""Fit a NIQE pristine model (mu / cov over the 36 two-scale AGGD features)
from a directory of pristine images, or from generated ones (JAX
counterpart: scripts/fit_niqe_model.py), writing the .npz that
``MM3DGS_NIQE_MODEL`` points at (read by eval/quality.py).

    python -m mm3dgs_slam_torch.scripts.fit_niqe_model --images DIR --out niqe.npz
    python -m mm3dgs_slam_torch.scripts.fit_niqe_model --synthetic N --out niqe.npz

Images are read with cv2 (png, jpg, jpeg, bmp, sorted by path) and turned
to luma 0.299 R + 0.587 G + 0.114 B; features come from the port's
`eval/quality.niqe_patch_features`.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from ..eval.quality import niqe_patch_features


def synth_pristine(rng: np.random.Generator, h: int = 480, w: int = 640) -> np.ndarray:
    """One sharp procedural grey image in [0, 255] with natural-image
    statistics, drawn from `rng` in the JAX package's order: a 1/f^a
    spectral texture, a smooth illumination gradient, 4-9 ellipse occluders
    with crisp edges and their own level and texture gain, and a light gamma."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    a = rng.uniform(0.9, 1.4)
    spec = (f ** -a) * np.exp(2j * np.pi * rng.random((h, fx.shape[1])))
    tex = np.fft.irfft2(spec, s=(h, w))
    tex = (tex - tex.mean()) / (tex.std() + 1e-9)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    gx, gy = rng.normal(0, 0.5, 2)
    illum = gx * (xx / w - 0.5) + gy * (yy / h - 0.5)
    img = 0.5 + 0.18 * tex + 0.2 * illum

    for _ in range(rng.integers(4, 10)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(h / 16, h / 3), rng.uniform(w / 16, w / 3)
        th = rng.uniform(0, np.pi)
        dy, dx = (yy - cy), (xx - cx)
        u = dy * np.cos(th) - dx * np.sin(th)
        v = dy * np.sin(th) + dx * np.cos(th)
        mask = (u / ry) ** 2 + (v / rx) ** 2 < 1.0
        img = np.where(mask, rng.uniform(0.2, 0.8) + rng.uniform(0.05, 0.3) * tex, img)

    img = np.clip(img, 0.0, 1.0) ** rng.uniform(0.8, 1.2)
    return img * 255.0


def read_gray(path: str) -> np.ndarray:
    """An image file as float64 luma (its own bit depth's scale)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise SystemExit(f"cannot read {path}")
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 3:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]   # cv2 reads BGR(A)
        img = 0.299 * r + 0.587 * g + 0.114 * b
    return img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fit a NIQE pristine model")
    ap.add_argument("--images", default=None, help="directory of pristine images")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="fit on N generated pristine images instead")
    ap.add_argument("--out", default="niqe_model.npz")
    ap.add_argument("--patch-size", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    feats = []
    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        for i in range(args.synthetic):
            feats.append(niqe_patch_features(synth_pristine(rng), args.patch_size))
            print(f"synthetic {i}: {feats[-1].shape[0]} patches")
        n_src = args.synthetic
    else:
        if not args.images:
            raise SystemExit("need --images DIR or --synthetic N")
        paths = sorted(p for ext in ("png", "jpg", "jpeg", "bmp")
                       for p in glob.glob(os.path.join(args.images, f"*.{ext}")))
        if not paths:
            raise SystemExit(f"no images found in {args.images}")
        for p in paths:
            feats.append(niqe_patch_features(read_gray(p), args.patch_size))
            print(f"{p}: {feats[-1].shape[0]} patches")
        n_src = len(paths)

    f = np.concatenate(feats, axis=0)
    np.savez(args.out, mu=f.mean(axis=0), cov=np.cov(f, rowvar=False),
             patch_size=args.patch_size)
    print(f"wrote {args.out}: {f.shape[0]} patches from {n_src} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
