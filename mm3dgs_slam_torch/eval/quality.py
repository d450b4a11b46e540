"""Frame-quality scoring for keyframe selection (a copy of the JAX
package's eval/quality.py, which is numpy/scipy only).

The reference scores candidate keyframes with pyiqa's NIQE (CPU) and keeps a
sliding window of minimum-score frames (slam/mapper.py:74-78,119-136) —
lower = better.

Two scorers are available:

  * **Full NIQE** (Mittal et al. 2013, the algorithm pyiqa wraps): MSCN/AGGD
    features over sharpness-selected 96x96 patches at two scales (36-dim),
    scored by the Mahalanobis distance to a pristine multivariate-Gaussian
    model with the standard (cov_pris + cov_frame)/2 pooling. The pristine
    model ships as an .npz (``mu`` [36], ``cov`` [36,36], ``patch_size``)
    pointed at by ``MM3DGS_NIQE_MODEL``; fit one from any pristine image
    directory with ``scripts/fit_niqe_model.py``. (pyiqa's pretrained .mat
    is not redistributable/downloadable in this zero-egress environment, so
    absolute values match a model fitted with the same extractor, not
    pyiqa's — the windowed-MIN selection only needs consistent ordering.)
  * **MSCN-contrast proxy** (default when no model file): blur suppresses
    the local-contrast sigma map, so score = -log10(mean sigma) rises with
    blur — same orientation, no model needed.

Window-min selection semantics in the mapper match the reference exactly.
"""
from __future__ import annotations

import os

import numpy as np
from scipy.ndimage import gaussian_filter


def _mscn(gray: np.ndarray, sigma: float = 7.0 / 6.0):
    mu = gaussian_filter(gray, sigma, truncate=3.0)
    sigma_map = np.sqrt(
        np.abs(gaussian_filter(gray * gray, sigma, truncate=3.0) - mu * mu)
    )
    return (gray - mu) / (sigma_map + 1.0), sigma_map


def _gamma(x):
    from scipy.special import gamma

    return gamma(x)


# Precomputed alpha lookup for the AGGD moment-matching fit.
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = (_gamma(2.0 / _GAM) ** 2) / (_gamma(1.0 / _GAM) * _gamma(3.0 / _GAM))


def _aggd_fit(x: np.ndarray):
    """Asymmetric generalized-Gaussian fit (moment matching), returning
    (alpha, left_std, right_std) — the standard BRISQUE/NIQE feature fit."""
    left = x[x < 0]
    right = x[x >= 0]
    lstd = np.sqrt(np.mean(left**2)) if left.size else 1e-6
    rstd = np.sqrt(np.mean(right**2)) if right.size else 1e-6
    gammahat = lstd / max(rstd, 1e-12)
    rhat = np.mean(np.abs(x)) ** 2 / max(np.mean(x**2), 1e-12)
    rhatnorm = rhat * (gammahat**3 + 1) * (gammahat + 1) / (gammahat**2 + 1) ** 2
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm) ** 2)]
    return alpha, lstd, rstd


def niqe_features(mscn: np.ndarray) -> np.ndarray:
    """18 NIQE AGGD features of an MSCN field: (alpha, mean sigma^2) of the
    coefficients + (alpha, mean, left var, right var) x 4 orientations."""
    feats = []
    alpha, l, r = _aggd_fit(mscn.ravel())
    feats += [alpha, (l * l + r * r) / 2.0]
    for shift in [(0, 1), (1, 0), (1, 1), (1, -1)]:
        shifted = np.roll(mscn, shift, axis=(0, 1))
        pp = (mscn * shifted).ravel()
        alpha, l, r = _aggd_fit(pp)
        const = np.sqrt(_gamma(1 / alpha) / _gamma(3 / alpha))
        mean = (r - l) * (_gamma(2 / alpha) / _gamma(1 / alpha)) * const
        feats += [alpha, mean, l * l, r * r]
    return np.array(feats, dtype=np.float64)


def _half(img: np.ndarray) -> np.ndarray:
    """2x2 box downscale (stands in for matlab's antialiased imresize)."""
    h, w = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    x = img[:h, :w]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def niqe_patch_features(gray: np.ndarray, patch_size: int = 96,
                        sharpness_frac: float = 0.75) -> np.ndarray:
    """[P, 36] two-scale AGGD features over sharpness-selected patches.

    Patch selection follows the NIQE release: per-patch mean of the local
    sigma map at scale 1, keep patches above `sharpness_frac` x max. The
    same patch set indexes both scales.
    """
    img = gray.astype(np.float64)
    feats_scales = []
    sharp = None
    for scale in (1, 2):
        mscn, sigma_map = _mscn(img)
        psz = patch_size // scale
        ny, nx = img.shape[0] // psz, img.shape[1] // psz
        if ny == 0 or nx == 0:
            # image smaller than a patch: single whole-image "patch"
            ny = nx = 1
            psz_y, psz_x = img.shape
        else:
            psz_y = psz_x = psz
        pf = []
        sh = []
        for by in range(ny):
            for bx in range(nx):
                sl = (slice(by * psz_y, (by + 1) * psz_y),
                      slice(bx * psz_x, (bx + 1) * psz_x))
                pf.append(niqe_features(mscn[sl]))
                if scale == 1:
                    sh.append(float(sigma_map[sl].mean()))
        feats_scales.append(np.stack(pf))
        if scale == 1:
            sharp = np.asarray(sh)
        img = _half(img)
    n = min(len(feats_scales[0]), len(feats_scales[1]))
    f = np.concatenate([feats_scales[0][:n], feats_scales[1][:n]], axis=1)
    sel = sharp[:n] >= sharpness_frac * sharp[:n].max()
    out = f[sel]
    return out if out.size else f


def niqe_score(gray: np.ndarray, mu_pris: np.ndarray, cov_pris: np.ndarray,
               patch_size: int = 96) -> float:
    """NIQE quality index: Mahalanobis distance between the frame's feature
    Gaussian and the pristine model (lower = more natural)."""
    f = niqe_patch_features(gray, patch_size)
    mu_f = f.mean(axis=0)
    cov_f = np.cov(f, rowvar=False) if f.shape[0] > 1 else np.zeros_like(cov_pris)
    d = mu_pris - mu_f
    icov = np.linalg.pinv((cov_pris + cov_f) / 2.0)
    return float(np.sqrt(max(d @ icov @ d, 0.0)))


_SHIPPED_MODEL = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "assets",
                                               "niqe_model.npz"))


class FrameQuality:
    """Callable scorer: lower = better (NIQE orientation).

    Resolution order for the pristine model: explicit ``model_path`` >
    ``MM3DGS_NIQE_MODEL`` env var > the shipped package model
    (assets/niqe_model.npz, fitted on a procedural pristine corpus by
    scripts/fit_niqe_model.py --synthetic). The MSCN-contrast proxy only
    remains as a last-resort fallback."""

    def __init__(self, model_path: str | None = None):
        self._model = None
        self._patch = 96
        path = (model_path or os.environ.get("MM3DGS_NIQE_MODEL")
                or _SHIPPED_MODEL)
        if path and os.path.exists(path):
            data = np.load(path)
            self._model = (np.asarray(data["mu"]), np.asarray(data["cov"]))
            if "patch_size" in data:
                self._patch = int(data["patch_size"])

    def __call__(self, rgb_chw: np.ndarray) -> float:
        """rgb_chw: [3, H, W] float in [0, 1]."""
        gray = (
            0.299 * rgb_chw[0] + 0.587 * rgb_chw[1] + 0.114 * rgb_chw[2]
        ).astype(np.float64) * 255.0

        if self._model is not None:
            mu, cov = self._model
            return niqe_score(gray, mu, cov, self._patch)

        # Fallback: MSCN local-contrast survival. Blur suppresses the
        # sigma map; score = -log(mean local contrast) so blurrier frames
        # score higher (worse), matching NIQE's orientation.
        _, sigma_map = _mscn(gray)
        return float(-np.log10(np.mean(sigma_map) + 1e-8))
