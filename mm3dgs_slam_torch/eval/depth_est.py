"""Monocular depth estimators (JAX counterpart: eval/depth_est.py). Each
estimator runs on the SLAM's device: `estimate_depth(img_chw)` takes the
frame as a [3, H, W] numpy array in [0, 1] and returns an inverse (affine)
depth [H, W], a float32 tensor on that device, which the SLAM rescales per
frame by the LS scale/shift fit (slam/SLAM.py:411-448).

  * ``midas``: MiDaS DPT_Hybrid (utils/depth_utils.py:102-131) from the
    TorchScript bundle at ``MM3DGS_MIDAS_TS`` or torch.hub; offline and
    without a bundle it raises RuntimeError,
  * ``tiny_dpt``: a small conv encoder/decoder whose .npz weights (the JAX
    package's format, e.g. assets/tiny_dpt_synthetic.npz) come from the
    ``dpt_weights`` config key or ``MM3DGS_TINY_DPT_WEIGHTS``; `TinyDPT.fit`
    trains them (scripts/train_tiny_dpt.py),
  * ``synthetic_affine``: the affine inverse-depth oracle 1/(a z + b) from
    GT depth, for tests of the scale/shift and Pearson plumbing.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


class MiDaS:
    """MiDaS DPT_Hybrid; prefers the offline TorchScript bundle
    (MM3DGS_MIDAS_TS) over torch.hub."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        ts_path = os.environ.get("MM3DGS_MIDAS_TS")
        if ts_path and os.path.exists(ts_path):
            self.model = torch.jit.load(ts_path, map_location=self.device)
        else:
            try:
                self.model = torch.hub.load("intel-isl/MiDaS", "DPT_Hybrid")
            except Exception as e:  # noqa: BLE001 — hub raises many kinds offline
                raise RuntimeError(
                    "MiDaS weights unavailable (offline environment). Export a "
                    "TorchScript bundle of DPT_Hybrid and set MM3DGS_MIDAS_TS, or use "
                    "use_gt_depth: true, dpt_model: 'tiny_dpt' with its weights, or "
                    "dpt_model: 'synthetic_affine' for pipeline testing."
                ) from e
        self.model = self.model.to(self.device).eval()
        for p in self.model.parameters():
            p.requires_grad = False

    @torch.no_grad()
    def estimate_depth(self, img_chw: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(img_chw, dtype=np.float32), device=self.device)
        h, w = t.shape[1:3]
        norm = F.interpolate((t[None] - 0.5) / 0.5, size=(384, 512), mode="bilinear",
                             align_corners=False)
        pred = self.model(norm)
        return F.interpolate(pred.unsqueeze(1), size=(h, w), mode="bilinear",
                             align_corners=False).squeeze()


class TinyDPT:
    """Three stride-2 3x3 conv encoder stages (16, 32, 64 channels), a
    decoder of nearest x2 upsampling with skip concatenation, a softplus
    head at half resolution and a x2 output repeat; image -> inverse depth.
    The same parameters as the JAX package's TinyDPT."""

    CH = (16, 32, 64)

    def __init__(self, weights_path: str | None = None, device="cpu"):
        path = weights_path or os.environ.get("MM3DGS_TINY_DPT_WEIGHTS")
        if not path or not os.path.exists(path):
            raise RuntimeError("tiny_dpt weights not found; set dpt_weights or "
                               "MM3DGS_TINY_DPT_WEIGHTS to an .npz of TinyDPT parameters.")
        self.device = torch.device(device)
        with np.load(path) as z:
            self.params = {k: torch.as_tensor(np.asarray(z[k], np.float32), device=self.device)
                           for k in z.files}

    @staticmethod
    def init_params(rng: np.random.Generator) -> dict:
        """Fresh parameters as float32 numpy arrays, drawn from `rng` in the
        JAX package's order (fan-in-scaled normal weights, zero biases)."""
        p = {}
        cin = 3
        for i, c in enumerate(TinyDPT.CH):
            p[f"enc{i}_w"] = (rng.normal(0, 1, (c, cin, 3, 3)) / np.sqrt(cin * 9)).astype(np.float32)
            p[f"enc{i}_b"] = np.zeros((c,), np.float32)
            cin = c
        chs = TinyDPT.CH
        for i in range(len(chs) - 1, 0, -1):
            cin_d = chs[i] + chs[i - 1]  # upsampled + skip
            p[f"dec{i}_w"] = (rng.normal(0, 1, (chs[i - 1], cin_d, 3, 3))
                              / np.sqrt(cin_d * 9)).astype(np.float32)
            p[f"dec{i}_b"] = np.zeros((chs[i - 1],), np.float32)
        p["head_w"] = (rng.normal(0, 1, (1, chs[0], 3, 3)) / np.sqrt(chs[0] * 9)).astype(np.float32)
        p["head_b"] = np.zeros((1,), np.float32)
        return p

    @staticmethod
    def ssi_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Scale/shift-invariant loss: the mean squared difference of the two
        maps, each standardized (population variance + 1e-6)."""
        x, y = pred.reshape(-1), target.reshape(-1)
        xs = (x - x.mean()) / torch.sqrt(x.var(unbiased=False) + 1e-6)
        ys = (y - y.mean()) / torch.sqrt(y.var(unbiased=False) + 1e-6)
        return torch.mean((xs - ys) ** 2)

    @staticmethod
    def fit(imgs: np.ndarray, invs: np.ndarray, steps: int = 600, lr: float = 3e-3,
            seed: int = 0, verbose: bool = False, device="cpu") -> dict:
        """Fit TinyDPT on [N, 3, H, W] images and [N, H, W] inverse depths
        (H, W multiples of 8) with `ssi_loss` and Adam (torch's defaults,
        optax.adam's b1, b2, eps), one image per step in `rng.integers`
        order, on `device`. Returns the best parameters as numpy: those
        after the step whose loss (taken before it) was lowest, as the JAX
        package keeps them."""
        rng = np.random.default_rng(seed)
        dev = torch.device(device)
        best, best_params = np.inf, TinyDPT.init_params(rng)
        params = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in best_params.items()}
        imgs = torch.as_tensor(np.asarray(imgs, np.float32), device=dev)
        invs = torch.as_tensor(np.asarray(invs, np.float32), device=dev)
        opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for it in range(steps):
            i = int(rng.integers(0, imgs.shape[0]))
            opt.zero_grad(set_to_none=True)
            loss = TinyDPT.ssi_loss(TinyDPT.forward(params, imgs[i]), invs[i])
            loss.backward()
            opt.step()
            lf = loss.item()
            if lf < best:
                best = lf
                best_params = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
            if verbose and (it % 100 == 0 or it == steps - 1):
                print(f"step {it}: ssi_loss={lf:.6f} (best {best:.6f})")
        return best_params

    @staticmethod
    def forward(params: dict, img: torch.Tensor) -> torch.Tensor:
        """img [3, H, W] in [0, 1] (H, W multiples of 8) -> inverse depth [H, W].
        Convolutions run in float32 (no TF32 on the card)."""
        def conv(x, name, stride=1):
            return F.conv2d(x, params[f"{name}_w"], params[f"{name}_b"], stride=stride, padding=1)

        def up2(x, d0, d1):
            return x.repeat_interleave(2, dim=d0).repeat_interleave(2, dim=d1)

        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            h = (img[None] - 0.5) * 2.0
            skips = []
            for i in range(len(TinyDPT.CH)):
                h = torch.relu(conv(h, f"enc{i}", stride=2))
                skips.append(h)
            for i in range(len(TinyDPT.CH) - 1, 0, -1):
                h = torch.relu(conv(torch.cat([up2(h, 2, 3), skips[i - 1]], dim=1), f"dec{i}"))
            out = F.softplus(conv(h, "head"))[0, 0]
        return up2(out, 0, 1)

    @torch.no_grad()
    def estimate_depth(self, img_chw: np.ndarray) -> torch.Tensor:
        """Any H, W: zero-padded to multiples of 8, the output cropped back."""
        h, w = img_chw.shape[1:]
        h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
        img = torch.zeros((3, h8, w8), dtype=torch.float32, device=self.device)
        img[:, :h, :w] = torch.as_tensor(np.asarray(img_chw, np.float32), device=self.device)
        return TinyDPT.forward(self.params, img)[:h, :w].contiguous()


class SyntheticAffineDepth:
    """Affine inverse-depth oracle 1/(a*z + b) (+ noise) from the GT depth
    the caller sets in `.gt_depth` before each frame; computed in numpy as
    in the JAX package, then moved to the device."""

    def __init__(self, a: float = 0.8, b: float = 0.1, noise: float = 0.0, seed=0,
                 device="cpu"):
        self.a, self.b, self.noise = a, b, noise
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.gt_depth: np.ndarray | None = None

    def estimate_depth(self, img_chw: np.ndarray) -> torch.Tensor:
        if self.gt_depth is None:
            raise ValueError("SyntheticAffineDepth: set .gt_depth before estimate_depth")
        z = np.maximum(self.gt_depth, 1e-3)
        inv = self.a * (1.0 / z) + self.b
        if self.noise:
            inv = inv + self.noise * self.rng.standard_normal(inv.shape)
        return torch.as_tensor(inv.astype(np.float32), device=self.device)


def get_dpt(model: str, device="cpu", weights: str | None = None):
    m = model.lower()
    if m == "midas":
        return MiDaS(device)
    if m == "tiny_dpt":
        return TinyDPT(weights, device)
    if m == "synthetic_affine":
        return SyntheticAffineDepth(device=device)
    raise ValueError(f"Unknown depth estimate model {model}")
