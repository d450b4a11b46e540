"""Train the TinyDPT monocular inverse-depth estimator on a dataset (JAX
counterpart: scripts/train_tiny_dpt.py).

    python -m mm3dgs_slam_torch.scripts.train_tiny_dpt --config configs/synthetic.yml \\
        --out tiny_dpt.npz [--steps 600] [--lr 3e-3] [--seed 0] [--device cuda|cpu]
        [--scene PATH]

Reads every frame of the config's dataset through the port's loaders,
zero-pads it to multiples of 8, fits `eval/depth_est.TinyDPT` to the inverse
depth with its scale/shift-invariant loss on --device (the card unless told
otherwise), and writes the .npz that `TinyDPT(weights_path=...)` (and the
`dpt_weights` config key) loads. --scene injects a scene .npz into a
synthetic config's dataset (as run_golden's --scene does).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import load_config, resolve_device


def dataset_arrays(cfg: dict, device="cpu", scene: str | None = None):
    """([N, 3, H8, W8] images in [0, 1], [N, H8, W8] inverse depths) of the
    config's dataset, zero-padded to multiples of 8; `scene`: a scene .npz
    for a synthetic dataset."""
    from ..data import get_dataset_type
    from ..data.synthetic import load_scene

    extra = {}
    if cfg["dataset"].lower() == "synthetic":
        extra = {"device": device, "scene": None if scene is None else load_scene(scene)}
    ds = get_dataset_type(cfg["dataset"])(
        config_dict=cfg, basedir=cfg["inputdir"], sequence=cfg["scene"],
        start=cfg["start_idx"], end=cfg.get("early_stop_idx", -1), stride=cfg["stride"],
        desired_height=cfg["desired_height"], desired_width=cfg["desired_width"], **extra)
    imgs, invs = [], []
    for i in range(len(ds)):
        color, depth, _, _, _ = ds[i]
        h, w = color.shape[:2]
        h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
        img = np.zeros((3, h8, w8), np.float32)
        img[:, :h, :w] = color.transpose(2, 0, 1) / 255.0
        inv = np.zeros((h8, w8), np.float32)
        inv[:h, :w] = 1.0 / np.maximum(depth[..., 0], 1e-3)
        imgs.append(img)
        invs.append(inv)
    return np.stack(imgs), np.stack(invs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train TinyDPT on a config's dataset")
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scene", default=None, help="a scene .npz (synthetic configs)")
    args = ap.parse_args(argv)

    from ..eval.depth_est import TinyDPT

    device = resolve_device(args.device)
    imgs, invs = dataset_arrays(load_config(args.config), device, args.scene)
    print(f"{len(imgs)} frames at {imgs.shape[2]}x{imgs.shape[3]}")
    params = TinyDPT.fit(imgs, invs, steps=args.steps, lr=args.lr, seed=args.seed,
                         verbose=True, device=device)
    np.savez(args.out, **params)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
