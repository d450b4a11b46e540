"""Checkpoint re-render evaluation CLI (JAX counterpart:
scripts/eval_image.py; the reference's scripts/eval_image.py).

    python -m mm3dgs_slam_torch.scripts.eval_image --config <yml> --iteration N [--device cpu]

Builds the SLAM with `iteration: N`, so the map of
``point_cloud/iteration_N`` and the poses of results.npz load (checkpoint
resume), re-renders the run's frames every eval_every on the device (CUDA
unless --device says otherwise) and prints PSNR, SSIM, LPIPS and the LPIPS
proxy.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import load_config


def evaluate(cfg: dict, iteration: int, device: str = "cuda"):
    """(psnrs, ssims, lpipss, proxies) of the run saved in the config's
    output directory, re-rendered from the map of `iteration`."""
    from ..slam.slam import SLAM

    slam = SLAM(dict(cfg, iteration=iteration), device=device)
    last_idx = len(np.load(os.path.join(cfg["outputdir"], "results.npz"),
                           allow_pickle=True)["pose_est"])
    return slam.evaluate_images(last_idx)


def main(argv=None):
    parser = argparse.ArgumentParser(description="re-render a checkpoint and score it")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--iteration", type=int, required=True,
                        help="checkpoint iteration to load")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    psnrs, ssims, lpipss, proxies = evaluate(load_config(args.config), args.iteration,
                                             args.device)
    print("  PSNR : {:>12.7f}".format(np.mean(psnrs)))
    print("  SSIM : {:>12.7f}".format(np.mean(ssims)))
    print("  LPIPS: {:>12.7f}".format(np.nanmean(lpipss) if np.isfinite(lpipss).any()
                                      else float("nan")))
    if not np.isfinite(lpipss).any():
        print("  LPIPS-proxy (random-VGG, uncalibrated): {:>12.7f}".format(np.mean(proxies)))
    return psnrs, ssims, lpipss, proxies


if __name__ == "__main__":
    main()
