"""Golden full-budget runs of the port on the card, the counterparts of
tests/test_golden.py: configs/synthetic_tum.yml and configs/synthetic_hard.yml,
32 frames each at 640x480 with 100 tracking and 150 mapping iterations, each
on the JAX package's own scene of its config
(mm3dgs_slam_torch/assets/jax_scene_<config>.npz), so the frames are the JAX
golden runs' own. The floors are tests/test_golden.py's.

Marked `gpu` and `slow`; each test checks inside itself for a card and skips
without one. This file imports no JAX (the card's machine has none). Run on
a machine with a card:
    python -m pytest tests/test_torch_golden.py -m gpu --noconftest -s"""
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.gpu, pytest.mark.slow]
ROOT = Path(__file__).resolve().parents[1]


def _golden(name: str, tmp_path):
    """Run the config on its JAX scene on the card: (ATE m, mean PSNR dB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mm3dgs_slam_torch.config import load_config
    from mm3dgs_slam_torch.data.synthetic import jax_scene_path, load_scene
    from mm3dgs_slam_torch.ops import kernels
    from mm3dgs_slam_torch.slam.slam import SLAM

    cfg = load_config(str(ROOT / "configs" / f"{name}.yml"))
    cfg["outputdir"] = str(tmp_path / name)
    slam = SLAM(cfg, device="cuda", scene=load_scene(jax_scene_path(name)))
    kernels.reset_launch_counts()
    slam.run()
    assert slam.failed is None, slam.failed
    r = np.load(Path(cfg["outputdir"]) / "results.npz", allow_pickle=True)
    ate, psnr = float(r["ate_rmse"]), float(np.mean(r["psnr_list"]))
    print(f"[golden {name}] ATE {ate:.6f} m, PSNR {psnr:.3f} dB, SSIM "
          f"{float(np.mean(r['ssim_list'])):.4f}, {slam.gaussians.n} gaussians, "
          f"{len(slam.frame_seconds) / sum(slam.frame_seconds):.4f} frames/s, "
          f"{float(r['avg_tracking_it_time']):.3f} / {float(r['avg_mapping_it_time']):.3f} ms "
          f"per tracking / mapping iteration, kernel launches {kernels.launch_counts()} (by "
          f"nc {kernels.launch_counts_by_nc()}), on {torch.cuda.get_device_name(0)}")
    return ate, psnr


def test_golden_full_budget(tmp_path):
    ate, psnr = _golden("synthetic_tum", tmp_path)
    assert ate < 0.01, f"golden ATE regressed: {ate}"
    assert psnr > 30.0, f"golden PSNR regressed: {psnr}"


def test_golden_hard(tmp_path):
    """Texture, occlusion crossings and photometric noise (sigma 0.01)."""
    ate, psnr = _golden("synthetic_hard", tmp_path)
    assert ate < 0.02, f"hard golden ATE regressed: {ate}"
    assert psnr > 26.0, f"hard golden PSNR regressed: {psnr}"
