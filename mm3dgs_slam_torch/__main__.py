"""CLI: run SLAM from a YAML config on the GPU (or, on request, the CPU).

    python -m mm3dgs_slam_torch --config configs/synthetic_tum.yml [--device cpu]

Exits non-zero when the run failed (the map and results are saved anyway).
A config with ``tpu.mesh_devices: W > 1`` (the sharded map) is launched as
W ranks:

    torchrun --standalone --nproc_per_node W -m mm3dgs_slam_torch --config <yml>

where a failed rank ends its process with the error and torchrun stops the
others.
"""
from __future__ import annotations

import argparse
import random
import sys

import numpy as np


def run(cfg: dict, device: str = "cuda", scene: str | None = None):
    """Construct and run the SLAM, on the scene .npz at `scene` in place of
    a synthetic config's generated one when given; returns it (its `failed`
    is None on success)."""
    from .data.synthetic import load_scene
    from .slam.slam import SLAM

    slam = SLAM(cfg, device=device, scene=None if scene is None else load_scene(scene))
    slam.run()
    return slam


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="MM3DGS-SLAM, PyTorch/CUDA port")
    parser.add_argument("--config", type=str, required=True, help="path to a YAML config")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; the config's `device` key is ignored")
    args = parser.parse_args(argv)
    random.seed(0)
    np.random.seed(0)
    print("Running with config:", args.config)

    from .config import load_config

    slam = run(load_config(args.config), args.device)
    return 1 if slam.failed is not None else 0


if __name__ == "__main__":
    sys.exit(main())
