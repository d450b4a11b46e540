"""Golden full-budget runner with the optional per-frame wall decomposition
(JAX counterpart: scripts/run_golden.py).

    python -m mm3dgs_slam_torch.scripts.run_golden [--config configs/synthetic_tum.yml]
        [--outdir DIR] [--decomp] [--frames N] [--scene PATH] [--device cuda|cpu]
        [--mesh-devices W]

Runs the SLAM on the config (a synthetic one by default) on the card unless
--device says otherwise. --decomp turns on debug.frame_decomp (the phase
table and its results.npz keys); --frames overrides synthetic.n_frames for
short runs; --scene injects a scene .npz in place of the generated one, e.g.
mm3dgs_slam_torch/assets/jax_scene_synthetic_tum.npz, the JAX package's own
scene of that config, so that the run renders the JAX golden run's frames.
--mesh-devices sets tpu.mesh_devices: W > 1 runs the sharded map, launched
as ``torchrun --standalone --nproc_per_node W -m
mm3dgs_slam_torch.scripts.run_golden --mesh-devices W ...``.
Exits non-zero when the run failed.
"""
from __future__ import annotations

import argparse
import sys

from ..__main__ import run
from ..config import load_config


def golden_config(config: str, outdir: str | None = None, decomp: bool = False,
                  frames: int | None = None, mesh_devices: int | None = None) -> dict:
    """The config with run_golden's overrides applied."""
    cfg = load_config(config)
    if mesh_devices is not None:
        cfg["tpu"]["mesh_devices"] = mesh_devices
    if outdir:
        cfg["outputdir"] = outdir
    if decomp:
        cfg["debug"]["frame_decomp"] = True
    if frames is not None:
        cfg["synthetic"]["n_frames"] = frames
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="golden full-budget run of the port")
    ap.add_argument("--config", default="configs/synthetic_tum.yml")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--decomp", action="store_true",
                    help="per-frame wall decomposition (debug.frame_decomp)")
    ap.add_argument("--frames", type=int, default=None,
                    help="override synthetic n_frames (short profiling runs)")
    ap.add_argument("--scene", default=None, help="a scene .npz to inject")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="tpu.mesh_devices (W > 1: run under torchrun with W ranks)")
    args = ap.parse_args(argv)
    cfg = golden_config(args.config, args.outdir, args.decomp, args.frames, args.mesh_devices)
    slam = run(cfg, args.device, args.scene)
    return 1 if slam.failed is not None else 0


if __name__ == "__main__":
    sys.exit(main())
