"""Writes TUM-layout and Replica-layout sequences (data/tum.py's and
data/replica.py's input) rendered from the synthetic scene, so the
recorded-dataset paths run without a recording.

The camera follows data/synthetic.py's path over the sequence. Each frame is
rendered by the oracle at the config's native resolution (cam.image_height
x cam.image_width: 640x480 for configs/TUM.yml, 1200x680 for
configs/replica.yml, which the loader resizes to 600x340) and written with
cv2, as a recording's frames are: 8-bit colour, 16-bit depth in
png_depth_scale units.

  * write_synthetic_tum: rgb/<t>.png and depth/<t>.png, listed in rgb.txt
    and depth.txt, and groundtruth.txt with one header line and
    `t tx ty tz qx qy qz qw` c2w rows; frames at `fps` (30: more than the
    loader's 1/32 s de-dup apart), the depth stamps 3 ms and the pose
    stamps 1 ms after the colour ones.
  * write_synthetic_replica: results/frame%06d.jpg (JPEG, as Replica's
    frames are), results/depth%06d.png and traj.txt, one flattened 4x4 c2w
    per line.

Usage: write_synthetic_tum(root, cfg, n_frames) or
write_synthetic_replica(root, cfg, n_frames), with a config whose `cam`
block gives the native intrinsics and png_depth_scale and whose optional
`synthetic` block gives n_gaussians, seed and orbit_radius.
"""
from __future__ import annotations

import os

import cv2
import numpy as np

from ..ops.camera import Camera
from ..ops.render import RenderSettings
from .synthetic import make_scene, render_frame, scene_gaussians, trajectory_w2c
from .synthetic_utmm import T0, _tum_line

def _frames(cfg: dict, n_frames: int, device=None):
    """(index, c2w [4, 4] float64, rgb uint8 HWC BGR, depth uint16) of each
    frame of the config's synthetic scene at its native size."""
    cam_cfg = cfg["cam"]
    syn = cfg.get("synthetic", {}) or {}
    cam = Camera(height=int(cam_cfg["image_height"]), width=int(cam_cfg["image_width"]),
                 fx=cam_cfg["fx"], fy=cam_cfg["fy"], cx=cam_cfg["cx"], cy=cam_cfg["cy"])
    scene = scene_gaussians(make_scene(int(syn.get("seed", 0)), int(syn.get("n_gaussians", 400)),
                                       cam), device)
    rs = RenderSettings(cam=cam)
    orbit = float(syn.get("orbit_radius", 0.15))
    for i in range(n_frames):
        w2c = trajectory_w2c(i / max(n_frames - 1, 1), orbit, np.float64)
        rgb, depth = render_frame(scene, w2c.astype(np.float32), rs)
        bgr = np.round(rgb[::-1].transpose(1, 2, 0) * 255.0).astype(np.uint8)
        yield i, np.linalg.inv(w2c), bgr, np.round(depth * cam_cfg["png_depth_scale"]).astype(
            np.uint16)


def write_synthetic_tum(root: str, cfg: dict, n_frames: int, fps: float = 30.0,
                        device=None) -> None:
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_l, dep_l = ["# color images"], ["# depth images"]
    gt_l = ["# timestamp tx ty tz qx qy qz qw"]
    for i, c2w, bgr, depth in _frames(cfg, n_frames, device):
        t = T0 + i / fps
        name = f"{t:.6f}.png"
        cv2.imwrite(os.path.join(root, "rgb", name), bgr)
        cv2.imwrite(os.path.join(root, "depth", name), depth)
        rgb_l.append(f"{t:.6f} rgb/{name}")
        dep_l.append(f"{t + 0.003:.6f} depth/{name}")
        gt_l.append(_tum_line(t + 0.001, c2w))
    for name, lines in (("rgb.txt", rgb_l), ("depth.txt", dep_l), ("groundtruth.txt", gt_l)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_synthetic_replica(root: str, cfg: dict, n_frames: int, device=None) -> None:
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    traj = []
    for i, c2w, bgr, depth in _frames(cfg, n_frames, device):
        cv2.imwrite(os.path.join(root, "results", f"frame{i:06d}.jpg"), bgr)
        cv2.imwrite(os.path.join(root, "results", f"depth{i:06d}.png"), depth)
        traj.append(" ".join(f"{v:.9f}" for v in c2w.reshape(-1)))
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(traj) + "\n")
