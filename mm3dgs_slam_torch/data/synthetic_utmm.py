"""Writes a UT-MM-format sequence (data/utmm.py's input) rendered from the
synthetic scene, so the multimodal path runs without a recording.

The camera follows data/synthetic.py's path over (n_frames - 1) / fps
seconds. Each frame is rendered by the oracle at the config's native
resolution (cam.image_height x cam.image_width). The directory holds:

  * rgb/ and depth/ PNGs written by cv2, as a recording's are (8-bit colour;
    16-bit depth in png_depth_scale units), listed in rgb.txt and depth.txt,
  * groundtruth.txt: the camera pose in the robot frame (the loader maps it
    to the optical frame with _C2R on the right), one header line,
  * tf.txt: the IMU -> camera transform i2c,
  * imu.txt: `imu_hz` rows of a timestamp and 36 values; the angular
    velocity (values 13:16) is the sxyz Euler step of the IMU's rotation
    over the last sample period, divided by it, and the accelerometer
    (values 25:28) is R^T (a + GRAVITY) with the IMU's world acceleration
    `a` by central differences, so that the IMU seed's gravity
    compensation (accel - R^T GRAVITY) recovers R^T a.

Usage: write_synthetic_utmm(root, cfg, n_frames) with a config whose `cam`
block gives the native intrinsics and whose optional `synthetic` block
gives n_gaussians, seed and orbit_radius.
"""
from __future__ import annotations

import os

import cv2
import numpy as np
from scipy.spatial.transform import Rotation

from ..ops.camera import Camera
from ..ops.pose import GRAVITY
from ..ops.render import RenderSettings
from .synthetic import make_scene, render_frame, scene_gaussians, trajectory_w2c
from .utmm import _C2R

IMU_COLUMNS = 36
T0 = 1000.0   # timestamp of frame 0, seconds


def _i2c() -> np.ndarray:
    """A fixed IMU -> camera extrinsic: a small rotation and a lever arm."""
    m = np.eye(4)
    m[:3, :3] = Rotation.from_euler("xyz", [0.02, -0.03, 0.05]).as_matrix()
    m[:3, 3] = [0.05, -0.02, 0.01]
    return m


def _tum_line(t: float, m: np.ndarray) -> str:
    q = Rotation.from_matrix(m[:3, :3]).as_quat()   # x y z w
    return f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*m[:3, 3], *q))


def write_synthetic_utmm(root: str, cfg: dict, n_frames: int, fps: float = 30.0,
                         imu_hz: float = 100.0, device=None) -> None:
    cam_cfg = cfg["cam"]
    syn = cfg.get("synthetic", {}) or {}
    cam = Camera(height=int(cam_cfg["image_height"]), width=int(cam_cfg["image_width"]),
                 fx=cam_cfg["fx"], fy=cam_cfg["fy"], cx=cam_cfg["cx"], cy=cam_cfg["cy"])
    orbit = float(syn.get("orbit_radius", 0.15))
    scene = scene_gaussians(make_scene(int(syn.get("seed", 0)), int(syn.get("n_gaussians", 400)),
                                       cam), device)
    rs = RenderSettings(cam=cam)
    duration = (n_frames - 1) / fps

    def c2w_at(t: float) -> np.ndarray:
        return np.linalg.inv(trajectory_w2c(t / duration, orbit, np.float64))

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_l, dep_l, gt_l = [], [], ["# timestamp tx ty tz qx qy qz qw"]
    r2c = np.eye(4)
    r2c[:3, :3] = _C2R[:3, :3].T
    for i in range(n_frames):
        t = i / fps
        c2w = c2w_at(t)
        rgb, depth = render_frame(scene, np.linalg.inv(c2w).astype(np.float32), rs)
        name = f"{T0 + t:.6f}.png"
        cv2.imwrite(os.path.join(root, "rgb", name),
                    np.round(rgb[::-1].transpose(1, 2, 0) * 255.0).astype(np.uint8))
        cv2.imwrite(os.path.join(root, "depth", name),
                    np.round(depth * cam_cfg["png_depth_scale"]).astype(np.uint16))
        rgb_l.append(f"{T0 + t:.6f} rgb/{name}")
        dep_l.append(f"{T0 + t + 0.003:.6f} depth/{name}")
        gt_l.append(_tum_line(T0 + t + 0.001, c2w @ r2c))

    i2c = _i2c()
    g = GRAVITY.double().numpy()
    dt = 1.0 / imu_hz
    imu_l = []
    for k in range(int(round(duration * imu_hz)) + 2):
        t = k * dt
        pose = [c2w_at(t + o * dt) @ i2c for o in (-1, 0, 1)]
        rot, pos = pose[1][:3, :3], [p[:3, 3] for p in pose]
        accel = (pos[2] - 2.0 * pos[1] + pos[0]) / (dt * dt)
        step = Rotation.from_matrix(pose[0][:3, :3].T @ rot).as_euler("xyz")
        vals = np.zeros(IMU_COLUMNS)
        vals[13:16] = step / dt
        vals[25:28] = rot.T @ (accel + g)
        imu_l.append(f"{T0 + t:.6f} " + " ".join(f"{v:.9f}" for v in vals))

    for name, lines in (("rgb.txt", rgb_l), ("depth.txt", dep_l),
                        ("groundtruth.txt", gt_l), ("imu.txt", imu_l)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "tf.txt"), "w") as f:
        f.write(_tum_line(0.0, i2c).split(" ", 1)[1] + "\n")
