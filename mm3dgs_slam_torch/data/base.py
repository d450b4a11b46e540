"""Base RGB-D(-IMU) sequence loader (a copy of the JAX package's numpy-only
data/base.py). Frames are read and resized with cv2, imported where frames
are read: `cv2.imread(IMREAD_UNCHANGED)` with colour turned from BGR to RGB
gives the arrays the JAX package's imageio reads, so both loaders return
the same bits.

Re-implements the gradslam-style loading contract the SLAM loop consumes
(gradslam_datasets/basedataset.py:105-377):

  * color resized bilinear to (desired_h, desired_w), float HWC in [0, 255],
  * depth resized nearest, divided by png_depth_scale -> meters, HW1,
  * intrinsics rescaled by the resize ratios, returned as a 4x4,
  * poses c2w, normalized relative to frame 0 (basedataset.py:287-305),
  * start/end/stride slicing; IMU rows concatenated across strided-out
    frames (basedataset.py:196-213),
  * optional color undistortion when cam.distortion is present.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np


def natsorted(items):
    """Natural sort (replacement for the natsort dependency)."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def imread(path) -> np.ndarray:
    """An image file as stored: [H, W] gray (8 or 16 bit) or [H, W, 3|4]
    RGB(A), as imageio reads it."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4 else cv2.COLOR_BGR2RGB)
    return img


def as_intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    K = np.eye(3, dtype=np.float64)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def scale_intrinsics(K: np.ndarray, h_ratio: float, w_ratio: float) -> np.ndarray:
    K = K.copy()
    K[0, 0] *= w_ratio
    K[0, 2] *= w_ratio
    K[1, 1] *= h_ratio
    K[1, 2] *= h_ratio
    return K


def relative_transformation(t0: np.ndarray, t1: np.ndarray) -> np.ndarray:
    """inv(t0) @ t1 (gradslam_datasets/geometryutils.py:413-478)."""
    return np.linalg.inv(t0) @ t1


class RGBDDataset:
    """Sequence loader base; subclasses implement get_filepaths/load_poses."""

    has_imu = False

    def __init__(
        self,
        config_dict: dict,
        basedir: str,
        sequence: str,
        stride: Optional[int] = 1,
        start: int = 0,
        end: int = -1,
        desired_height: int = 480,
        desired_width: int = 640,
        relative_pose: bool = True,
        **kwargs,
    ):
        self.name = config_dict["dataset"]
        self.input_folder = os.path.join(basedir, sequence)
        cam = config_dict["cam"]
        self.png_depth_scale = cam["png_depth_scale"]
        self.orig_height = cam["image_height"]
        self.orig_width = cam["image_width"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        self.distortion = (
            np.array(cam["distortion"]) if "distortion" in cam else None
        )
        self.crop_edge = cam.get("crop_edge", None)

        self.desired_height = desired_height
        self.desired_width = desired_width
        self.height_ratio = float(desired_height) / self.orig_height
        self.width_ratio = float(desired_width) / self.orig_width
        self.relative_pose = relative_pose

        if start < 0:
            raise ValueError("start must be non-negative")
        if not (end == -1 or end > start):
            raise ValueError("end must be -1 or greater than start")
        stride = 1 if stride is None else stride

        self.color_paths, self.depth_paths = self.get_filepaths()
        if len(self.color_paths) != len(self.depth_paths):
            raise ValueError("color/depth count mismatch")
        poses = self.load_poses()

        if end == -1:
            end = len(self.color_paths)
        self.start, self.end, self.stride = start, end, stride

        self.color_paths = self.color_paths[start:end:stride]
        self.depth_paths = self.depth_paths[start:end:stride]
        poses = poses[start:end:stride]

        if self.has_imu:
            tstamps = self.load_tstamps()
            self.tstamps = list(tstamps[start:end:stride])
            imus = self.load_imu()
            # Concatenate IMU rows across strided-out frames so each retained
            # frame carries every sample since the previous retained frame
            # (basedataset.py:196-213).
            concat, idx = [], 0
            while idx < end:
                rows = []
                for _ in range(stride):
                    if idx >= end:
                        break
                    rows.append(np.atleast_2d(imus[idx]))
                    idx += 1
                concat.append(np.concatenate(rows, axis=0) if rows else np.zeros((0, 36)))
            self.imus = concat

        self.poses = np.stack(poses).astype(np.float32)
        if relative_pose:
            first = self.poses[0]
            self.poses = np.stack(
                [relative_transformation(first, p) for p in self.poses]
            ).astype(np.float32)

        self.num_imgs = len(self.color_paths)

    # --- subclass API -----------------------------------------------------
    def get_filepaths(self):
        raise NotImplementedError

    def load_poses(self) -> List[np.ndarray]:
        raise NotImplementedError

    # --- loading ----------------------------------------------------------
    def __len__(self):
        return self.num_imgs

    def _preprocess_color(self, color: np.ndarray) -> np.ndarray:
        import cv2

        color = cv2.resize(
            color.astype(np.float32),
            (self.desired_width, self.desired_height),
            interpolation=cv2.INTER_LINEAR,
        )
        return color

    def _preprocess_depth(self, depth: np.ndarray) -> np.ndarray:
        import cv2

        depth = cv2.resize(
            depth.astype(np.float64),
            (self.desired_width, self.desired_height),
            interpolation=cv2.INTER_NEAREST,
        )
        return (depth[..., None] / self.png_depth_scale).astype(np.float32)

    def __getitem__(self, index: int):
        import cv2

        color = np.asarray(imread(self.color_paths[index]), dtype=np.float64)
        if self.distortion is not None:
            K = as_intrinsics_matrix(self.fx, self.fy, self.cx, self.cy)
            color = cv2.undistort(color, K, self.distortion)
        color = self._preprocess_color(color)

        dpath = self.depth_paths[index]
        depth_raw = np.asarray(imread(dpath), dtype=np.int64)
        depth = self._preprocess_depth(depth_raw)

        K = as_intrinsics_matrix(self.fx, self.fy, self.cx, self.cy)
        K = scale_intrinsics(K, self.height_ratio, self.width_ratio)
        intrinsics = np.eye(4, dtype=np.float32)
        intrinsics[:3, :3] = K

        pose = self.poses[index]

        imu = None
        if self.has_imu:
            imu = self.imus[index].astype(np.float32)

        return color.astype(np.float32), depth, intrinsics, pose, imu


def pose_matrix_from_tum_quaternion(pvec: np.ndarray) -> np.ndarray:
    """[tx ty tz qx qy qz qw] -> 4x4 (TUM groundtruth row convention)."""
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_quat(pvec[3:7]).as_matrix()
    T[:3, 3] = pvec[:3]
    return T
