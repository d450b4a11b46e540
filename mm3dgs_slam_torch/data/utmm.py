"""UT-MM multimodal sequence loader (RGB-D + IMU + groundtruth); a copy of
the JAX package's data/utmm.py.

Behavioral contract from gradslam_datasets/utmm.py:13-309:

  * 4-way association rgb/depth/pose/imu-range (max_dt 0.015): each retained
    frame carries every imu.txt row since the previous retained frame,
  * groundtruth robot poses are converted to the camera optical frame via the
    fixed robot->optical rotation (z fwd, x right, y down),
  * imu.txt rows are the 36-column rosbag dump (scripts/bag2data.py:127-158);
    consumers read ang_vel = cols[13:16], lin_accel = cols[25:28] of the
    value part (after the timestamp),
  * tf.txt carries the IMU->camera transform; get_c2i_tf returns its inverse.
"""
from __future__ import annotations

import os

import numpy as np

from .base import RGBDDataset, pose_matrix_from_tum_quaternion

# Robot body frame -> camera optical frame (z forward, x right, y down);
# utmm.py:104-120 applies this on the right of the groundtruth pose.
_C2R = np.array(
    [
        [0.0, 0.0, 1.0, 0.0],
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)

IMU_ANG_VEL_COLS = slice(13, 16)
IMU_LIN_ACCEL_COLS = slice(25, 28)


def _parse_list(path: str, skiprows: int = 0) -> np.ndarray:
    return np.loadtxt(path, delimiter=" ", dtype=str, skiprows=skiprows, comments="#")


def associate_multimodal(t_img, t_depth, t_pose, t_imu, max_dt=0.015):
    """Associate each image with (depth, pose, imu-range) — utmm.py:49-92."""
    out = []
    lstart = 0
    for i, t in enumerate(t_img):
        j = int(np.argmin(np.abs(t_depth - t)))
        k = int(np.argmin(np.abs(t_pose - t)))
        lend = int(np.argmin(np.abs(t_imu - t)))
        if (
            abs(t_depth[j] - t) < max_dt
            and abs(t_pose[k] - t) < max_dt
            and abs(t_imu[lend] - t) < max_dt
        ):
            out.append((i, j, k, np.arange(lstart, lend + 1)))
            lstart = lend + 1
    return out


def pose_matrix_robot_to_optical(pvec: np.ndarray) -> np.ndarray:
    """[t, q(xyzw)] robot pose -> c2w of the camera optical frame."""
    r2w = pose_matrix_from_tum_quaternion(np.concatenate([np.zeros(3), pvec[3:7]]))
    r2w = r2w @ _C2R
    r2w[:3, 3] = pvec[:3]
    return r2w


class UTMMDataset(RGBDDataset):
    has_imu = True

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self._assoc_cache = None
        super().__init__(config_dict, basedir, sequence, **kwargs)

    def _associations(self):
        if self._assoc_cache is not None:
            return self._assoc_cache
        folder = self.input_folder
        if os.path.isfile(os.path.join(folder, "groundtruth.txt")):
            pose_list = os.path.join(folder, "groundtruth.txt")
        else:
            pose_list = os.path.join(folder, "pose.txt")
        image_data = _parse_list(os.path.join(folder, "rgb.txt"))
        depth_data = _parse_list(os.path.join(folder, "depth.txt"))
        pose_data = _parse_list(pose_list, skiprows=1)
        imu_data = _parse_list(os.path.join(folder, "imu.txt"))

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        t_imu = imu_data[:, 0].astype(np.float64)
        assoc = associate_multimodal(t_img, t_depth, t_pose, t_imu)
        self._assoc_cache = (image_data, depth_data, pose_data, imu_data, assoc)
        return self._assoc_cache

    def get_filepaths(self):
        image_data, depth_data, _, _, assoc = self._associations()
        colors, depths = [], []
        for i, j, _, _ in assoc:
            colors.append(os.path.join(self.input_folder, image_data[i, 1]))
            depths.append(os.path.join(self.input_folder, depth_data[j, 1]))
        return colors, depths

    def load_poses(self):
        _, _, pose_data, _, assoc = self._associations()
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        return [
            pose_matrix_robot_to_optical(pose_vecs[k]).astype(np.float32)
            for _, _, k, _ in assoc
        ]

    def load_imu(self):
        _, _, _, imu_data, assoc = self._associations()
        imu_vecs = imu_data[:, 1:].astype(np.float64)
        return [imu_vecs[rng, :].astype(np.float32) for _, _, _, rng in assoc]

    def load_tstamps(self):
        image_data, _, _, _, assoc = self._associations()
        t_img = image_data[:, 0].astype(np.float64)
        return [float(t_img[i]) for i, _, _, _ in assoc]

    def get_c2i_tf(self) -> np.ndarray:
        """camera-optical -> IMU extrinsic from tf.txt (utmm.py:299-309)."""
        tf_vec = np.loadtxt(os.path.join(self.input_folder, "tf.txt")).astype(np.float64)
        i2c = pose_matrix_from_tum_quaternion(tf_vec)
        return np.linalg.inv(i2c).astype(np.float32)
