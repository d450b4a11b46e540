"""TUM RGB-D sequence loader (a copy of the JAX package's data/tum.py).

Timestamp-associates rgb.txt / depth.txt / groundtruth.txt (max_dt 0.08),
de-duplicates frames closer than 1/32 s, and converts pose rows to c2w
matrices: the behaviour of gradslam_datasets/tum.py:14-159.
"""
from __future__ import annotations

import os

import numpy as np

from .base import RGBDDataset, pose_matrix_from_tum_quaternion


def _parse_list(path: str, skiprows: int = 0) -> np.ndarray:
    return np.loadtxt(path, delimiter=" ", dtype=str, skiprows=skiprows, comments="#")


def associate_frames(t_img, t_depth, t_pose, max_dt=0.08):
    """Greedy nearest-neighbour association of image -> depth -> pose stamps."""
    out = []
    for i, t in enumerate(t_img):
        j = int(np.argmin(np.abs(t_depth - t)))
        if t_pose is None:
            if abs(t_depth[j] - t) < max_dt:
                out.append((i, j))
        else:
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                out.append((i, j, k))
    return out


class TUMDataset(RGBDDataset):
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

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = associate_frames(t_img, t_depth, t_pose)

        # 32 Hz de-dup (tum.py:100-105): keep frames more than 1/32 s apart.
        frame_rate = 32
        keep = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[keep[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                keep.append(i)

        self._assoc_cache = (image_data, depth_data, pose_data, assoc, keep)
        return self._assoc_cache

    def get_filepaths(self):
        image_data, depth_data, _, assoc, keep = self._associations()
        colors, depths = [], []
        for ix in keep:
            i, j, _ = assoc[ix]
            colors.append(os.path.join(self.input_folder, image_data[i, 1]))
            depths.append(os.path.join(self.input_folder, depth_data[j, 1]))
        return colors, depths

    def load_poses(self):
        _, _, pose_data, assoc, keep = self._associations()
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        return [pose_matrix_from_tum_quaternion(pose_vecs[assoc[ix][2]]).astype(np.float32)
                for ix in keep]
