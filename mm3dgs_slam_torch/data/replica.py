"""Replica sequence loaders (a copy of the JAX package's data/replica.py;
gradslam_datasets/replica.py:13-148).

ReplicaDataset: frames live under ``results/frame*.jpg`` +
``results/depth*.png``; poses are flattened 4x4 rows in ``traj.txt``.

ReplicaV2Dataset: iMAP-style splits under ``<seq>/imap/00`` (train) and
``<seq>/imap/01`` (eval); with ``use_train_split=False`` the train split's
frame 0 (image, depth, pose) is prepended to anchor the eval trajectory
(replica.py:111-148).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .base import RGBDDataset, natsorted


class ReplicaDataset(RGBDDataset):
    def get_filepaths(self):
        colors = natsorted(glob.glob(os.path.join(self.input_folder, "results", "frame*.jpg")))
        depths = natsorted(glob.glob(os.path.join(self.input_folder, "results", "depth*.png")))
        return colors, depths

    def load_poses(self):
        lines = np.loadtxt(os.path.join(self.input_folder, "traj.txt")).reshape(-1, 4, 4)
        return [lines[i].astype(np.float32) for i in range(len(self.color_paths))]


class ReplicaV2Dataset(RGBDDataset):
    """Replica-V2 (iMAP splits), gradslam_datasets/replica.py:69-148."""

    def __init__(self, config_dict, basedir, sequence, use_train_split=True, **kwargs):
        self.use_train_split = bool(use_train_split)
        self._base = basedir
        self._seq = sequence
        super().__init__(config_dict, basedir, sequence, **kwargs)

    def get_filepaths(self):
        seq_dir = os.path.join(self._base, self._seq)
        if self.use_train_split:
            self.split_folder = os.path.join(seq_dir, "imap", "00")
            colors = natsorted(glob.glob(os.path.join(self.split_folder, "rgb", "rgb_*.png")))
            depths = natsorted(glob.glob(os.path.join(self.split_folder, "depth", "depth_*.png")))
            return colors, depths
        self.train_folder = os.path.join(seq_dir, "imap", "00")
        self.split_folder = os.path.join(seq_dir, "imap", "01")
        colors = [os.path.join(self.train_folder, "rgb", "rgb_0.png")] + natsorted(
            glob.glob(os.path.join(self.split_folder, "rgb", "rgb_*.png")))
        depths = [os.path.join(self.train_folder, "depth", "depth_0.png")] + natsorted(
            glob.glob(os.path.join(self.split_folder, "depth", "depth_*.png")))
        return colors, depths

    def load_poses(self):
        poses = []
        if not self.use_train_split:
            train_traj = np.loadtxt(os.path.join(self.train_folder, "traj_w_c.txt")).reshape(-1, 4, 4)
            poses.append(train_traj[0].astype(np.float32))
        traj = np.loadtxt(os.path.join(self.split_folder, "traj_w_c.txt")).reshape(-1, 4, 4)
        n = len(self.color_paths) - len(poses)
        poses.extend(traj[i].astype(np.float32) for i in range(n))
        return poses
