"""Low-traffic dataset loaders (a copy of the JAX package's data/extra.py;
present but unregistered in the reference: gradslam_datasets/__init__.py:1-17
comments them out). Registered lazily so that a user switching from the
reference finds every loader name.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from .base import RGBDDataset, natsorted

REGISTRY = {}


def _register(name):
    def deco(cls):
        REGISTRY[name] = cls
        return cls

    return deco


@_register("icl")
class ICLDataset(RGBDDataset):
    """ICL-NUIM (gradslam_datasets/icl.py): rgb/ + depth/ + livingRoom*.gt.sim
    pose files (3x4 row-major chunks separated by blank lines); identity
    poses when there is none."""

    def get_filepaths(self):
        colors = natsorted(glob.glob(os.path.join(self.input_folder, "rgb", "*.png")))
        depths = natsorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        return colors, depths

    def load_poses(self):
        gt_files = glob.glob(os.path.join(self.input_folder, "*.gt.sim"))
        if not gt_files:
            return [np.eye(4, dtype=np.float32) for _ in self.color_paths]
        rows = []
        with open(gt_files[0]) as f:
            chunk = []
            for line in f:
                line = line.strip()
                if not line:
                    continue
                chunk.append([float(v) for v in line.split()])
                if len(chunk) == 3:
                    T = np.eye(4, dtype=np.float32)
                    T[:3, :4] = np.array(chunk, dtype=np.float32)
                    rows.append(T)
                    chunk = []
        return rows[: len(self.color_paths)]


class _PoseDirDataset(RGBDDataset):
    """color/ depth/ directories + per-frame pose .txt files (4x4)."""

    color_dir = "color"
    depth_dir = "depth"
    pose_dir = "pose"
    color_ext = "*.jpg"
    depth_ext = "*.png"

    def get_filepaths(self):
        colors = natsorted(glob.glob(os.path.join(self.input_folder, self.color_dir,
                                                  self.color_ext)))
        depths = natsorted(glob.glob(os.path.join(self.input_folder, self.depth_dir,
                                                  self.depth_ext)))
        return colors, depths

    def load_poses(self):
        pose_files = natsorted(glob.glob(os.path.join(self.input_folder, self.pose_dir, "*.txt")))
        return [np.loadtxt(p).reshape(4, 4).astype(np.float32)
                for p in pose_files][: len(self.color_paths)]


@_register("scannet")
class ScanNetDataset(_PoseDirDataset):
    """ScanNet exports (gradslam_datasets/scannet.py layout)."""


@_register("azure")
class AzureKinectDataset(_PoseDirDataset):
    """Azure-Kinect recordings (gradslam_datasets/azure.py layout)."""


@_register("scannetpp")
class ScanNetPPDataset(RGBDDataset):
    """ScanNet++ DSLR/iphone exports (gradslam_datasets/scannetpp.py):
    undistorted images + a transforms JSON with per-frame c2w."""

    def _meta(self):
        with open(os.path.join(self.input_folder, "transforms.json")) as f:
            return json.load(f)

    def get_filepaths(self):
        frames = self._meta()["frames"]
        colors = [os.path.join(self.input_folder, fr["file_path"]) for fr in frames]
        depths = [os.path.join(self.input_folder, fr.get("depth_path", fr["file_path"]))
                  for fr in frames]
        return colors, depths

    def load_poses(self):
        return [np.array(fr["transform_matrix"], dtype=np.float32)
                for fr in self._meta()["frames"]]


@_register("realsense")
class RealsenseDataset(_PoseDirDataset):
    """RealSense captures (gradslam_datasets/realsense.py layout)."""

    color_dir = "rgb"


@_register("record3d")
class Record3DDataset(_PoseDirDataset):
    """Record3D exports (gradslam_datasets/record3d.py layout)."""

    color_dir = "rgb"


@_register("nerfcapture")
class NeRFCaptureDataset(ScanNetPPDataset):
    """NeRFCapture exports (gradslam_datasets/nerfcapture.py): transforms.json."""


@_register("ai2thor")
class Ai2thorDataset(_PoseDirDataset):
    """AI2-THOR exports (gradslam_datasets/ai2thor.py layout)."""
