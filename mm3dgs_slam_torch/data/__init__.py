"""Dataset loaders. Each yields ``(color HWC float 0-255, depth HW1
meters, intrinsics 4x4, c2w pose 4x4, imu | None)`` per frame
(gradslam_datasets/basedataset.py:324-377). Ported: the synthetic generator
and the UT-MM loader (RGB-D + IMU). The other loaders of the JAX package
(tum, replica, replicav2 and the extra ones) raise NotImplementedError."""
from .synthetic import SyntheticDataset
from .utmm import UTMMDataset

_REGISTRY = {"synthetic": SyntheticDataset, "utmm": UTMMDataset}


def get_dataset_type(name: str):
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    raise NotImplementedError(f"dataset {name!r} is not ported to mm3dgs_slam_torch yet")
