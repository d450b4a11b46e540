"""Dataset loaders. Each yields ``(color HWC float 0-255, depth HW1
meters, intrinsics 4x4, c2w pose 4x4, imu | None)`` per frame
(gradslam_datasets/basedataset.py:324-377). Only the synthetic generator is
ported so far; the real-dataset loaders are still to port."""
from .synthetic import SyntheticDataset

_REGISTRY = {"synthetic": SyntheticDataset}


def get_dataset_type(name: str):
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    raise NotImplementedError(f"dataset {name!r} is not ported to mm3dgs_slam_torch yet")
