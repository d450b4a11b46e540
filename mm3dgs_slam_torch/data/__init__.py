"""Dataset loaders (JAX counterpart: data/__init__.py). Each yields
``(color HWC float 0-255, depth HW1 meters, intrinsics 4x4, c2w pose 4x4,
imu | None)`` per frame (gradslam_datasets/basedataset.py:324-377): the
synthetic generator, tum, utmm, replica and replicav2, and the eight extra
loaders of data/extra.py, imported when first asked for."""
from .replica import ReplicaDataset, ReplicaV2Dataset
from .synthetic import SyntheticDataset
from .tum import TUMDataset
from .utmm import UTMMDataset

_REGISTRY = {
    "tum": TUMDataset,
    "utmm": UTMMDataset,
    "replica": ReplicaDataset,
    "replicav2": ReplicaV2Dataset,
    "synthetic": SyntheticDataset,
}


def get_dataset_type(name: str):
    """The loader class of a dataset name (slam/SLAM.py:27-35); an unknown
    name raises ValueError."""
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    from . import extra

    if key in extra.REGISTRY:
        return extra.REGISTRY[key]
    raise ValueError(f"Unknown dataset {name}")
