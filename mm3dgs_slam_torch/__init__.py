"""PyTorch/CUDA port of the MM3DGS-SLAM system.

A second package beside the JAX reference (`mm3dgs_slam_tpu`): same YAML
config schema, same `results.npz` keys, same PLY attribute schema. The three
tile-compositing kernels run as hand-written CUDA on Hopper (`csrc/`), with a
plain PyTorch version of each one (`ops/composite.py`) that tensors on the
CPU take. Entry point: ``python -m mm3dgs_slam_torch --config <yml>``.

The package imports no JAX and nothing of `mm3dgs_slam_tpu`.
"""

__version__ = "0.1.0"
