"""Config loading: the same YAML schema as the JAX package (its config.py),
loaded into a plain nested dict with the required keys validated and the
optional ones defaulted, plus the port's device resolution.

Of the `tpu:` block the port honours only the keys that change results:
`rebin_every`, `map_rebin_every`, `group_mapping_schedule`,
`max_new_per_frame`, `imu_pad` (the IMU seed integrates at most that many
samples per frame; the rest are dropped, as in the JAX package) and
`prefetch` (the frame loop decodes the next frame in a background thread;
on by default). The keys that size or tune TPU buffers (`pair_cap`,
`max_per_tile`, `chunk`, `max_tiles_per_gaussian`, `bin_*`, `pl_*`,
`use_pallas`, `grad_bf16`, `mesh_devices`, `check_overflow`,
`track_tiles`, `pose_kernel`, `map_tiles`) are read and ignored: binning is
sized exactly per frame and the fast paths (tile-layout losses, the fused
pose backward) are always taken. `cfg["device"]` is ignored too; the device
is an argument of the entry points. `dpt_model` and `dpt_weights` (the
TinyDPT .npz) choose the monocular-depth estimator when `use_gt_depth` is
false; `depth_fit` ("ls" | "tum_heuristic") anchors its scale on frame 0.

An unknown dataset name raises ValueError when the SLAM is constructed
(data/__init__.py).
"""
from __future__ import annotations

import copy
from typing import Any

import torch
import yaml

_REQUIRED_TOP = [
    "dataset", "method", "scene", "outputdir", "use_gt_depth",
    "white_background", "scene_radius_depth_ratio", "start_idx", "stride",
    "desired_height", "desired_width", "eval_every",
    "debug", "pipeline", "tracking", "mapping", "cam",
]

_DEFAULTS: dict[str, Any] = {
    "device": "tpu",
    "dataloader": "gradslam",
    "dpt_model": "midas",
    "inputdir": None,
    "save_iterations": [],
    "depth_fit": None,
    "dpt_weights": None,
    "tpu": {
        "max_new_per_frame": -1,       # -1 = one candidate per pixel
        "rebin_every": 1,              # tracking binning refresh cadence
        "map_rebin_every": 1,          # mapping binning refresh cadence
        "group_mapping_schedule": False,  # contiguous per-keyframe blocks
        "imu_pad": 64,                 # IMU samples integrated per frame, at most
    },
}

_BLOCK_DEFAULTS: dict[str, dict[str, Any]] = {
    "debug": {"get_runtime_stats": False, "create_video": False,
              "save_keyframes": False},
    "pipeline": {"convert_SHs_python": False, "compute_cov3D_python": False,
                 "transform_means_python": True, "force_isotropic": False,
                 "use_rgb": False},
    "tracking": {"use_imu_loss": False, "imu_T_weight": 0.0,
                 "imu_q_weight": 0.0, "use_depth_estimate_loss": False,
                 "pearson_weight": 0.0, "dynamics_model": None,
                 "use_gt_pose": False},
    "mapping": {"do_BA": False, "use_depth_estimate_loss": False,
                "pearson_weight": 0.0, "niqe_kf": False,
                "niqe_window_size": 5, "size_threshold": None},
}


def load_config(path: str) -> dict:
    """Load a YAML config with validation + defaults."""
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    return normalize_config(cfg)


def normalize_config(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    missing = [k for k in _REQUIRED_TOP if k not in cfg]
    if missing:
        raise ValueError(f"config missing required keys: {missing}")
    for k, v in _DEFAULTS.items():
        if k not in cfg or cfg[k] is None:
            cfg[k] = copy.deepcopy(v)
        elif isinstance(v, dict):
            merged = copy.deepcopy(v)
            merged.update(cfg[k])
            cfg[k] = merged
    for blk, defaults in _BLOCK_DEFAULTS.items():
        for k, v in defaults.items():
            cfg[blk].setdefault(k, v)
    if cfg["save_iterations"] is None:
        cfg["save_iterations"] = []
    return cfg


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. A CUDA request without a card raises; there is no CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev
