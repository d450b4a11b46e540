"""The whole SLAM state between two frames, as numpy arrays, and back.

`export_state(slam)` returns every piece of state that `SLAM._step` and
`Mapper.run_frame` carry from one frame to the next; `restore_state(slam,
state)` sets it on a freshly built `SLAM` (one process), on its device. A
run that exports after frame k and is restored into a new SLAM that steps
frames k+1.. gives the same bits as the run that never stopped. The keys
are the JAX package's attribute paths (its map, Adam, densification
statistics, pose lists, keyframes, keyframe-store poses, covisibility
graph, NIQE window and rng), so a state read from a JAX `SLAM` restores
here too; `seed_pose_list` is the port's own and optional. The wall-time
counters (`tracking_time_sum`, ...) and the frame decomposition are not
state and are not carried.

Every value is an array without objects, so the dict saves with
`np.savez` and loads without pickle: a scalar is a 0-d array, the rng is
the JSON of its `bit_generator.state`, the covisibility graph an edge list
with its keys, and the NIQE window entries that are keyframes are indices
into the keyframes.

Aliasing, which both packages share and a restore rebuilds: a keyframe's
pose is built as `np.asarray(est_pose)`, a view of its frame's row of
`estimate_pose_list`, so it follows the later write of the frame's BA'd
pose into that row until a window's BA replaces it; its keyframe-store
copy (`Mapper._kf_poses`) does not. `*.pose_is_row` marks the poses that
are such views.
"""
from __future__ import annotations

import json
from collections import defaultdict

import numpy as np
import torch

from ..models import gaussians as G


def _np(t) -> np.ndarray:
    return np.array(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def keyframe_arrays(prefix: str, frames, pose_list: np.ndarray) -> dict:
    """KeyFrame records (either package's) as arrays under prefix.<field>:
    idx, pose, the images (absent where None), niqe (NaN where None),
    whether the pose is a view of its frame's row of `pose_list`, and
    same_as: the first position holding the same record (the NIQE window's
    lowest-score frame can become a keyframe twice, one record listed
    twice)."""
    first = {}
    out = {f"{prefix}.idx": np.array([f.idx for f in frames], np.int64),
           f"{prefix}.same_as": np.array([first.setdefault(id(f), i)
                                          for i, f in enumerate(frames)], np.int64),
           f"{prefix}.pose": np.array([np.asarray(f.pose, np.float32) for f in frames],
                                      np.float32).reshape(-1, 7),
           f"{prefix}.niqe": np.array([np.nan if f.niqe is None else f.niqe for f in frames],
                                      np.float64),
           f"{prefix}.pose_is_row": np.array(
               [np.shares_memory(f.pose, pose_list[f.idx]) for f in frames], bool)}
    for name in ("gt_color", "gt_depth", "est_depth"):
        imgs = [getattr(f, name) for f in frames]
        if any(x is not None for x in imgs):
            if any(x is None for x in imgs):
                raise ValueError(f"keyframes mix {name} and None")
            out[f"{prefix}.{name}"] = np.array(imgs)
    return out


def keyframes_from_arrays(prefix: str, state: dict, make, pose_list: np.ndarray) -> list:
    """Inverse of `keyframe_arrays`: `make(idx, gt_color, pose, gt_depth,
    est_depth, niqe)` builds each record; a pose marked as a row view is
    that row of `pose_list` again."""
    idx = state[f"{prefix}.idx"]
    out = []
    for i, k in enumerate(idx):
        same = int(state[f"{prefix}.same_as"][i])
        if same != i:
            out.append(out[same])
            continue
        k = int(k)
        pose = (pose_list[k] if bool(state[f"{prefix}.pose_is_row"][i])
                else np.array(state[f"{prefix}.pose"][i], np.float32))
        img = lambda name: (np.array(state[f"{prefix}.{name}"][i])  # noqa: E731
                            if f"{prefix}.{name}" in state else None)
        niqe = float(state[f"{prefix}.niqe"][i])
        out.append(make(k, img("gt_color"), pose, img("gt_depth"), img("est_depth"),
                        None if np.isnan(niqe) else niqe))
    return out


def mapper_host_arrays(mapper, pose_list: np.ndarray) -> dict:
    """The mapper's host state shared by both packages: keyframes, NIQE
    window, covisibility graph, rng and camera extent."""
    out = {"mapper.camera_extent": np.asarray(float(mapper.camera_extent), np.float64),
           "mapper.rng": np.asarray(json.dumps(mapper.rng.bit_generator.state))}
    out.update(keyframe_arrays("mapper.keyframes", mapper.keyframes, pose_list))
    graph = mapper.covisibility_graph
    out["mapper.covisibility_graph.keys"] = np.array(sorted(graph), np.int64)
    out["mapper.covisibility_graph"] = np.array(
        [(a, b) for a in sorted(graph) for b in sorted(graph[a])], np.int64).reshape(-1, 2)
    window = list(getattr(mapper, "niqe_window", None) or [])
    ids = {id(kf): k for k, kf in enumerate(mapper.keyframes)}
    out["mapper.niqe_window.keyframe"] = np.array([ids.get(id(f), -1) for f in window],
                                                  np.int64)
    out.update(keyframe_arrays("mapper.niqe_window.other",
                               [f for f in window if id(f) not in ids], pose_list))
    return out


def restore_mapper_host(mapper, state: dict, make, pose_list: np.ndarray) -> list:
    """Set what `mapper_host_arrays` holds on a fresh mapper, except that
    the keyframes are returned for the caller to append to its store."""
    mapper.camera_extent = float(state["mapper.camera_extent"])
    mapper.rng.bit_generator.state = json.loads(str(state["mapper.rng"]))
    keyframes = keyframes_from_arrays("mapper.keyframes", state, make, pose_list)
    graph = defaultdict(set)
    for k in state["mapper.covisibility_graph.keys"]:
        graph[int(k)] = set()
    for a, b in state["mapper.covisibility_graph"]:
        graph[int(a)].add(int(b))
    mapper.covisibility_graph = graph
    others = iter(keyframes_from_arrays("mapper.niqe_window.other", state, make, pose_list))
    if hasattr(mapper, "niqe_window"):
        mapper.niqe_window.clear()
        for k in state["mapper.niqe_window.keyframe"]:
            mapper.niqe_window.append(keyframes[k] if k >= 0 else next(others))
    return keyframes


def export_state(slam) -> dict[str, np.ndarray]:
    """Every piece of state one frame carries to the next, as numpy copies
    (see the module docstring)."""
    if slam.mesh.size > 1:
        raise ValueError("export_state reads one process's whole map")
    mp = slam.mapper
    out = {f"gaussians.{f}": _np(getattr(slam.gaussians, f)) for f in G.PARAM_FIELDS}
    for moment in ("mu", "nu"):
        out.update({f"adam.{moment}.{f}": _np(getattr(getattr(slam.adam, moment), f))
                    for f in G.PARAM_FIELDS})
    out["adam.step"] = np.asarray(int(slam.adam.step), np.int64)
    for name in ("max_radii", "grad_accum", "denom"):
        out[f"mapper.{name}"] = _np(getattr(mp, name))
    for name in ("estimate_pose_list", "gt_pose_list", "seed_pose_list"):
        out[name] = np.array(getattr(slam, name))
    out.update(mapper_host_arrays(mp, slam.estimate_pose_list))
    out["mapper.kf_store.poses"] = np.array(mp._kf_poses, np.float32).reshape(-1, 7)
    return out


def restore_state(slam, state: dict) -> None:
    """Set an exported state (this package's or the JAX package's) on a
    freshly built SLAM, on its device."""
    from .mapper import KeyFrame

    if slam.mesh.size > 1:
        raise ValueError("restore_state sets one process's whole map")
    dev = slam.device
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    leaves = lambda p: G.GaussianMap(*(t(state[f"{p}.{f}"]) for f in G.PARAM_FIELDS))  # noqa: E731
    slam.gaussians = leaves("gaussians")
    slam.adam = G.AdamState(leaves("adam.mu"), leaves("adam.nu"), int(state["adam.step"]))
    mp = slam.mapper
    mp.max_radii, mp.grad_accum, mp.denom = (t(state[f"mapper.{k}"])
                                             for k in ("max_radii", "grad_accum", "denom"))
    slam.estimate_pose_list[...] = state["estimate_pose_list"]
    slam.gt_pose_list[...] = state["gt_pose_list"]
    if "seed_pose_list" in state:
        slam.seed_pose_list[...] = state["seed_pose_list"]
    mp.keyframes, mp._kf_tensors, mp._kf_poses = [], [], []
    for kf in restore_mapper_host(mp, state, KeyFrame, slam.estimate_pose_list):
        mp.append_keyframe(kf)
    mp._kf_poses = [np.array(p, np.float32) for p in state["mapper.kf_store.poses"]]
