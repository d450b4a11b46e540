"""The JAX package's SLAM state between two frames as the port's state dict
(mm3dgs_slam_torch/slam/state.py), and back, read and set from outside the
JAX package's objects.

`jax_export_state(jslam)` holds what `export_state` holds of a port SLAM,
under the same keys, plus the JAX-only `mapper.last_n_added` and
`binning_overflow_frames`; the map, its Adam moments and the densification
statistics keep only the alive prefix, and the keyframe store only the
keyframes' pose rows (1..K; row 0 is the current frame's scratch).
`jax_restore_state(jslam, state)` rebuilds them on a freshly built JAX SLAM,
the capacity padding at `G.required_capacity(n_alive)` as `empty_map` pads.
One chip: a sharded map's per-shard prefixes are not read."""
import numpy as np

import jax.numpy as jnp

from mm3dgs_slam_torch.slam.state import mapper_host_arrays, restore_mapper_host

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "rgb")


def jax_export_state(jslam) -> dict:
    m, adam, mp = jslam.gaussians, jslam.adam, jslam.mapper
    if np.asarray(m.n_alive).ndim != 0:
        raise ValueError("a sharded map (per-shard n_alive) is not read")
    n = int(m.n_alive)
    out = {f"gaussians.{f}": np.array(getattr(m, f))[:n] for f in FIELDS}
    for moment in ("mu", "nu"):
        out.update({f"adam.{moment}.{f}": np.array(getattr(getattr(adam, moment), f))[:n]
                    for f in FIELDS})
    out["adam.step"] = np.asarray(int(adam.step), np.int64)
    for name in ("max_radii", "grad_accum", "denom"):
        out[f"mapper.{name}"] = np.array(getattr(mp, name))[:n]
    for name in ("estimate_pose_list", "gt_pose_list"):
        out[name] = np.array(getattr(jslam, name))
    out.update(mapper_host_arrays(mp, jslam.estimate_pose_list))
    k = len(mp.keyframes)
    out["mapper.kf_store.poses"] = np.array(mp.kf_store.poses)[1:k + 1]
    out["mapper.last_n_added"] = np.asarray(int(mp.last_n_added), np.int64)
    out["binning_overflow_frames"] = np.asarray(jslam.binning_overflow_frames, np.int64)
    return out


def jax_restore_state(jslam, state: dict) -> None:
    from mm3dgs_slam_tpu.models import gaussians as G
    from mm3dgs_slam_tpu.slam.mapper import KeyFrame

    n = int(state["gaussians.xyz"].shape[0])
    cap = G.required_capacity(n)
    m = G.empty_map(cap, jslam.cfg["mapping"]["sh_degree"])

    def rows(g, prefix):
        return {f: getattr(g, f).at[:n].set(jnp.asarray(state[f"{prefix}.{f}"]))
                for f in FIELDS}

    m = m._replace(**rows(m, "gaussians"), n_alive=jnp.asarray(n, jnp.int32))
    adam = G.init_adam(m)
    jslam.gaussians = m
    jslam.adam = G.AdamState(mu=adam.mu._replace(**rows(adam.mu, "adam.mu")),
                             nu=adam.nu._replace(**rows(adam.nu, "adam.nu")),
                             step=jnp.asarray(int(state["adam.step"]), jnp.int32))
    mp = jslam.mapper
    for name in ("max_radii", "grad_accum", "denom"):
        setattr(mp, name, jnp.zeros((cap,), jnp.float32).at[:n].set(state[f"mapper.{name}"]))
    jslam.estimate_pose_list[...] = state["estimate_pose_list"]
    jslam.gt_pose_list[...] = state["gt_pose_list"]
    mp.keyframes = restore_mapper_host(mp, state, KeyFrame, jslam.estimate_pose_list)
    for kf, pose in zip(mp.keyframes, state["mapper.kf_store.poses"]):
        mp.kf_store.append(kf.gt_color, kf.gt_depth, kf.est_depth, np.asarray(pose, np.float32))
    mp.last_n_added = int(state.get("mapper.last_n_added", 0))
    jslam.binning_overflow_frames = [int(i) for i in state.get("binning_overflow_frames", [])]
