"""The port's recorded-dataset loaders (mm3dgs_slam_torch/data: tum,
replica, replicav2, the eight extra loaders, the registry and the
Prefetcher) against the JAX package's on the fixtures of
tests/test_datasets.py. The port reads frames with cv2, the JAX package
with imageio: every frame's colour, depth, intrinsics and pose, and the
length, must be bit-equal."""
import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.data import get_dataset_type as jget
from mm3dgs_slam_torch.data import get_dataset_type as tget

from test_datasets import (replicav2_cfg, tum_cfg, write_replicav2_dataset,
                           write_tum_dataset)

torch.set_num_threads(1)

EXTRA = ["icl", "scannet", "azure", "scannetpp", "realsense", "record3d", "nerfcapture",
         "ai2thor"]


def _pair(name, cfg, root, seq, **kw):
    """The JAX and the port loader of `name` on one directory."""
    kw = dict(dict(stride=1, start=0, end=-1, desired_height=16, desired_width=20), **kw)
    return (jget(name)(config_dict=cfg, basedir=root, sequence=seq, **kw),
            tget(name)(config_dict=cfg, basedir=root, sequence=seq, **kw))


def assert_same_frames(jds, tds):
    """len and every frame's (colour, depth, K, pose, imu) bit-equal."""
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        for got, want in zip(tds[i], jds[i]):
            if want is None:
                assert got is None
            else:
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride,start", [(1, 0), (2, 1), (1, 2)])
def test_tum_loader_matches_jax(tmp_path, stride, start):
    write_tum_dataset(str(tmp_path / "seq"))
    jds, tds = _pair("tum", tum_cfg(), str(tmp_path), "seq", stride=stride, start=start,
                     desired_height=24, desired_width=32)
    assert_same_frames(jds, tds)
    assert len(tds) == len(range(start, 6, stride))


def test_tum_loader_dedup_and_pose_txt_match_jax(tmp_path):
    """Colour stamps closer than 1/32 s are dropped (tum.py:57-64), and
    pose.txt (one row skipped) stands in for a missing groundtruth.txt."""
    root = tmp_path / "seq"
    write_tum_dataset(str(root))
    rgb = (root / "rgb.txt").read_text().splitlines()
    extra = []
    for line in rgb[:4]:     # a second stamp 20 ms after each of four frames
        t, name = line.split()
        extra.append(f"{float(t) + 0.02:.6f} {name}")
    (root / "rgb.txt").write_text("\n".join(sorted(rgb + extra)))
    (root / "groundtruth.txt").rename(root / "pose.txt")
    jds, tds = _pair("tum", tum_cfg(), str(tmp_path), "seq")
    assert_same_frames(jds, tds)
    assert len(tds) == 6     # 10 associated stamps, the 4 close ones dropped


def test_tum_loader_on_the_synthetic_writer_matches_jax(tmp_path):
    """write_synthetic_tum's layout (cv2 PNGs, 30 Hz stamps, offset depth and
    pose stamps, a header line) through both loaders: every frame kept."""
    from mm3dgs_slam_torch.data.synthetic_recorded import write_synthetic_tum

    cfg = tum_cfg()
    cfg["synthetic"] = {"n_gaussians": 200, "seed": 0, "orbit_radius": 0.12}
    write_synthetic_tum(str(tmp_path / "seq"), cfg, 4)
    jds, tds = _pair("tum", cfg, str(tmp_path), "seq", desired_height=48, desired_width=64)
    assert_same_frames(jds, tds)
    assert len(tds) == 4
    assert float(tds[3][1].max()) > 1.0


def _write_replica(root, n=3, h=34, w=60, writer="cv2", depth_scale=6553.5):
    """A Replica layout: JPEG colour frames (written by cv2 or by imageio),
    16-bit depth PNGs and traj.txt."""
    import cv2

    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    rng = np.random.default_rng(2)
    traj = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]   # smooth content plus noise, as a render's
        img = np.stack([xx * 4 + i * 20, yy * 6, (xx + yy) * 2], -1) + rng.normal(0, 8, (h, w, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        path = os.path.join(root, "results", f"frame{i:06d}.jpg")
        if writer == "cv2":
            cv2.imwrite(path, img[:, :, ::-1])
        else:
            imageio.imwrite(path, img)
        depth = (rng.uniform(0.5, 3.0, (h, w)) * depth_scale).astype(np.uint16)
        cv2.imwrite(os.path.join(root, "results", f"depth{i:06d}.png"), depth)
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, -0.05 * i, 0.02 * i]
        traj.append(" ".join(f"{v:.6f}" for v in T.reshape(-1)))
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(traj) + "\n")


def replica_cfg(h=34, w=60):
    return {"dataset": "replica",
            "cam": {"image_height": h, "image_width": w, "fx": 30.0, "fy": 30.0,
                    "cx": w / 2 - 0.5, "cy": h / 2 - 0.5, "png_depth_scale": 6553.5,
                    "crop_edge": 0}}


@pytest.mark.parametrize("writer", ["cv2", "imageio"])
def test_replica_loader_on_jpeg_frames_matches_jax(tmp_path, writer):
    """JPEG frames: the JAX package decodes them with imageio (PIL), the port
    with cv2; both must give the same pixels, resized 2x down as
    replica.yml's 1200x680 -> 600x340."""
    _write_replica(str(tmp_path / "room0"), writer=writer)
    jds, tds = _pair("replica", replica_cfg(), str(tmp_path), "room0", desired_height=17,
                     desired_width=30)
    assert_same_frames(jds, tds)
    assert len(tds) == 3
    np.testing.assert_allclose(tds[2][3][:3, 3], [0.2, -0.1, 0.04], atol=1e-6)


def test_replica_loader_on_the_synthetic_writer_matches_jax(tmp_path):
    from mm3dgs_slam_torch.data.synthetic_recorded import write_synthetic_replica

    cfg = replica_cfg(68, 120)
    cfg["synthetic"] = {"n_gaussians": 200, "seed": 0, "orbit_radius": 0.12}
    write_synthetic_replica(str(tmp_path / "room0"), cfg, 3)
    jds, tds = _pair("replica", cfg, str(tmp_path), "room0", desired_height=34, desired_width=60)
    assert_same_frames(jds, tds)


@pytest.mark.parametrize("train", [True, False])
def test_replicav2_loader_matches_jax(tmp_path, train):
    write_replicav2_dataset(str(tmp_path))
    jds, tds = _pair("replicav2", replicav2_cfg(), str(tmp_path), "room_0",
                     use_train_split=train, relative_pose=False)
    assert_same_frames(jds, tds)
    assert len(tds) == 4


def _write_extra(root, name, n=3, h=24, w=32):
    """The smallest layout each extra loader reads (data/extra.py)."""
    import cv2

    rng = np.random.default_rng(3)
    colors = [(rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8) for _ in range(n)]
    depths = [(rng.uniform(0.5, 3.0, (h, w)) * 1000).astype(np.uint16) for _ in range(n)]
    poses = []
    for i in range(n):
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.02 * i, -0.03 * i]
        poses.append(T)

    def put(rel, img):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        cv2.imwrite(os.path.join(root, rel), img[:, :, ::-1] if img.ndim == 3 else img)

    if name == "icl":
        for i in range(n):
            put(f"rgb/{i}.png", colors[i])
            put(f"depth/{i}.png", depths[i])
        with open(os.path.join(root, "livingRoom0.gt.sim"), "w") as f:
            for T in poses:
                f.write("\n".join(" ".join(f"{v:.6f}" for v in row) for row in T[:3]) + "\n\n")
    elif name in ("scannetpp", "nerfcapture"):
        frames = []
        for i in range(n):
            put(f"images/frame_{i}.png", colors[i])
            put(f"depth/frame_{i}.png", depths[i])
            frames.append({"file_path": f"images/frame_{i}.png",
                           "depth_path": f"depth/frame_{i}.png",
                           "transform_matrix": poses[i].tolist()})
        with open(os.path.join(root, "transforms.json"), "w") as f:
            json.dump({"frames": frames}, f)
    else:
        cdir = "rgb" if name in ("realsense", "record3d") else "color"
        os.makedirs(os.path.join(root, "pose"))
        for i in range(n):
            put(f"{cdir}/{i}.jpg", colors[i])
            put(f"depth/{i}.png", depths[i])
            np.savetxt(os.path.join(root, "pose", f"{i}.txt"), poses[i])


@pytest.mark.parametrize("name", EXTRA)
def test_extra_loader_matches_jax(tmp_path, name):
    _write_extra(str(tmp_path / "seq"), name)
    cfg = dict(tum_cfg(24, 32), dataset=name)
    cfg["cam"]["png_depth_scale"] = 1000.0
    jds, tds = _pair(name, cfg, str(tmp_path), "seq", desired_height=12, desired_width=16)
    assert_same_frames(jds, tds)
    assert len(tds) == 3
    np.testing.assert_allclose(tds[2][3][:3, 3], [0.2, 0.04, -0.06], atol=1e-6)


def test_icl_loader_without_poses_matches_jax(tmp_path):
    """No *.gt.sim: identity poses, as in the JAX package."""
    _write_extra(str(tmp_path / "seq"), "icl")
    for p in (tmp_path / "seq").glob("*.gt.sim"):
        p.unlink()
    cfg = dict(tum_cfg(24, 32), dataset="icl")
    jds, tds = _pair("icl", cfg, str(tmp_path), "seq")
    assert_same_frames(jds, tds)
    assert all(np.array_equal(tds[i][3], np.eye(4, dtype=np.float32)) for i in range(3))


def test_registry_matches_jax():
    """Every name the JAX registry and its extra REGISTRY accept, in any
    case, gives the port's loader of the same name; any other name raises
    ValueError in both."""
    from mm3dgs_slam_tpu.data import _REGISTRY as JREG
    from mm3dgs_slam_tpu.data import extra as jextra
    from mm3dgs_slam_torch.data import _REGISTRY as TREG
    from mm3dgs_slam_torch.data import extra as textra

    assert set(TREG) == set(JREG) and set(textra.REGISTRY) == set(jextra.REGISTRY)
    for name in sorted(set(JREG) | set(jextra.REGISTRY)):
        for key in (name, name.upper()):
            assert tget(key).__name__ == jget(key).__name__
            assert tget(key).__module__.startswith("mm3dgs_slam_torch.")
    for bad in ("nope", "tum2", ""):
        with pytest.raises(ValueError, match="Unknown dataset"):
            jget(bad)
        with pytest.raises(ValueError, match="Unknown dataset"):
            tget(bad)


class _CountingDataset:
    def __init__(self, n=6):
        self.n, self.loads = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.loads.append(i)
        return ("item", i)


@pytest.mark.parametrize("order", ["sequential", "random"])
def test_prefetcher_matches_jax(order):
    """The port's Prefetcher against the JAX package's on one access order:
    the same items and the same loads (sequential access loads each index
    once, ahead), then a direct load after close()."""
    from mm3dgs_slam_tpu.data.prefetch import Prefetcher as JPrefetcher
    from mm3dgs_slam_torch.data.prefetch import Prefetcher

    idx = list(range(6)) if order == "sequential" else [3, 0, 1, 5, 2, 2, 4, 5]
    out = {}
    for name, cls in (("jax", JPrefetcher), ("torch", Prefetcher)):
        ds = _CountingDataset()
        pf = cls(ds)
        try:
            # both orders end on the last index, which schedules no load ahead
            items = [pf[i] for i in idx]
            loads = sorted(ds.loads)
        finally:
            pf.close()
        assert pf[2] == ("item", 2)
        assert len(pf) == 6
        out[name] = (items, loads)
    assert out["torch"] == out["jax"]
    items, loads = out["torch"]
    assert items == [("item", i) for i in idx]
    if order == "sequential":   # each index loaded once ahead, none again
        assert loads == list(range(6))
    off = Prefetcher(_CountingDataset(), enabled=False)
    assert off[4] == ("item", 4) and off._pool is None
