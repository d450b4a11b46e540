"""The port's SLAM with the sharded map (tpu.mesh_devices 2: two gloo ranks,
processes running tests/torch_parallel_workers.py, which imports no JAX) on
the CPU, held against the port on one process and the JAX package on one
device within tests/test_multichip_e2e.py's tolerances (|dATE| < 5e-3 m,
|dPSNR| < 1 dB); and mesh_devices 2 without torchrun refused."""
import json
import os

import numpy as np
import pytest
import torch

from test_e2e import make_cfg
from torch_parallel_workers import finish, start

torch.set_num_threads(1)


def test_mesh_devices_without_torchrun_raises(tmp_path, monkeypatch):
    from mm3dgs_slam_torch.slam.slam import SLAM

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    cfg = make_cfg(tmp_path)
    cfg["tpu"]["mesh_devices"] = 2
    with pytest.raises(ValueError, match="mesh_devices=2 but the world size is 1"):
        SLAM(cfg, device="cpu")


def test_sharded_slam_matches_one_rank_and_jax(tmp_path):
    """The SLAM on 2 gloo ranks (tpu.mesh_devices 2) on a make_cfg-sized
    run (64x80, 30/50 iterations, 3 frames) against the port on one process
    and the JAX package on one device: ATE within 5e-3 m and PSNR within
    1 dB of both, the ranks' poses bit-equal, rank 0 alone writing. The
    three runs go side by side: the two port runs in their own processes,
    the JAX one in this."""
    from mm3dgs_slam_tpu.data.synthetic import SyntheticDataset as JDS
    from mm3dgs_slam_tpu.ops.sh import sh_to_rgb
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM

    cfgs = {}
    for name in ("jax", "one", "two"):
        cfg = make_cfg(tmp_path / name)
        cfg["synthetic"]["n_frames"] = 3
        cfgs[name] = cfg
    cfgs["two"]["tpu"]["mesh_devices"] = 2
    jslam = JSLAM(cfgs["jax"])
    ds = jslam.dataset
    assert isinstance(ds, JDS)
    scene = {k: np.asarray(v) for k, v in dict(
        xyz=ds.scene.xyz, scales=ds.scene.scales, rotations=ds.scene.rotations,
        opacity=ds.scene.opacity, rgb=sh_to_rgb(ds.scene.shs[:, 0, :])).items()}
    runs = {name: start("slam", world, tmp_path / name, dict(
        cfg=np.asarray(json.dumps(cfgs[name])), **{f"scene_{k}": v for k, v in scene.items()}),
        torchrun_env=True) for name, world in (("two", 2), ("one", 1))}
    jslam.run()
    outs = finish(runs["two"], timeout=600)
    finish(runs["one"], timeout=600)
    assert np.array_equal(outs[0]["pose_est"], outs[1]["pose_est"])
    assert np.array_equal(outs[0]["keyframes"], outs[1]["keyframes"])
    res = {k: np.load(os.path.join(c["outputdir"], "results.npz"), allow_pickle=True)
           for k, c in cfgs.items()}
    np.testing.assert_array_equal(res["two"]["pose_est"], outs[0]["pose_est"])
    assert int(outs[0]["rows"]) + int(outs[1]["rows"]) > 0
    assert min(int(o["rows"]) for o in outs) > 0
    ate = {k: float(r["ate_rmse"]) for k, r in res.items()}
    psnr = {k: float(np.mean(r["psnr_list"])) for k, r in res.items()}
    print("ATE", ate, "PSNR", psnr)
    assert ate["two"] < 0.03 and psnr["two"] > 17.0
    for ref in ("one", "jax"):
        assert abs(ate["two"] - ate[ref]) < 5e-3, (ate, ref)
        assert abs(psnr["two"] - psnr[ref]) < 1.0, (psnr, ref)


@pytest.mark.parametrize("variant", ["ba", "splatam"])
def test_sharded_variants_match_one_rank(variant, tmp_path):
    """Bundle adjustment (its pose gradient summed over the ranks) and
    splatam (its tracking at nc 6, its window renders) on 2 ranks against
    one process, at a few iterations (3 frames, 3/4 iterations): the same
    keyframes, the ranks' poses bit-equal, poses within 1e-4 of one rank's
    (the two sum the same gradients in another order)."""
    cfgs = {}
    for name in ("one", "two"):
        cfg = make_cfg(tmp_path / name)
        cfg["synthetic"]["n_frames"] = 3
        cfg["tracking"]["iters"], cfg["mapping"]["iters"] = 3, 4
        cfg["mapping"]["pruning_interval"] = 3
        if variant == "ba":
            cfg["mapping"]["do_BA"] = True
        else:
            cfg["method"] = "splatam"
        cfgs[name] = cfg
    cfgs["two"]["tpu"]["mesh_devices"] = 2
    runs = {name: start("slam", world, tmp_path / name,
                        dict(cfg=np.asarray(json.dumps(cfgs[name]))), torchrun_env=True)
            for name, world in (("two", 2), ("one", 1))}
    two, (one,) = finish(runs["two"], timeout=300), finish(runs["one"], timeout=300)
    assert np.array_equal(two[0]["pose_est"], two[1]["pose_est"])
    assert two[0]["keyframes"].tolist() == one["keyframes"].tolist()
    np.testing.assert_allclose(two[0]["pose_est"], one["pose_est"], atol=1e-4, rtol=0)
    assert int(two[0]["rows"]) + int(two[1]["rows"]) == int(one["rows"])
