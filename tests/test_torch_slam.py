"""mm3dgs_slam_torch tracker, map optimization and the whole SLAM slice
held against the JAX package on the CPU. The JAX side runs its XLA
compositor (use_pallas: never); the port runs the plain versions of its
kernels; the two agree up to float summation order.

Adam normalizes each gradient entry by its own running RMS, so after the
first steps a parameter moves by about lr whatever its gradient's size; an
entry whose gradient is float noise around zero can step either way. The
map comparisons therefore hold every entry to the tolerance except those
whose JAX gradient was below the noise floor, which are held to the Adam
step bound instead."""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.models import gaussians as JG
from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS
from mm3dgs_slam_tpu.ops.render import render as jrender
from mm3dgs_slam_tpu.slam import map_opt as jmap_opt
from mm3dgs_slam_tpu.slam.tracker import TrackSettings as JTS
from mm3dgs_slam_tpu.slam.tracker import track_frame as jtrack_frame

from mm3dgs_slam_torch.models import gaussians as TG
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.render import ActivatedGaussians, RenderSettings
from mm3dgs_slam_torch.slam import map_opt
from mm3dgs_slam_torch.slam.tracker import TrackSettings, track_frame

from test_e2e import make_cfg
from utils import random_scene, small_camera

torch.set_num_threads(1)
IDENTITY = np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)
RESULT_KEYS = {"pose_est", "pose_gt", "keyframes", "ate_rmse", "psnr_list", "ssim_list",
               "lpips_list", "lpips_proxy_list", "avg_tracking_it_time",
               "avg_mapping_it_time", "avg_rendering_time", "binning_overflow_frames"}


def _jrs(cam):
    return JRS(cam=cam, pair_cap=1 << 17, max_per_tile=1024, chunk=16,
               max_tiles_per_gaussian=128)


def test_track_frame_matches_jax():
    cam = small_camera(h=64, w=80, f=70.0)
    g = random_scene(jax.random.PRNGKey(11), 600, cam, depth_range=(1.5, 5.0))
    g = g._replace(opacity=jnp.clip(g.opacity + 0.7, 0.7, 0.98),
                   scales=jnp.clip(g.scales * 2.0, 0.02, 0.2))
    jrs = _jrs(cam)
    out = jrender(g, jnp.asarray(IDENTITY), jrs)
    gt_color = np.asarray(out["render"])
    gt_depth = np.asarray(out["depth"][0] / jnp.maximum(out["depth"][1], 1e-6))
    jitter = np.array([1.0, 0.004, -0.006, 0.005, 0.02, -0.015, 0.01], np.float32)
    kw = dict(iters=6, use_gt_depth=True, use_depth_estimate_loss=True, pearson_weight=0.05,
              position_lr=0.002, rotation_lr=0.002, rebin_every=4)
    jpose, jloss, _ = jtrack_frame(g, jnp.asarray(jitter), jnp.asarray(gt_color),
                                   jnp.asarray(gt_depth), jnp.zeros_like(gt_depth),
                                   JTS(rs=jrs, method="vigs", **kw))
    tg = ActivatedGaussians(*(torch.as_tensor(np.asarray(x)).clone() for x in g))
    pose, loss = track_frame(tg, torch.as_tensor(jitter), torch.as_tensor(gt_color),
                             torch.as_tensor(gt_depth), torch.zeros(gt_depth.shape),
                             TrackSettings(rs=RenderSettings(cam=Camera(*cam)), **kw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=2e-6, rtol=0)
    # the tracker moved: the comparison is not of two unchanged seeds
    assert np.abs(pose.numpy() - jitter).max() > 5e-3


def _map_setup():
    cam = small_camera(h=48, w=64, f=60.0)
    n, cap = 500, 640
    rng = np.random.default_rng(3)
    z = rng.uniform(1.5, 5.0, n)
    px, py = rng.uniform(0, 64, n), rng.uniform(0, 48, n)
    xyz = np.stack([(px - cam.cx) / cam.fx * z, (py - cam.cy) / cam.fy * z, z], -1)
    m = JG.empty_map(cap)
    idx = np.arange(n)
    m = m._replace(
        xyz=m.xyz.at[idx].set(xyz.astype(np.float32)),
        features_dc=m.features_dc.at[idx].set(rng.normal(size=(n, 1, 3)).astype(np.float32)),
        scaling=m.scaling.at[idx].set(np.log(np.tile((z / cam.fx)[:, None], (1, 3)) * 1.5)
                                      .astype(np.float32)),
        # a few transparent rows give the prune iteration work to do
        opacity=m.opacity.at[idx].set(np.where(rng.uniform(size=(n, 1)) < 0.05, -8.0,
                                               rng.normal(size=(n, 1))).astype(np.float32)),
        n_alive=jnp.asarray(n, jnp.int32))
    K = 2
    colors = rng.uniform(size=(K, 3, 48, 64)).astype(np.float32)
    depths = rng.uniform(1.0, 5.0, size=(K, 48, 64)).astype(np.float32)
    poses = np.stack([IDENTITY, np.array([0.9995, 0.01, -0.02, 0.0, 0.02, 0.01, -0.03],
                                         np.float32)])
    return cam, m, colors, depths, poses


def test_optimize_map_matches_jax():
    """A prune iteration (0), two keyframes, rebins every 3 iterations."""
    cam, jm, colors, depths, poses = _map_setup()
    mp = make_cfg(Path("."))["mapping"]
    hyper = JG.MapOptHyper.from_cfg(mp)
    kw = dict(iters=7, use_gt_depth=True, lambda_dssim=0.2, min_opacity=0.005,
              size_threshold=100.0, pruning_interval=10, densify_from_iter=0,
              densify_until_iter=5, rebin_every=3)
    schedule = np.array([0, 0, 1, 1, 1, 1, 0], np.int32)
    jms = jmap_opt.MapOptSettings(rs=_jrs(cam), method="vigs", hyper=hyper, **kw)
    cap = jm.capacity
    jcarry = jmap_opt.MapCarry(
        m=jm, adam=JG.init_adam(jm), max_radii=jnp.zeros(cap), grad_accum=jnp.zeros(cap),
        denom=jnp.zeros(cap), ba_mask=jnp.ones(cap, bool), kf_poses=jnp.asarray(poses),
        pose_m=jnp.zeros((2, 7)), pose_v=jnp.zeros((2, 7)), pose_step=np.int32(0),
        last_loss=np.float32(0))
    jout, _ = jmap_opt.optimize_map(jcarry, jnp.asarray(colors), jnp.asarray(depths),
                                    jnp.zeros_like(depths), schedule, jnp.asarray(0.5), jms)

    leaves = {f: np.asarray(getattr(jm, f)) for f in JG._PARAM_FIELDS}
    tm = TG.from_numpy_params(leaves | {"n_alive": 500})
    z = torch.zeros(tm.n)
    st = map_opt.MapState(tm, TG.init_adam(tm), z, z.clone(), z.clone())
    ms = map_opt.MapOptSettings(rs=RenderSettings(cam=Camera(*cam)),
                                hyper=TG.MapOptHyper(*hyper), **kw)
    st = map_opt.optimize_map(st, torch.as_tensor(colors), torch.as_tensor(depths),
                              torch.zeros(depths.shape), torch.as_tensor(poses), schedule,
                              0.5, ms)

    n = int(jout.m.n_alive)
    assert st.m.n == n < 500  # the prune removed the same rows
    np.testing.assert_allclose(float(st.last_loss), float(jout.last_loss), rtol=1e-4)
    np.testing.assert_array_equal(st.max_radii.numpy(), np.asarray(jout.max_radii)[:n])
    np.testing.assert_array_equal(st.denom.numpy(), np.asarray(jout.denom)[:n])
    np.testing.assert_allclose(st.grad_accum.numpy(), np.asarray(jout.grad_accum)[:n],
                               rtol=5e-3, atol=5e-5 * float(np.abs(jout.grad_accum).max()))
    steps = 6  # Adam steps taken (iteration 0 pruned)
    for f in JG._PARAM_FIELDS:
        a = getattr(st.m, f).numpy()
        b = np.asarray(getattr(jout.m, f))[:n]
        lr = getattr(hyper, "lr_" + f)
        err = np.abs(a - b)
        # Adam-noise entries: second moment at float-noise level in JAX
        nu = np.asarray(getattr(jout.adam.nu, f))[:n]
        noise = nu < 1e-18
        assert (err[~noise] <= 1e-5 + 1e-3 * np.abs(b[~noise])).all(), f
        assert (err <= 2 * steps * lr + 1e-6).all(), f
        if f in ("features_rest", "rgb"):  # the renderer reads neither
            np.testing.assert_array_equal(a, b)
        elif f != "rotation":  # isotropic rows: rotation gradients are noise
            assert noise.mean() < 0.05, f


def _run_pair(tmp_path, n_frames=3, track_iters=3, map_iters=4):
    from mm3dgs_slam_tpu.data.synthetic import SyntheticDataset as JDS
    from mm3dgs_slam_tpu.ops.sh import sh_to_rgb
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM
    from mm3dgs_slam_torch.slam.slam import SLAM

    cfgs = []
    for name in ("jax", "torch"):
        cfg = make_cfg(tmp_path / name)
        cfg["synthetic"]["n_frames"] = n_frames
        cfg["tracking"]["iters"] = track_iters
        cfg["mapping"]["iters"] = map_iters
        cfg["mapping"]["pruning_interval"] = 3
        cfg["eval_every"] = 1
        cfgs.append(cfg)
    jslam = JSLAM(cfgs[0])
    ds = jslam.dataset
    assert isinstance(ds, JDS)
    scene = dict(xyz=ds.scene.xyz, scales=ds.scene.scales, rotations=ds.scene.rotations,
                 opacity=ds.scene.opacity, rgb=sh_to_rgb(ds.scene.shs[:, 0, :]))
    tslam = SLAM(cfgs[1], device="cpu", scene={k: np.asarray(v) for k, v in scene.items()})
    jslam.run()
    tslam.run()
    return cfgs, jslam, tslam


def test_whole_slice_matches_jax(tmp_path):
    cfgs, jslam, tslam = _run_pair(tmp_path)
    assert tslam.failed is None
    for i in range(len(jslam.dataset)):
        jf, tf = jslam.dataset[i], tslam.dataset[i]
        np.testing.assert_allclose(tf[0] / 255.0, jf[0] / 255.0, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(tf[1], jf[1], atol=2e-4, rtol=1e-4)  # depth = z / sil
    jr = np.load(os.path.join(cfgs[0]["outputdir"], "results.npz"), allow_pickle=True)
    tr = np.load(os.path.join(cfgs[1]["outputdir"], "results.npz"), allow_pickle=True)
    assert set(tr.files) == set(jr.files) == RESULT_KEYS
    np.testing.assert_allclose(tr["pose_est"], jr["pose_est"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr["pose_gt"], jr["pose_gt"], atol=1e-6)
    assert tslam.gaussians.n == int(jslam.gaussians.n_alive)
    assert [kf.idx for kf in tslam.mapper.keyframes] == [kf.idx for kf in jslam.mapper.keyframes]
    np.testing.assert_allclose(tr["psnr_list"], jr["psnr_list"], atol=0.05)
    assert np.isnan(tr["lpips_list"]).all()


def test_run_records_failure_and_still_saves(tmp_path):
    from mm3dgs_slam_torch.slam.slam import SLAM

    cfg = make_cfg(tmp_path)
    cfg["synthetic"]["n_frames"] = 3
    cfg["tracking"]["iters"] = 1
    cfg["mapping"]["iters"] = 1
    slam = SLAM(cfg, device="cpu")
    real_step = slam._step

    def exploding_step(idx):
        if idx == 1:
            raise RuntimeError("injected frame failure")
        return real_step(idx)

    slam._step = exploding_step
    slam.run()
    assert isinstance(slam.failed, RuntimeError)
    r = np.load(os.path.join(cfg["outputdir"], "results.npz"), allow_pickle=True)
    assert r["pose_est"].shape == (1, 7)


def test_cli_exits_nonzero_on_failure(tmp_path, monkeypatch):
    import yaml

    from mm3dgs_slam_torch import __main__ as cli
    from mm3dgs_slam_torch.slam import slam as slam_mod

    cfg = make_cfg(tmp_path)
    cfg["synthetic"]["n_frames"] = 2
    cfg["tracking"]["iters"] = 1
    cfg["mapping"]["iters"] = 1
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    assert cli.main(["--config", str(path), "--device", "cpu"]) == 0

    def boom(self, idx):
        raise RuntimeError("injected")

    monkeypatch.setattr(slam_mod.SLAM, "_step", boom)
    assert cli.main(["--config", str(path), "--device", "cpu"]) == 1


@pytest.mark.slow
def test_port_end_to_end_gates(tmp_path):
    """tests/test_e2e.py's gates on the port's own run of make_cfg."""
    from mm3dgs_slam_torch.models.ply_io import load_ply
    from mm3dgs_slam_torch.slam.slam import SLAM

    cfg = make_cfg(tmp_path)
    slam = SLAM(cfg, device="cpu")
    slam.run()
    assert slam.failed is None
    r = np.load(os.path.join(cfg["outputdir"], "results.npz"), allow_pickle=True)
    assert set(r.files) == RESULT_KEYS
    assert r["pose_est"].shape == (5, 7)
    assert float(r["ate_rmse"]) < 0.03
    assert np.mean(r["psnr_list"]) > 17.0
    ply = os.path.join(cfg["outputdir"], "point_cloud", "iteration_5", "point_cloud.ply")
    assert load_ply(ply)["xyz"].shape[0] > 0
