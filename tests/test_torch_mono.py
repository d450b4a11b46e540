"""The port's monocular-depth path held against the JAX package on the CPU:
the scale/shift fit, the estimators, the per-frame depth anchoring and the
whole slice with `use_gt_depth: false`."""
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.eval import depth_est as jdepth_est
from mm3dgs_slam_tpu.ops.depth import get_scale_shift_ls as jfit

from mm3dgs_slam_torch.eval import depth_est as tdepth_est
from mm3dgs_slam_torch.ops.depth import get_scale_shift_ls as tfit

from test_e2e import make_cfg
from test_torch_slam import RESULT_KEYS

torch.set_num_threads(1)
WEIGHTS = str(Path(__file__).resolve().parents[1] / "assets" / "tiny_dpt_synthetic.npz")


@pytest.mark.parametrize("masked", [False, True])
def test_scale_shift_fit_matches_jax(masked):
    rng = np.random.default_rng(0)
    z = rng.uniform(0.5, 4.0, (30, 40)).astype(np.float32)
    mask = None
    if masked:   # holes (1/z = inf) and a random subset, as the SLAM masks
        z[rng.uniform(size=z.shape) < 0.1] = 0.0
        mask = (z > 0) & (rng.uniform(size=z.shape) < 0.8)
    est = (0.7 / np.maximum(z, 1e-3) + 0.2 + rng.normal(0, 0.01, z.shape)).astype(np.float32)
    js, jb = jfit(jnp.asarray(est), jnp.asarray(z), None if mask is None else jnp.asarray(mask))
    ts, tb = tfit(torch.as_tensor(est), torch.as_tensor(z),
                  None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose([float(ts), float(tb)], [float(js), float(jb)], rtol=1e-5)
    assert abs(float(ts) - 1 / 0.7) < 0.1


def test_scale_shift_fit_degenerate_guard():
    """An empty mask leaves det 0: the |det| < 1e-12 guard keeps it finite."""
    est, z = torch.ones(4, 5), torch.ones(4, 5)
    s, b = tfit(est, z, torch.zeros(4, 5, dtype=torch.bool))
    js, jb = jfit(jnp.ones((4, 5)), jnp.ones((4, 5)), jnp.zeros((4, 5), bool))
    assert float(s) == float(js) == 0.0 and float(b) == float(jb) == 0.0


@pytest.mark.parametrize("empty", [False, True])
def test_pearson_gradient_matches_jax_and_is_finite_on_an_empty_mask(empty):
    """Values and gradients as the JAX package's; on an empty mask its
    gradient is NaN (0 times the square root's infinite slope at 0) and the
    port's is 0."""
    import jax

    from mm3dgs_slam_tpu.ops.losses import pearson_loss as jpearson
    from mm3dgs_slam_torch.ops.losses import pearson_loss as tpearson

    rng = np.random.default_rng(3)
    d = rng.uniform(1, 4, (24, 32)).astype(np.float32)
    e = rng.uniform(0.2, 1, (24, 32)).astype(np.float32)
    m = np.zeros((24, 32), bool) if empty else rng.uniform(size=(24, 32)) > 0.3
    jv, jg = jax.value_and_grad(lambda x: jpearson(x, jnp.asarray(e), jnp.asarray(m)))(
        jnp.asarray(d))
    td = torch.as_tensor(d).requires_grad_(True)
    tv = tpearson(td, torch.as_tensor(e), torch.as_tensor(m))
    (tg,) = torch.autograd.grad(tv, td)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    if empty:
        assert np.isnan(np.asarray(jg)).any()
        assert not tg.any()
    else:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-9)


def test_monocular_tracking_keeps_a_finite_pose_on_an_empty_presence_mask():
    """Tracking with the Pearson term on the estimate where no pixel's
    silhouette reaches 0.99 (as when the pose leaves the bins it reuses
    between rebins) but Gaussians still cover pixels: the loss is constant,
    and the pose stays at its seed instead of turning NaN."""
    from mm3dgs_slam_torch.data.synthetic import make_scene, scene_gaussians
    from mm3dgs_slam_torch.ops.camera import Camera
    from mm3dgs_slam_torch.ops.render import RenderSettings
    from mm3dgs_slam_torch.slam.tracker import TrackSettings, track_frame

    cam = Camera(height=32, width=48, fx=40.0, fy=40.0, cx=23.5, cy=15.5)
    g = scene_gaussians(make_scene(0, 300, cam))
    g = g._replace(opacity=torch.full_like(g.opacity, 0.02))   # silhouettes below 0.99
    rng = np.random.default_rng(4)
    gt_color = torch.as_tensor(rng.uniform(0, 1, (3, 32, 48)).astype(np.float32))
    est = torch.as_tensor(rng.uniform(0.2, 1, (32, 48)).astype(np.float32))
    seed = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    ts = TrackSettings(rs=RenderSettings(cam=cam), iters=3, use_gt_depth=False,
                       use_depth_estimate_loss=True, pearson_weight=0.05, rebin_every=10)
    pose, loss = track_frame(g, seed, gt_color, torch.zeros(32, 48), est, ts)
    assert torch.equal(pose, seed)
    assert float(loss) == pytest.approx(0.05)


@pytest.mark.parametrize("hw", [(48, 64), (45, 61)])
def test_tiny_dpt_matches_jax(hw):
    """The shipped weights; 45x61 is padded to 48x64 and cropped back."""
    h, w = hw
    img = np.random.default_rng(1).uniform(0, 1, (3, h, w)).astype(np.float32)
    jnet = jdepth_est.TinyDPT(WEIGHTS)
    tnet = tdepth_est.TinyDPT(WEIGHTS)
    want = jnet.estimate_depth(img)
    got = tnet.estimate_depth(img)
    assert got.shape == (h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    if h % 8 == 0 and w % 8 == 0:
        fwd = tdepth_est.TinyDPT.forward(tnet.params, torch.as_tensor(img))
        jf = np.asarray(jdepth_est.TinyDPT.forward(jnet.params, jnp.asarray(img)))
        np.testing.assert_allclose(fwd.numpy(), jf, atol=1e-5, rtol=1e-4)


def test_synthetic_affine_identical():
    gt = np.random.default_rng(2).uniform(0.0, 5.0, (20, 30)).astype(np.float32)
    j, t = jdepth_est.SyntheticAffineDepth(), tdepth_est.SyntheticAffineDepth()
    j.gt_depth = t.gt_depth = gt
    img = np.zeros((3, 20, 30), np.float32)
    np.testing.assert_array_equal(t.estimate_depth(img).numpy(), j.estimate_depth(img))
    with pytest.raises(ValueError):
        tdepth_est.SyntheticAffineDepth().estimate_depth(img)


def test_midas_raises_offline(monkeypatch):
    """No TorchScript bundle and a hub that cannot fetch (patched here, so
    nothing reaches the network): the same RuntimeError as the JAX wrapper."""
    def offline(*args, **kwargs):
        raise OSError("no network")

    monkeypatch.delenv("MM3DGS_MIDAS_TS", raising=False)
    monkeypatch.setattr(torch.hub, "load", offline)
    with pytest.raises(RuntimeError, match="MiDaS weights unavailable"):
        tdepth_est.get_dpt("midas")
    with pytest.raises(RuntimeError, match="MiDaS weights unavailable"):
        jdepth_est.get_dpt("midas")
    with pytest.raises(ValueError):
        tdepth_est.get_dpt("dpt_large")
    with pytest.raises(RuntimeError, match="tiny_dpt weights"):
        tdepth_est.get_dpt("tiny_dpt", weights=str(Path(WEIGHTS).with_name("missing.npz")))


def test_midas_torchscript_bundle_matches_jax(tmp_path, monkeypatch):
    """The MiDaS wrapper on a TorchScript bundle with DPT_Hybrid's I/O
    contract (test_midas_ts.py's tiny model)."""
    from test_midas_ts import _export_tiny_ts

    path = str(tmp_path / "tiny_midas.pt")
    _export_tiny_ts(path)
    monkeypatch.setenv("MM3DGS_MIDAS_TS", path)
    img = np.random.default_rng(3).uniform(0, 1, (3, 30, 41)).astype(np.float32)
    want = jdepth_est.get_dpt("midas").estimate_depth(img)
    got = tdepth_est.get_dpt("midas").estimate_depth(img)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


def _mono_cfg(tmp_path, name, depth_fit=None, n_frames=3, track_iters=3, map_iters=4):
    cfg = make_cfg(tmp_path / name, use_gt_depth=False, dpt_model="synthetic_affine")
    if depth_fit is not None:
        cfg["depth_fit"] = depth_fit
    cfg["synthetic"]["n_frames"] = n_frames
    cfg["tracking"]["iters"] = track_iters
    cfg["mapping"]["iters"] = map_iters
    cfg["mapping"]["pruning_interval"] = 3
    cfg["eval_every"] = 1
    for blk in ("tracking", "mapping"):
        cfg[blk]["use_depth_estimate_loss"] = True
        cfg[blk]["pearson_weight"] = 0.02
    return cfg


def _pair(tmp_path, **kw):
    """The JAX and the port SLAM on one synthetic scene (test_torch_slam's
    _run_pair), monocular; not yet run."""
    from mm3dgs_slam_tpu.ops.sh import sh_to_rgb
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM
    from mm3dgs_slam_torch.slam.slam import SLAM

    jslam = JSLAM(_mono_cfg(tmp_path, "jax", **kw))
    sc = jslam.dataset.scene
    scene = dict(xyz=sc.xyz, scales=sc.scales, rotations=sc.rotations, opacity=sc.opacity,
                 rgb=sh_to_rgb(sc.shs[:, 0, :]))
    tslam = SLAM(_mono_cfg(tmp_path, "torch", **kw), device="cpu",
                 scene={k: np.asarray(v) for k, v in scene.items()})
    return jslam, tslam


@pytest.mark.parametrize("mode", ["ls", "tum_heuristic"])
def test_fit_est_depth_matches_jax(tmp_path, mode):
    """Frame 0 by `depth_fit`, then frame 1 by the LS fit against the map's
    render at the tracked pose (mask sil > 0.99: compared with a
    tolerance, a pixel at the threshold may fall either way)."""
    jslam, tslam = _pair(tmp_path, depth_fit=mode, n_frames=2, map_iters=2)
    for idx in (0, 1):
        gt = tslam.dataset[idx][1][..., 0]
        est = (0.8 / np.maximum(gt, 1e-3) + 0.1).astype(np.float32)
        want = np.asarray(jslam._fit_est_depth(idx, jnp.asarray(est), jnp.asarray(gt)))
        got = tslam._fit_est_depth(idx, torch.as_tensor(est), torch.as_tensor(gt)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        if mode == "ls" and idx == 0:   # the affine estimate is fitted back to GT
            np.testing.assert_allclose(got[gt > 0], gt[gt > 0], rtol=1e-3)
        if idx == 0:
            jslam._step(0)
            tslam._step(0)
            jslam.estimate_pose_list[1] = tslam.estimate_pose_list[1] = \
                tslam.estimate_pose_list[0]


def test_fit_est_depth_refuses_unknown_anchoring(tmp_path):
    _, tslam = _pair(tmp_path, n_frames=2)
    est = torch.ones(tslam.rs.cam.height, tslam.rs.cam.width)
    tslam.cfg["depth_fit"] = "median"
    with pytest.raises(ValueError, match="unknown depth_fit"):
        tslam._fit_est_depth(0, est, est)
    tslam.cfg["depth_fit"], tslam.cfg["dataset"] = None, "replica"
    with pytest.raises(ValueError, match="no default depth-scale anchoring"):
        tslam._fit_est_depth(0, est, est)


def test_whole_slice_mono_matches_jax(tmp_path):
    """use_gt_depth: false with synthetic_affine, the depth-estimate loss on
    in tracking (nc 5, against the raw estimate) and mapping (nc 4, against
    the scaled one)."""
    jslam, tslam = _pair(tmp_path)
    jslam.run()
    tslam.run()
    assert tslam.failed is None
    jr = np.load(os.path.join(jslam.cfg["outputdir"], "results.npz"), allow_pickle=True)
    tr = np.load(os.path.join(tslam.cfg["outputdir"], "results.npz"), allow_pickle=True)
    assert set(tr.files) == set(jr.files) == RESULT_KEYS
    np.testing.assert_allclose(tr["pose_est"], jr["pose_est"], atol=1e-5, rtol=0)
    assert [kf.idx for kf in tslam.mapper.keyframes] == [kf.idx for kf in jslam.mapper.keyframes]
    for tk, jk in zip(tr["keyframes"], jr["keyframes"]):
        np.testing.assert_allclose(tk["est_depth"], jk["est_depth"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr["psnr_list"], jr["psnr_list"], atol=0.05)
    assert np.abs(np.diff(tr["pose_est"], axis=0)).max() > 1e-3


@pytest.mark.slow
def test_port_mono_end_to_end_gates(tmp_path):
    """tests/test_e2e_mono.py's gates on the port's run of make_cfg with the
    affine estimator and the depth-estimate losses on."""
    from mm3dgs_slam_torch.slam.slam import SLAM

    cfg = make_cfg(tmp_path, use_gt_depth=False, dpt_model="synthetic_affine")
    for blk in ("tracking", "mapping"):
        cfg[blk]["use_depth_estimate_loss"] = True
        cfg[blk]["pearson_weight"] = 0.02
    slam = SLAM(cfg, device="cpu")
    slam.run()
    assert slam.failed is None
    r = np.load(os.path.join(cfg["outputdir"], "results.npz"), allow_pickle=True)
    assert float(r["ate_rmse"]) < 0.06
    assert np.mean(r["psnr_list"]) > 15.0
