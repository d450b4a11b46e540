"""The port's IMU path held against the JAX package on the CPU: the Euler
table, the IMU motion model, the IMU pose prior, tracking with the prior,
the UT-MM loader, and the whole slice on a written UT-MM sequence."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.ops import losses as jlosses
from mm3dgs_slam_tpu.ops import pose as jpose

from mm3dgs_slam_tpu.ops.render import render as jrender
from mm3dgs_slam_tpu.slam.tracker import TrackSettings as JTS
from mm3dgs_slam_tpu.slam.tracker import track_frame as jtrack_frame

from mm3dgs_slam_torch.ops import losses as tlosses
from mm3dgs_slam_torch.ops import pose as tpose
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.render import ActivatedGaussians, RenderSettings
from mm3dgs_slam_torch.slam.tracker import TrackSettings, track_frame

from test_torch_slam import IDENTITY, _jrs
from test_utmm_dataset import utmm_cfg, write_utmm_dataset
from utils import random_scene, small_camera

torch.set_num_threads(1)


def _random_pose(rng, scale=0.3):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.concatenate([q, rng.normal(size=3) * scale]).astype(np.float32)


@pytest.mark.parametrize("axes", sorted(tpose._AXES2TUPLE))
def test_euler_matrix_matches_jax(axes):
    rng = np.random.default_rng(sorted(tpose._AXES2TUPLE).index(axes))
    for ai, aj, ak in rng.uniform(-np.pi, np.pi, (4, 3)).astype(np.float32):
        want = np.asarray(jpose.euler_matrix(ai, aj, ak, axes))
        got = tpose.euler_matrix(ai, aj, ak, axes).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tpose.euler_sxyz_matrix(0.1, -0.2, 0.3).numpy(),
                                  tpose.euler_matrix(0.1, -0.2, 0.3, "sxyz").numpy())


def _c2i(rng):
    c2i = np.eye(4, dtype=np.float32)
    c2i[:3, :3] = np.asarray(jpose.euler_sxyz_matrix(*rng.uniform(-0.3, 0.3, 3)))[:3, :3]
    c2i[:3, 3] = rng.normal(size=3) * 0.1
    return c2i


@pytest.mark.parametrize("k", [1, 7, 64])
def test_propagate_imu_matches_jax(k):
    """Random poses, extrinsic and k samples; the JAX model pads to 64 rows
    with an identity delta, the port integrates the k rows alone."""
    rng = np.random.default_rng(k)
    for _ in range(3):
        p1, p2, c2i = _random_pose(rng), _random_pose(rng), _c2i(rng)
        ang = rng.normal(size=(k, 3)).astype(np.float32)
        acc = (rng.normal(size=(k, 3)) + [0.0, -9.80665, 0.0]).astype(np.float32)
        pad = 64
        ang_p, acc_p = np.zeros((pad, 3), np.float32), np.zeros((pad, 3), np.float32)
        ang_p[:k], acc_p[:k] = ang, acc
        dt_cam = float(rng.uniform(0.03, 0.2))
        want = np.asarray(jpose.propagate_imu(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ang_p), jnp.asarray(acc_p),
            jnp.asarray(np.arange(pad) < k), jnp.asarray(c2i), dt_cam, 1.0 / 100.0))
        got = tpose.propagate_imu(torch.as_tensor(p1), torch.as_tensor(p2),
                                  torch.as_tensor(ang), torch.as_tensor(acc),
                                  torch.as_tensor(c2i), dt_cam, 1.0 / 100.0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_propagate_imu_with_no_samples_keeps_the_pose():
    rng = np.random.default_rng(5)
    p1, c2i = _random_pose(rng), _c2i(rng)
    got = tpose.propagate_imu(torch.as_tensor(p1), torch.as_tensor(_random_pose(rng)),
                              torch.zeros((0, 3)), torch.zeros((0, 3)), torch.as_tensor(c2i),
                              0.1, 0.01).numpy()
    np.testing.assert_allclose(got[:4] * np.sign(got[0]), p1[:4] * np.sign(p1[0]), atol=2e-6)
    np.testing.assert_allclose(got[4:], p1[4:], atol=2e-6)


@pytest.mark.parametrize("where", ["seed", "away"])
def test_rel_pose_loss_matches_jax(where):
    """Values and gradients; at the seed the arccos clamp binds and the
    angle's gradient is exactly 0 in both packages (no NaN)."""
    rng = np.random.default_rng(9)
    init = _random_pose(rng)
    pose = init.copy() if where == "seed" else init + rng.normal(size=7).astype(np.float32) * 0.05

    def jloss(p):
        t, q = jlosses.rel_pose_loss(p, jnp.asarray(init))
        return t, q

    jt, jq = jloss(jnp.asarray(pose))
    jgt = np.asarray(jax.grad(lambda p: jloss(p)[0])(jnp.asarray(pose)))
    jgq = np.asarray(jax.grad(lambda p: jloss(p)[1])(jnp.asarray(pose)))
    tp = torch.as_tensor(pose).requires_grad_(True)
    tt, tq = tlosses.rel_pose_loss(tp, torch.as_tensor(init))
    (tgt,) = torch.autograd.grad(tt, tp)
    (tgq,) = torch.autograd.grad(tq, tp)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(tq), float(jq), rtol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), jgt, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tgq.numpy(), jgq, rtol=1e-5, atol=1e-7)
    assert np.isfinite(tgq.numpy()).all()
    if where == "seed":
        assert not tgq.any()
    else:
        assert float(tq) > 1e-3 and tgq.abs().max() > 0


def test_track_frame_mm3dgs_imu_prior_matches_jax():
    """method mm3dgs with the IMU prior and the Pearson term, as in
    test_torch_slam.test_track_frame_matches_jax; the seed is off the true
    pose, so the prior pulls against the photometric loss.

    The rotation prior's weight is 0.05, not test_e2e_imu.py's 0.5: its
    gradient is -2 / sqrt(1 - x^2) dx/dq with x = |diff[0]| within ~1e-5 of 1
    in the first steps, where one float32 ulp of x is ~1% of 1 - x. At 0.5
    the term dominates the step, and the one-ulp differences of x that float
    summation order leaves between the two packages move the pose by ~1e-5
    after two steps (in both directions: each package is as far from exact
    arithmetic as the other)."""
    cam = small_camera(h=64, w=80, f=70.0)
    g = random_scene(jax.random.PRNGKey(11), 600, cam, depth_range=(1.5, 5.0))
    g = g._replace(opacity=jnp.clip(g.opacity + 0.7, 0.7, 0.98),
                   scales=jnp.clip(g.scales * 2.0, 0.02, 0.2))
    jrs = _jrs(cam)
    out = jrender(g, jnp.asarray(IDENTITY), jrs)
    gt_color = np.asarray(out["render"])
    gt_depth = np.asarray(out["depth"][0] / jnp.maximum(out["depth"][1], 1e-6))
    seed = np.array([1.0, 0.004, -0.006, 0.005, 0.02, -0.015, 0.01], np.float32)
    kw = dict(iters=6, method="mm3dgs", use_gt_depth=True, use_depth_estimate_loss=True,
              pearson_weight=0.05, use_imu_loss=True, imu_T_weight=0.5, imu_q_weight=0.05,
              position_lr=0.002, rotation_lr=0.002, rebin_every=4)
    jpose_, jloss, _ = jtrack_frame(g, jnp.asarray(seed), jnp.asarray(gt_color),
                                    jnp.asarray(gt_depth), jnp.zeros_like(gt_depth),
                                    JTS(rs=jrs, **kw))
    tg = ActivatedGaussians(*(torch.as_tensor(np.array(x)) for x in g))
    pose, loss = track_frame(tg, torch.as_tensor(seed), torch.as_tensor(gt_color),
                             torch.as_tensor(gt_depth), torch.zeros(gt_depth.shape),
                             TrackSettings(rs=RenderSettings(cam=Camera(*cam)), **kw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose_), atol=2e-6, rtol=0)
    assert np.abs(pose.numpy() - seed).max() > 5e-3
    # the prior is in the loss: without it the same run ends elsewhere
    free, _ = track_frame(tg, torch.as_tensor(seed), torch.as_tensor(gt_color),
                          torch.as_tensor(gt_depth), torch.zeros(gt_depth.shape),
                          TrackSettings(rs=RenderSettings(cam=Camera(*cam)),
                                        **dict(kw, use_imu_loss=False)))
    assert np.abs(free.numpy() - pose.numpy()).max() > 1e-6


def e2e_imu_cfg(root, out, imu_q_weight=0.5):
    """tests/test_e2e_imu.py's config (UTMM.yml's shape at 40x60), with the
    JAX package's static binning caps raised (pair_cap, max_per_tile,
    max_tiles_per_gaussian) so that its bins hold every pair of a map seeded
    one Gaussian per pixel, as the port's exactly sized bins do; at
    test_e2e_imu.py's caps the JAX bins overflow on frame 0 and drop pairs."""
    return {
        "dataset": "utmm", "method": "mm3dgs", "inputdir": root, "scene": "seq",
        "outputdir": out, "use_gt_depth": True, "white_background": False,
        "scene_radius_depth_ratio": 2, "start_idx": 0, "stride": 1,
        "desired_height": 40, "desired_width": 60, "save_iterations": [], "eval_every": 2,
        "debug": {"get_runtime_stats": False, "create_video": False, "save_keyframes": False},
        "pipeline": {"transform_means_python": True, "force_isotropic": True},
        "tracking": {
            "iters": 3, "use_gt_pose": False, "dynamics_model": "imu",
            "use_imu_loss": True, "imu_T_weight": 0.5, "imu_q_weight": imu_q_weight,
            "use_depth_estimate_loss": True, "pearson_weight": 0.001,
            "position_lr": 0.002, "rotation_lr": 0.002,
        },
        "mapping": {
            "iters": 5, "kf_every": 2, "niqe_kf": True, "niqe_window_size": 2,
            "kf_window_size": 4, "covisibility_level": 1,
            "min_covisibility": 0.95, "kf_covisibility": 0.1, "do_BA": False,
            "use_depth_estimate_loss": True, "pearson_weight": 0.001,
            "sh_degree": 0, "cam_t_lr": 0.002, "cam_q_lr": 0.002,
            "position_lr_init": 0.0001, "position_lr_final": 0.0000016,
            "position_lr_delay_mult": 0.01, "position_lr_max_steps": 30000,
            "feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.001,
            "rotation_lr": 0.001, "rgb_lr": 0.0025, "spatial_lr_scale": 1,
            "percent_dense": 0.01, "lambda_dssim": 0.2, "min_opacity": 0.005,
            "densification_interval": 50, "pruning_interval": 5,
            "size_threshold": 200, "opacity_reset_interval": 500,
            "densify_from_iter": 0, "densify_until_iter": 5,
            "densify_grad_threshold": 0.0002,
        },
        "cam": {
            "image_height": 40, "image_width": 60, "fx": 50.0, "fy": 50.0,
            "cx": 30.0, "cy": 20.0, "crop_edge": 0, "png_depth_scale": 1000.0, "fps": 10,
        },
        "tpu": {"pair_cap": 1 << 17, "max_per_tile": 1024, "chunk": 16,
                "max_tiles_per_gaussian": 128, "imu_pad": 16,
                "use_pallas": "never", "rebin_every": 1, "mesh_devices": 1},
    }


def write_pair_sequence(root, n_frames=4):
    """A UT-MM sequence of the synthetic scene at e2e_imu_cfg's 40x60."""
    from mm3dgs_slam_torch.data.synthetic_utmm import write_synthetic_utmm

    cfg = e2e_imu_cfg(root, None)
    cfg["synthetic"] = {"n_gaussians": 400, "seed": 0, "orbit_radius": 0.12}
    write_synthetic_utmm(os.path.join(root, "seq"), cfg, n_frames)


def _pair_run(tmp_path, imu_q_weight):
    """Both packages on one written UT-MM sequence; (port SLAM, JAX SLAM,
    port results, JAX results)."""
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM
    from mm3dgs_slam_torch.slam.slam import SLAM

    root = str(tmp_path / "data")
    write_pair_sequence(root)
    jslam = JSLAM(e2e_imu_cfg(root, str(tmp_path / "jax"), imu_q_weight=imu_q_weight))
    tslam = SLAM(e2e_imu_cfg(root, str(tmp_path / "torch"), imu_q_weight=imu_q_weight),
                 device="cpu")
    jslam.run()
    tslam.run()
    assert tslam.failed is None
    assert seeded_frames(tslam) == [1, 2, 3]
    jr = np.load(tmp_path / "jax" / "results.npz", allow_pickle=True)
    tr = np.load(tmp_path / "torch" / "results.npz", allow_pickle=True)
    assert len(jr["binning_overflow_frames"]) == 0
    np.testing.assert_allclose(tr["pose_gt"], jr["pose_gt"], atol=1e-6)
    assert [kf.idx for kf in tslam.mapper.keyframes] == [kf.idx for kf in jslam.mapper.keyframes]
    np.testing.assert_allclose(tr["psnr_list"], jr["psnr_list"], atol=0.05)
    # the tracker moved every frame away from its seed
    assert np.abs(np.diff(tr["pose_est"], axis=0)).max() > 1e-3
    return tslam, jslam, tr, jr


def seeded_frames(slam) -> list:
    """The frames the motion model seeded (a seed pose that is not NaN)."""
    return np.flatnonzero(~np.isnan(slam.seed_pose_list[:, 0])).tolist()


def test_whole_slice_imu_matches_jax(tmp_path):
    """Both packages on one written UT-MM sequence of the synthetic scene (4
    frames, 40x60, an IMU stream from its trajectory): loader, IMU seed on
    every tracked frame, IMU prior, Pearson terms in tracking and mapping,
    isotropic splats, partial 16x16 tiles, with the rotation prior at a
    tenth of its weight (test_track_frame_mm3dgs_imu_prior_matches_jax's
    0.05); test_whole_slice_imu_prior_at_full_weight_matches_jax runs
    test_e2e_imu.py's 0.5. Not on test_utmm_dataset.py's random-noise
    frames: tracking on them is chaotic, and the packages' float rounding
    alone leads them ~1e-3 apart in three frames."""
    _, _, tr, jr = _pair_run(tmp_path, imu_q_weight=0.05)
    np.testing.assert_allclose(tr["pose_est"], jr["pose_est"], atol=1e-5, rtol=0)


def test_whole_slice_imu_prior_at_full_weight_matches_jax(tmp_path):
    """As test_whole_slice_imu_matches_jax at test_e2e_imu.py's own rotation
    prior weight, 0.5, at the same pose tolerance (the packages' tracked
    poses lie 2.6e-7 apart on this sequence)."""
    _, _, tr, jr = _pair_run(tmp_path, imu_q_weight=0.5)
    np.testing.assert_allclose(tr["pose_est"], jr["pose_est"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("stride,size", [(1, (20, 30)), (2, (40, 60))])
def test_utmm_loader_matches_jax(tmp_path, stride, size):
    """The port's UT-MM loader (cv2) against the JAX package's (imageio,
    cv2) on frames imageio wrote: equal to the bit."""
    from mm3dgs_slam_tpu.data import get_dataset_type as jget
    from mm3dgs_slam_torch.data import get_dataset_type as tget

    write_utmm_dataset(str(tmp_path / "seq"), n=5)
    kw = dict(config_dict=utmm_cfg(), basedir=str(tmp_path), sequence="seq", stride=stride,
              start=0, end=-1, desired_height=size[0], desired_width=size[1])
    jds, tds = jget("utmm")(**kw), tget("utmm")(**kw)
    assert len(tds) == len(jds) == (5 + stride - 1) // stride
    assert tds.tstamps == jds.tstamps
    np.testing.assert_array_equal(tds.get_c2i_tf(), jds.get_c2i_tf())
    for i in range(len(jds)):
        (jc, jd, jk, jp, ji), (tc, td, tk, tp, ti) = jds[i], tds[i]
        assert tc.dtype == jc.dtype and tc.shape == jc.shape == size + (3,)
        for a, b in ((tc, jc), (td, jd), (tk, jk), (tp, jp), (ti, ji)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if stride == 2:   # strided-out frames' IMU rows are concatenated
        assert tds[1][4].shape[0] == 8


@pytest.mark.parametrize("stride,size", [(1, (40, 60)), (1, (20, 30)), (2, (33, 64))])
def test_utmm_loader_on_cv2_frames_matches_jax(tmp_path, stride, size):
    """Both loaders on the synthetic UT-MM sequence, whose PNGs cv2 writes
    with libpng's adaptive row filters, as a recording's are: colour, depth,
    K, c2w and the IMU rows equal to the bit, at the native size, shrunk and
    grown."""
    from mm3dgs_slam_tpu.data import get_dataset_type as jget
    from mm3dgs_slam_torch.data import get_dataset_type as tget

    write_pair_sequence(str(tmp_path))
    kw = dict(config_dict=e2e_imu_cfg(str(tmp_path), None), basedir=str(tmp_path),
              sequence="seq", stride=stride, start=0, end=-1, desired_height=size[0],
              desired_width=size[1])
    jds, tds = jget("utmm")(**kw), tget("utmm")(**kw)
    assert len(tds) == len(jds) == (4 + stride - 1) // stride
    assert tds.tstamps == jds.tstamps
    for i in range(len(jds)):
        (jc, jd, jk, jp, ji), (tc, td, tk, tp, ti) = jds[i], tds[i]
        assert tc.shape == size + (3,) and 0 < tc.max() <= 255 and td.max() > 0
        for a, b in ((tc, jc), (td, jd), (tk, jk), (tp, jp), (ti, ji)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


UNPORTED = {
    "splatam": lambda c: c.update(method="splatam"),
    "do_BA": lambda c: c["mapping"].update(do_BA=True),
    "resume": lambda c: c.update(iteration=3),
    "create_video": lambda c: c["debug"].update(create_video=True),
    "dataset_tum": lambda c: c.update(dataset="tum"),
    "dataset_replica": lambda c: c.update(dataset="replica"),
}
PORTED = {
    "imu_dynamics": lambda c: c["tracking"].update(dynamics_model="imu"),
    "imu_loss": lambda c: c["tracking"].update(use_imu_loss=True, imu_T_weight=0.5,
                                               imu_q_weight=0.5),
    "monocular": lambda c: c.update(use_gt_depth=False, dpt_model="synthetic_affine"),
    "mm3dgs": lambda c: c.update(method="mm3dgs"),
}


@pytest.mark.parametrize("key", sorted(UNPORTED) + sorted(PORTED))
def test_unported_config_keys_raise(tmp_path, key):
    """What the port does not run yet raises NotImplementedError when the
    SLAM is constructed; the keys this slice ported construct (on a UT-MM
    sequence, which carries the IMU rows the IMU seed needs)."""
    from mm3dgs_slam_torch.slam.slam import SLAM

    root = str(tmp_path / "data")
    write_utmm_dataset(os.path.join(root, "seq"), n=2, h=40, w=60)
    cfg = e2e_imu_cfg(root, str(tmp_path / "out"))
    cfg["tracking"].update(dynamics_model="const_velocity", use_imu_loss=False)
    (UNPORTED.get(key) or PORTED[key])(cfg)
    if key in UNPORTED:
        with pytest.raises(NotImplementedError):
            SLAM(cfg, device="cpu")
    else:
        slam = SLAM(cfg, device="cpu")
        assert slam.n_img == 2


@pytest.mark.slow
def test_port_imu_end_to_end_gates(tmp_path):
    """configs/UTMM.yml's settings (100/150 iterations, stride 2, IMU seed,
    Pearson terms, isotropic splats) on a 10-frame synthetic UT-MM sequence
    written at a tenth of UT-MM's 1280x660 and read at half that (64x33,
    partial tiles); tests/test_e2e.py's gates."""
    from mm3dgs_slam_torch.config import load_config
    from mm3dgs_slam_torch.data.synthetic_utmm import write_synthetic_utmm
    from mm3dgs_slam_torch.slam.slam import SLAM

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "UTMM.yml"))
    cam = cfg["cam"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= 0.1
    cam.update(image_height=66, image_width=128)
    cfg.update(inputdir=str(tmp_path / "data"), scene="seq", outputdir=str(tmp_path / "out"),
               desired_height=33, desired_width=64,
               synthetic={"n_gaussians": 2000, "seed": 1, "orbit_radius": 0.12})
    write_synthetic_utmm(os.path.join(cfg["inputdir"], "seq"), cfg, 10)
    slam = SLAM(cfg, device="cpu")
    slam.run()
    assert slam.failed is None
    assert seeded_frames(slam) == [1, 2, 3, 4]
    r = np.load(os.path.join(cfg["outputdir"], "results.npz"), allow_pickle=True)
    assert r["pose_est"].shape == (5, 7)
    assert float(r["ate_rmse"]) < 0.03
    assert np.mean(r["psnr_list"]) > 17.0
