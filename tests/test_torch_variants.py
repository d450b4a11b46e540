"""The port's method and feature variants held against the JAX package on the
CPU, piece by piece: splatam's tracking loss (kernel 3 at nc 6) and mapping
loss (kernel 2 at nc 4), the bundle-adjustment pose gradient and pose Adam,
the BA row mask in the map Adam, splatam's candidates, window and keyframes,
the covisible-Gaussian mask, and densification. The JAX side runs its XLA
compositor (use_pallas: never), the port the plain versions of its kernels.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.config import normalize_config as jnormalize
from mm3dgs_slam_tpu.models import densify as jdensify
from mm3dgs_slam_tpu.models import gaussians as JG
from mm3dgs_slam_tpu.ops.render import render as jrender
from mm3dgs_slam_tpu.slam import map_ops as jmap_ops
from mm3dgs_slam_tpu.slam import map_opt as jmap_opt
from mm3dgs_slam_tpu.slam.mapper import KeyFrame as JKeyFrame
from mm3dgs_slam_tpu.slam.mapper import Mapper as JMapper
from mm3dgs_slam_tpu.slam.tracker import TrackSettings as JTS
from mm3dgs_slam_tpu.slam.tracker import tracking_loss as jtracking_loss

from mm3dgs_slam_torch.config import normalize_config
from mm3dgs_slam_torch.models import densify as tdensify
from mm3dgs_slam_torch.models import gaussians as TG
from mm3dgs_slam_torch.ops.binning import build_bins
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.render import (ActivatedGaussians, RenderSettings, project_for_pose,
                                          tile_pixel_valid, to_tiles)
from mm3dgs_slam_torch.slam import map_ops, map_opt
from mm3dgs_slam_torch.slam.mapper import KeyFrame, Mapper
from mm3dgs_slam_torch.slam.tracker import TrackSettings, tracking_loss_tiles

from test_e2e import make_cfg
from test_torch_slam import IDENTITY, _jrs, _map_setup
from utils import random_scene, small_camera

torch.set_num_threads(1)
GRAD_TOL = dict(atol=5e-5, rtol=5e-3)   # per-gaussian grads (tests/test_rasterizer.py)
POSE_RTOL = 5e-4                        # pose grads (tests/test_pose_fused.py)
JITTER = np.array([0.9999, 0.006, -0.008, 0.004, 0.03, -0.02, 0.015], np.float32)


def _scene(n=500, h=48, w=64, seed=11):
    cam = small_camera(h=h, w=w, f=60.0)
    g = random_scene(jax.random.PRNGKey(seed), n, cam, depth_range=(1.5, 5.0))
    g = g._replace(opacity=jnp.clip(g.opacity + 0.7, 0.7, 0.98),
                   scales=jnp.clip(g.scales * 2.0, 0.02, 0.2))
    tg = ActivatedGaussians(*(torch.tensor(np.asarray(x)) for x in g))
    return cam, g, tg


def _gt(g, cam):
    out = jrender(g, jnp.asarray(IDENTITY), _jrs(cam))
    color = np.asarray(out["render"])
    depth = np.asarray(out["depth"][0] / jnp.maximum(out["depth"][1], 1e-6))
    return color, depth


def test_splatam_tracking_loss_and_pose_gradient_match_jax():
    """splatam's tracking loss (masked sums of the depth and 0.5 x the rgb
    error under the silhouette, GT-depth and finite-uncertainty mask) at an
    off-pose seed, and its (q, T) gradient through kernel 3 at nc 6."""
    cam, g, tg = _scene()
    color, depth = _gt(g, cam)
    jts = JTS(rs=_jrs(cam), iters=1, method="splatam")
    jloss, jgrad = jax.value_and_grad(
        lambda p: jtracking_loss(g, p, jnp.asarray(color), jnp.asarray(depth),
                                 jnp.zeros_like(depth), jnp.asarray(JITTER), jts))(
        jnp.asarray(JITTER))

    rs = RenderSettings(cam=Camera(*cam))
    ts = TrackSettings(rs=rs, iters=1, method="splatam")
    pose = torch.as_tensor(JITTER)
    bins = build_bins(project_for_pose(tg, pose, rs), rs.cam)
    q, T = pose[:4].clone().requires_grad_(True), pose[4:].clone().requires_grad_(True)
    loss = tracking_loss_tiles(tg, q, T, to_tiles(torch.as_tensor(color), rs.cam),
                               to_tiles(torch.as_tensor(depth), rs.cam),
                               to_tiles(torch.zeros(depth.shape), rs.cam),
                               tile_pixel_valid(rs.cam), pose, ts, bins)
    gq, gT = torch.autograd.grad(loss, (q, T))
    # a sum over the masked pixels, not a mean: tens here (vigs: ~1e-1)
    assert float(loss.detach()) > 10.0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grad, jgrad = torch.cat([gq, gT]).numpy(), np.asarray(jgrad)
    np.testing.assert_allclose(grad, jgrad, rtol=POSE_RTOL,
                               atol=POSE_RTOL * 1e-2 * np.abs(jgrad).max())


def _map_pair(method, do_BA):
    """test_torch_slam._map_setup's map and two keyframes in both packages:
    (JAX carry, JAX settings, port state, port settings, colors, depths,
    poses)."""
    cam, jm, colors, depths, poses = _map_setup()
    hyper = JG.MapOptHyper.from_cfg(make_cfg(Path("."))["mapping"])
    kw = dict(iters=7, use_gt_depth=True, lambda_dssim=0.2, min_opacity=0.005,
              size_threshold=100.0, pruning_interval=10, densify_from_iter=0,
              densify_until_iter=5, rebin_every=3, method=method, do_BA=do_BA,
              cam_t_lr=0.001, cam_q_lr=0.003)
    jms = jmap_opt.MapOptSettings(rs=_jrs(cam), hyper=hyper, **kw)
    cap = jm.capacity
    jcarry = jmap_opt.MapCarry(
        m=jm, adam=JG.init_adam(jm), max_radii=jnp.zeros(cap), grad_accum=jnp.zeros(cap),
        denom=jnp.zeros(cap), ba_mask=jnp.ones(cap, bool), kf_poses=jnp.asarray(poses),
        pose_m=jnp.zeros((2, 7)), pose_v=jnp.zeros((2, 7)), pose_step=np.int32(0),
        last_loss=np.float32(0))
    tm = TG.from_numpy_params({f: np.asarray(getattr(jm, f)) for f in JG._PARAM_FIELDS}
                              | {"n_alive": 500})
    z = torch.zeros(tm.n)
    st = map_opt.MapState(tm, TG.init_adam(tm), z, z.clone(), z.clone())
    ms = map_opt.MapOptSettings(rs=RenderSettings(cam=Camera(*cam)),
                                hyper=TG.MapOptHyper(*hyper), **kw)
    return jcarry, jms, st, ms, colors, depths, poses


@pytest.mark.parametrize("method,do_BA", [("splatam", False), ("vigs", True), ("splatam", True)])
def test_map_loss_and_gradients_match_jax(method, do_BA):
    """One mapping iteration's loss, per-Gaussian gradients and (under BA)
    the keyframe pose's gradient, chained from kernel 2's dpacked through
    the projection, against JAX `_grad_and_stats`; splatam renders at nc 4
    and adds the masked mean depth error."""
    jcarry, jms, st, ms, colors, depths, poses = _map_pair(method, do_BA)
    k = 1
    jbins = jmap_opt._map_bins(jcarry, np.int32(k), jms)
    jloss, jgm, jgp, _, jga, _ = jmap_opt._grad_and_stats(
        jcarry, jbins, k, 0, jnp.asarray(colors), jnp.asarray(depths),
        jnp.zeros_like(depths), jms)
    pose = torch.as_tensor(poses[k])
    loss, gm, gp, _, ga, _ = map_opt._grad_and_stats(
        st, map_opt._map_bins(st.m, pose, ms), pose, 0, torch.as_tensor(colors[k]),
        torch.as_tensor(depths[k]), torch.zeros(depths.shape[1:]), ms)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-5)
    n = st.m.n
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
        np.testing.assert_allclose(getattr(gm, f).numpy(), np.asarray(getattr(jgm, f))[:n],
                                   **GRAD_TOL, err_msg=f)
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga)[:n], **GRAD_TOL)
    if do_BA:
        jgp = np.asarray(jgp)
        assert np.abs(jgp).max() > 1e-3
        np.testing.assert_allclose(gp.numpy(), jgp, rtol=POSE_RTOL,
                                   atol=POSE_RTOL * 1e-2 * np.abs(jgp).max())
    else:
        assert gp is None and jgp is None


@pytest.mark.parametrize("method,do_BA", [("splatam", False), ("vigs", True)])
def test_optimize_map_variants_match_jax(method, do_BA):
    """Seven iterations as test_torch_slam.test_optimize_map_matches_jax,
    with splatam's prune at iteration 0 (opacity and world size, no screen
    size) or with BA: a BA row mask and the pose Adam on both slots."""
    jcarry, jms, st, ms, colors, depths, poses = _map_pair(method, do_BA)
    schedule = np.array([0, 0, 1, 1, 1, 1, 0], np.int32)
    mask = np.random.default_rng(4).uniform(size=jcarry.m.capacity) < 0.7
    if do_BA:
        jcarry = jcarry._replace(ba_mask=jnp.asarray(mask))
        st = st._replace(ba_mask=torch.as_tensor(mask[:st.m.n]))
    jout, _ = jmap_opt.optimize_map(jcarry, jnp.asarray(colors), jnp.asarray(depths),
                                    jnp.zeros_like(depths), schedule, jnp.asarray(0.5), jms)
    st = map_opt.optimize_map(st, torch.as_tensor(colors), torch.as_tensor(depths),
                              torch.zeros(depths.shape), torch.as_tensor(poses), schedule,
                              0.5, ms)
    n = int(jout.m.n_alive)
    assert st.m.n == n < 500
    np.testing.assert_allclose(float(st.last_loss), float(jout.last_loss), rtol=1e-4)
    np.testing.assert_allclose(st.kf_poses.numpy(), np.asarray(jout.kf_poses), atol=1e-6)
    if do_BA:
        assert np.abs(st.kf_poses.numpy() - poses).max() > 1e-3
        np.testing.assert_array_equal(st.ba_mask.numpy(), np.asarray(jout.ba_mask)[:n])
    for f in ("xyz", "features_dc", "scaling", "opacity"):
        a, b = getattr(st.m, f).numpy(), np.asarray(getattr(jout.m, f))[:n]
        nu = np.asarray(getattr(jout.adam.nu, f))[:n]
        noise = nu < 1e-18   # Adam on float-noise gradients (test_torch_slam)
        err = np.abs(a - b)
        assert (err[~noise] <= 1e-5 + 1e-3 * np.abs(b[~noise])).all(), f


def test_adam_row_mask_matches_jax():
    """Rows outside the mask get a zero gradient; their moments decay and
    they keep moving by momentum (the reference's BA masking)."""
    _, jm, _, _, _ = _map_setup()
    rng = np.random.default_rng(7)
    cap = jm.capacity
    hyper = JG.MapOptHyper.from_cfg(make_cfg(Path("."))["mapping"])
    tm = TG.from_numpy_params({f: np.asarray(getattr(jm, f)) for f in JG._PARAM_FIELDS}
                              | {"n_alive": 500})
    jst, tst = JG.init_adam(jm), TG.init_adam(tm)
    for step in range(4):
        grads = {f: rng.normal(size=getattr(jm, f).shape).astype(np.float32)
                 for f in JG._PARAM_FIELDS}
        mask = rng.uniform(size=cap) < 0.5
        jm, jst = JG.adam_update(jm, JG.GaussianMap(**{f: jnp.asarray(v) for f, v in grads.items()},
                                                    n_alive=jm.n_alive),
                                 jst, hyper, row_mask=jnp.asarray(mask))
        tm, tst = TG.adam_update(tm, TG.GaussianMap(*(torch.as_tensor(grads[f][:500])
                                                      for f in TG.PARAM_FIELDS)),
                                 tst, TG.MapOptHyper(*hyper), row_mask=torch.as_tensor(mask[:500]))
    # The JAX package forms the bias correction 1 - 0.999^step in float32
    # (~1e-4 relative error at step 1), the port in float64: the parameters
    # differ by up to ~1e-4 of the four steps of lr each.
    for f in TG.PARAM_FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f))[:500],
                                   atol=1e-4 * 4 * getattr(hyper, "lr_" + f), rtol=2.5e-7,
                                   err_msg=f)
        np.testing.assert_allclose(getattr(tst.nu, f).numpy(),
                                   np.asarray(getattr(jst.nu, f))[:500], rtol=1e-5, atol=1e-12)


def test_pose_adam_matches_jax():
    """BA's pose Adam: one step counter, every slot's moments decay while
    only the sampled slot gets a gradient, every slot moves, q and T at
    their own rates, eps 1e-15."""
    rng = np.random.default_rng(3)
    K = 4
    poses = np.tile(IDENTITY, (K, 1)) + rng.normal(size=(K, 7)).astype(np.float32) * 0.01
    jms = jmap_opt.MapOptSettings(rs=None, iters=1, cam_t_lr=0.001, cam_q_lr=0.003)
    ms = map_opt.MapOptSettings(rs=None, iters=1, cam_t_lr=0.001, cam_q_lr=0.003)
    c = jmap_opt.MapCarry(m=None, adam=None, max_radii=None, grad_accum=None, denom=None,
                          ba_mask=None, kf_poses=jnp.asarray(poses),
                          pose_m=jnp.zeros((K, 7)), pose_v=jnp.zeros((K, 7)),
                          pose_step=jnp.asarray(0, jnp.int32), last_loss=None)
    pa = map_opt.PoseAdam(torch.as_tensor(poses), torch.zeros(K, 7), torch.zeros(K, 7))
    for k in [0, 2, 2, 1, 0, 3, 1, 1]:
        g = rng.normal(size=7).astype(np.float32) * 10.0 ** rng.uniform(-3, 2)
        kp, pm, pv, ps = jmap_opt._pose_adam(c, k, jnp.asarray(g), jms)
        c = c._replace(kf_poses=kp, pose_m=pm, pose_v=pv, pose_step=ps)
        pa = map_opt.pose_adam(pa, k, torch.as_tensor(g), ms)
    assert pa.step == int(c.pose_step) == 8
    np.testing.assert_allclose(pa.poses.numpy(), np.asarray(c.kf_poses), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pa.v.numpy(), np.asarray(c.pose_v), rtol=1e-5)


def test_splatam_candidates_match_jax():
    """splatam's non-presence: silhouette < 0.5, or the render behind the
    GT depth with an error above 50x its lower median."""
    cam, g, tg = _scene(n=300)
    color, depth = _gt(g, cam)
    # a few pixels far nearer than the render (splatam and vigs add them)
    # and far behind it (vigs alone)
    pick = np.random.default_rng(2).uniform(size=depth.shape)
    depth = np.where(pick < 0.05, depth * 0.3, np.where(pick > 0.95, depth * 3.0, depth))
    depth = depth.astype(np.float32)
    jstats = jmap_ops.new_gaussian_candidates(g, jnp.asarray(JITTER), jnp.asarray(color),
                                              jnp.asarray(depth), _jrs(cam), False,
                                              method="splatam")
    stats = map_ops.new_gaussian_candidates(tg, torch.as_tensor(JITTER), torch.as_tensor(color),
                                            torch.as_tensor(depth), RenderSettings(cam=Camera(*cam)),
                                            False, method="splatam")
    np.testing.assert_array_equal(stats.non_presence.numpy(), np.asarray(jstats.non_presence))
    assert 0 < stats.n_new == int(jstats.n_new) < depth.size
    vigs = map_ops.new_gaussian_candidates(tg, torch.as_tensor(JITTER), torch.as_tensor(color),
                                           torch.as_tensor(depth), RenderSettings(cam=Camera(*cam)),
                                           False)
    assert vigs.n_new > stats.n_new


def test_covisible_gaussian_mask_matches_jax():
    """Visible (radius > 0) from at least two of the window's views; the
    JAX package's padded slot (a copy of view 0) does not count."""
    cam, g, tg = _scene(n=400)
    # view 1 moved 3 forward (the map's nearer part behind it), view 2
    # facing back (none of it), the padded slot a copy of view 0
    poses = np.stack([IDENTITY, np.array([1.0, 0, 0, 0, 0, 0, -3.0], np.float32),
                      np.array([0.0, 0, 1.0, 0, 0, 0, 0], np.float32), IDENTITY])
    want = np.asarray(jmap_ops.covisible_gaussian_mask(
        g, jnp.asarray(poses), jnp.asarray([True, True, True, False]), _jrs(cam), 2))
    got = map_ops.covisible_gaussian_mask(tg, torch.as_tensor(poses[:3]),
                                          RenderSettings(cam=Camera(*cam)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def _mappers(tmp_path):
    """A JAX and a port Mapper on make_cfg's splatam config at 48x64, with
    seven keyframes around the identity pose (two of them facing away)."""
    cfg = make_cfg(tmp_path, method="splatam")
    cam = small_camera(h=48, w=64, f=60.0)
    jm = JMapper(jnormalize(cfg), _jrs(cam))
    tm = Mapper(normalize_config(cfg), RenderSettings(cam=Camera(*cam)), torch.device("cpu"))
    rng = np.random.default_rng(5)
    for i in range(7):
        pose = IDENTITY + np.concatenate([rng.normal(size=4) * 0.02,
                                          rng.normal(size=3) * 0.1]).astype(np.float32)
        if i in (2, 5):
            pose = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0], np.float32)  # facing back
        for mapper, cls in ((jm, JKeyFrame), (tm, KeyFrame)):
            mapper.keyframes.append(cls(i, None, pose, None, None))
    return jm, tm, cam


def test_splatam_window_and_keyframes_match_jax(tmp_path):
    """The window ranked by depth overlap (1600 sampled pixels, edge 20):
    the same keyframes in the same order, and the host rng left in the same
    state (the schedule drawn after it agrees); the keyframe decisions
    idx == 0 or (idx + 1) % kf_every == 0 or idx == n_img - 2."""
    jm, tm, cam = _mappers(tmp_path)
    depth = np.random.default_rng(6).uniform(1.0, 4.0, (48, 64)).astype(np.float32)
    depth[:5] = 0.0
    for idx, est in ((3, IDENTITY), (6, JITTER), (9, IDENTITY)):
        want = jm.get_covisible_set(idx, None, est, jnp.asarray(depth))
        got = tm.get_covisible_set(idx, None, est, torch.as_tensor(depth))
        assert got == want
        assert 2 not in got and 5 not in got and got[-1] == 6
        assert len(got) == tm.window_size - 1
    np.testing.assert_array_equal(tm._build_schedule(6), jm._build_schedule(6))
    for n_img in (5, 8):
        want = [jm.need_new_keyframe(i, None, None, None, None, None, n_img)
                for i in range(n_img)]
        got = [tm.need_new_keyframe(i, None, None, None, None, None, n_img)
               for i in range(n_img)]
        assert got == want
    assert [i for i in range(5) if tm.need_new_keyframe(i, None, None, None, None, None, 5)] \
        == [0, 1, 3]


def test_splatam_keyframe_with_niqe_kf_on(tmp_path):
    """splatam with mapping.niqe_kf on (as configs/synthetic_tum.yml has it):
    splatam scores no frame, so the JAX package's add_keyframe indexes an
    empty NIQE window and raises; the port keeps the current frame."""
    cfg = make_cfg(tmp_path, method="splatam")
    cfg["mapping"]["niqe_kf"] = True
    cam = small_camera(h=48, w=64, f=60.0)
    jm = JMapper(jnormalize(cfg), _jrs(cam))
    tm = Mapper(normalize_config(cfg), RenderSettings(cam=Camera(*cam)), torch.device("cpu"))
    color = np.zeros((3, 48, 64), np.float32)
    assert jm.need_new_keyframe(0, None, IDENTITY, color, None, None, 5)
    with pytest.raises(IndexError):
        jm.add_keyframe(0, IDENTITY, color, None, None, None)
    assert tm.need_new_keyframe(0, None, IDENTITY, color, None, None, 5)
    kf = tm.add_keyframe(0, IDENTITY, color, None, None, None)
    assert kf.idx == 0 and [k.idx for k in tm.keyframes] == [0]


def test_densify_matches_jax():
    """clone + split on the same statistics, with the split's normals taken
    from the JAX key so both packages place the same samples."""
    rng = np.random.default_rng(8)
    n, cap = 200, 1024
    m = JG.empty_map(cap)
    idx = np.arange(n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    m = m._replace(xyz=m.xyz.at[idx].set(rng.normal(size=(n, 3)).astype(np.float32)),
                   features_dc=m.features_dc.at[idx].set(
                       rng.normal(size=(n, 1, 3)).astype(np.float32)),
                   scaling=m.scaling.at[idx].set(
                       rng.uniform(-6, -1, (n, 3)).astype(np.float32)),
                   rotation=m.rotation.at[idx].set(q),
                   opacity=m.opacity.at[idx].set(rng.normal(size=(n, 1)).astype(np.float32)),
                   rgb=m.rgb.at[idx].set(rng.uniform(size=(n, 3)).astype(np.float32)),
                   n_alive=jnp.asarray(n, jnp.int32))
    ga = np.zeros(cap, np.float32)
    dn = np.zeros(cap, np.float32)
    ga[:n] = rng.uniform(0, 1e-3, n)
    dn[:n] = rng.integers(0, 4, n)
    key = jax.random.PRNGKey(3)
    kw = dict(max_grad=2e-4, extent=3.0, percent_dense=0.01)
    jm2, _, jn = jdensify.densify(m, JG.init_adam(m), jnp.asarray(ga), jnp.asarray(dn),
                                  kw["max_grad"], kw["extent"], kw["percent_dense"], key)
    noise = torch.as_tensor(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                                                   (cap, 3)))
                                      for i in range(2)]))
    tm = TG.from_numpy_params({f: np.asarray(getattr(m, f)) for f in JG._PARAM_FIELDS}
                              | {"n_alive": n})
    tm2, tadam, tn = tdensify.densify(tm, TG.init_adam(tm), torch.as_tensor(ga[:n]),
                                      torch.as_tensor(dn[:n]), noise=noise, **kw)
    n2 = int(jm2.n_alive)
    assert tn == int(jn) > 0 and tm2.n == n2 != n
    for f in TG.PARAM_FIELDS:
        np.testing.assert_allclose(getattr(tm2, f).numpy(), np.asarray(getattr(jm2, f))[:n2],
                                   atol=1e-6, rtol=1e-6, err_msg=f)
    assert tadam.mu.xyz.shape[0] == n2
