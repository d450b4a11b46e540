"""The port's sharded map (mm3dgs_slam_torch/parallel/) held against the JAX
package's (mm3dgs_slam_tpu/parallel/) on the CPU.

  * window bins against JAX's window bins, tile by tile (W 2, 3 and 8 over
    20 tiles: 3 and 8 leave pad tiles);
  * the plain kernels over stitched windows against the whole grid, and
    each windowed plain kernel against the JAX Pallas kernel (interpret) at
    the same tile_lo;
  * W = 2 and 3 gloo ranks (processes running tests/torch_parallel_workers.py,
    which imports no JAX): the sharded composite and its per-Gaussian
    gradients, and the sharded fused pose gradient.

The shard-local prune and append and the train step are in
test_torch_parallel_shard.py, the SLAM on two ranks in
test_torch_parallel_slam.py. Tolerances are the suite's: images atol 2e-5
rtol 1e-4, per-Gaussian gradients atol 5e-5 rtol 5e-3, kernel 3's per-tile
partials 1e-5 of each partial's sum |term| plus rtol 5e-3, dq/dT rtol 5e-4
(tests/test_pose_fused.py:71).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.ops.binning import build_bins as jbuild_bins
from mm3dgs_slam_tpu.ops.pallas_composite import (CHUNK, _composite_packed, _composite_pallas_fwd,
                                                  _composite_pose_bwd, composite_tiles_pallas,
                                                  pack_pairs)
from mm3dgs_slam_tpu.ops.projection import conic_pose_jacobian_rows as jjac_rows
from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS
from mm3dgs_slam_tpu.ops.render import effective_scales as jeffective_scales
from mm3dgs_slam_tpu.ops.render import means_cam_soa as jmeans_cam_soa
from mm3dgs_slam_tpu.ops.render import project_for_pose as jproject
from mm3dgs_slam_tpu.ops.render import render_tiles_pose as jrender_tiles_pose
from mm3dgs_slam_tpu.ops.render import tile_pixel_valid as jvalid
from mm3dgs_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from mm3dgs_slam_tpu.parallel.tile_sharded import build_window_bins_pose as jwindow_bins_pose
from mm3dgs_slam_tpu.parallel.tile_sharded import composite_tiles_sharded as jcomposite_sharded
from mm3dgs_slam_tpu.parallel.tile_sharded import render_tiles_pose_sharded as jpose_sharded

from mm3dgs_slam_torch.ops.binning import build_bins
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.composite import (composite_bwd_plain, composite_fwd_plain,
                                             composite_pose_bwd_plain)
from mm3dgs_slam_torch.ops.render import (ActivatedGaussians, RenderSettings, pack_pose_rows,
                                          project_for_pose)
from mm3dgs_slam_torch.parallel.mesh import tiles_per_shard
from mm3dgs_slam_torch.parallel.sharded import shard_rows

from torch_parallel_workers import launch
from utils import random_scene, small_camera

torch.set_num_threads(1)
POSE = np.array([1.0, 0.01, -0.02, 0.005, 0.03, -0.01, 0.02], np.float32)
POSE[:4] /= np.linalg.norm(POSE[:4])
IMG = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-5, rtol=5e-3)
PARTIAL_ATOL = 1e-5
SCENE = ("xyz", "scales", "rotations", "opacity", "shs", "alive")
needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the suite's virtual devices")


@functools.lru_cache(maxsize=None)
def _scene():
    """64x80 (4 x 5 = 20 tiles), 300 Gaussians: the JAX scene, its
    settings and projection, and the port's camera and arrays."""
    cam = small_camera(h=80, w=64, f=60.0)
    g = random_scene(jax.random.PRNGKey(2), 300, cam)
    jrs = JRS(cam=cam, use_pallas=True, bin_d1=8, bin_big_frac=4, max_tiles_per_gaussian=32)
    arrays = {f: np.asarray(getattr(g, f)) for f in SCENE}
    return cam, g, jrs, arrays, RenderSettings(cam=Camera(*cam))


def _tg(arrays):
    return ActivatedGaussians(*(torch.as_tensor(arrays[f]).clone() for f in SCENE))


def _jbins(jp, cam, lo=None, n_local=None, **kw):
    return jbuild_bins(jp, cam, 0, 32, align=CHUNK, d1=8, big_frac=4, tile_lo=lo,
                       n_local=n_local, **kw)


def _valid_lists(b):
    pg, ok = np.asarray(b.pair_gauss), np.asarray(b.pair_valid)
    return [pg[s:s + c][ok[s:s + c]].tolist()
            for s, c in zip(np.asarray(b.tile_start), np.asarray(b.tile_count))]


@pytest.mark.parametrize("world", [2, 3, 8])
def test_window_bins_match_jax(world):
    cam, g, jrs, arrays, rs = _scene()
    jp = jproject(g, jnp.asarray(POSE), jrs)
    with torch.no_grad():
        tp = project_for_pose(_tg(arrays), torch.as_tensor(POSE), rs)
    tpb = tiles_per_shard(rs.cam, world)
    assert tpb == -(-cam.n_tiles // world)
    whole = build_bins(tp, rs.cam)
    for r in range(world):
        lo = r * tpb
        jb = _jbins(jp, cam, jnp.int32(lo), tpb)
        assert not bool(jb.overflow)
        tb = build_bins(tp, rs.cam, lo, tpb)
        got = [tb.pair_gauss[s:s + c].tolist() for s, c in zip(tb.tile_start.tolist(),
                                                                 tb.tile_count.tolist())]
        assert got == _valid_lists(jb), f"window {r}"
        assert all(not ids for ids in got[max(cam.n_tiles - lo, 0):])   # the pad is empty
        for t, ids in enumerate(got[:max(cam.n_tiles - lo, 0)]):        # the whole grid's lists
            s, c = int(whole.tile_start[lo + t]), int(whole.tile_count[lo + t])
            assert ids == whole.pair_gauss[s:s + c].tolist()


def _window_inputs(nc, seed):
    """The port's rows (packed32) at POSE, its whole-grid bins, and random
    cotangents for the whole grid."""
    cam, g, jrs, arrays, rs = _scene()
    tg = _tg(arrays)
    q, T = torch.as_tensor(POSE[:4]), torch.as_tensor(POSE[4:])
    packed32 = pack_pose_rows(tg, q, T, rs)
    with torch.no_grad():
        proj = project_for_pose(tg, torch.as_tensor(POSE), rs)
    rng = np.random.default_rng(seed)
    dacc = torch.as_tensor(rng.normal(size=(cam.n_tiles, nc, 256)).astype(np.float32))
    dtfin = torch.as_tensor(rng.normal(size=(cam.n_tiles, 1, 256)).astype(np.float32))
    return rs, proj, packed32, dacc, dtfin


def _pad(x, n):
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


@pytest.mark.parametrize("world", [2, 3])
def test_stitched_windows_equal_whole_grid(world):
    """Each plain kernel over W windows stitched together against the whole
    grid: the forward and kernel 3's per-tile partials bit-equal, kernel
    2's dpacked summed over the windows within the gradient tolerance; the
    pad tiles give acc 0, T 1 and zero partials."""
    nc = 5
    rs, proj, packed32, dacc, dtfin = _window_inputs(nc, world)
    cam = rs.cam
    whole = build_bins(proj, cam)
    args = (whole.pair_gauss, whole.tile_start, whole.tile_count)
    acc, tfin = composite_fwd_plain(packed32, *args, cam, nc)
    dpacked = composite_bwd_plain(packed32[:, :16].contiguous(), *args, acc[:, :3], tfin,
                                  dacc[:, :3].contiguous(), dtfin, cam, 3)
    psum = composite_pose_bwd_plain(packed32, *args, acc, tfin, dacc, dtfin, cam, nc)
    tpb = tiles_per_shard(cam, world)
    n_pad = world * tpb
    acc_p, tfin_p = _pad(acc, n_pad), _pad(tfin, n_pad)
    dacc_p, dtfin_p = _pad(dacc, n_pad), _pad(dtfin, n_pad)
    accs, tfins, psums, dsum = [], [], [], torch.zeros_like(dpacked)
    for r in range(world):
        lo, sl = r * tpb, slice(r * tpb, (r + 1) * tpb)
        wb = build_bins(proj, cam, lo, tpb)
        wargs = (wb.pair_gauss, wb.tile_start, wb.tile_count)
        win = dict(tile_lo=lo, n_local=tpb)
        a, t = composite_fwd_plain(packed32, *wargs, cam, nc, **win)
        accs.append(a)
        tfins.append(t)
        dsum += composite_bwd_plain(packed32[:, :16].contiguous(), *wargs, acc_p[sl, :3], tfin_p[sl],
                                    dacc_p[sl, :3].contiguous(), dtfin_p[sl], cam, 3, **win)
        psums.append(composite_pose_bwd_plain(packed32, *wargs, acc_p[sl], tfin_p[sl],
                                              dacc_p[sl], dtfin_p[sl], cam, nc, **win))
    acc_s, tfin_s, psum_s = torch.cat(accs), torch.cat(tfins), torch.cat(psums)
    assert torch.equal(acc_s[:cam.n_tiles], acc) and torch.equal(tfin_s[:cam.n_tiles], tfin)
    assert torch.equal(psum_s[:cam.n_tiles], psum)
    if n_pad > cam.n_tiles:
        assert float(acc_s[cam.n_tiles:].abs().max()) == 0.0
        assert bool((tfin_s[cam.n_tiles:] == 1.0).all())
        assert float(psum_s[cam.n_tiles:].abs().max()) == 0.0
    torch.testing.assert_close(dsum, dpacked, **GRAD)
    assert float(dpacked.abs().max()) > 1e-3


def _jax_pose_rows(g, jrs):
    """JAX's packed32 rows at POSE (render.py `_pose_fwd_impl`'s)."""
    pose = jnp.asarray(POSE)
    scales = jeffective_scales(g.scales, jrs)
    means_cam = jmeans_cam_soa(g.xyz, pose)
    proj = jproject(g, pose, jrs)
    return jnp.concatenate([proj.packed, jjac_rows(means_cam, scales, g.rotations, g.xyz,
                                                   jrs.cam)], axis=-1), proj


@needs_mesh
@pytest.mark.parametrize("kernel", ["fwd", "bwd", "pose_bwd"])
def test_windowed_plain_kernels_match_pallas(kernel):
    """Each windowed plain kernel against the JAX Pallas kernel (interpret)
    over the same window, for every window of W = 3 (the last one padded),
    on JAX's own rows."""
    cam, g, jrs, arrays, rs = _scene()
    world, nc = 3, (3 if kernel == "bwd" else 5)
    tpb = tiles_per_shard(rs.cam, world)
    jpacked32, jp = _jax_pose_rows(g, jrs)
    packed32 = torch.as_tensor(np.asarray(jpacked32)).clone()
    with torch.no_grad():
        tp = project_for_pose(_tg(arrays), torch.as_tensor(POSE), rs)
    rng = np.random.default_rng(7)
    for r in range(world):
        lo = r * tpb
        jb = _jbins(jp, cam, jnp.int32(lo), tpb, reverse_tables=(kernel == "bwd"))
        wb = build_bins(tp, rs.cam, lo, tpb)
        win = dict(tile_lo=lo, n_local=tpb)
        wargs = (wb.pair_gauss, wb.tile_start, wb.tile_count)
        dacc = rng.normal(size=(tpb, nc, 256)).astype(np.float32)
        dtfin = rng.normal(size=(tpb, 1, 256)).astype(np.float32)
        if kernel == "fwd":
            ja, jt = _composite_pallas_fwd(pack_pairs(jpacked32, jb.pair_gauss), jb.tile_start,
                                           jb.tile_count, cam, True, jnp.int32(lo), tpb, True, nc)
            a, t = composite_fwd_plain(packed32, *wargs, rs.cam, nc, **win)
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), **IMG)
            np.testing.assert_allclose(t.numpy(), np.asarray(jt), **IMG)
        elif kernel == "bwd":
            jpacked = jpacked32[:, :16]

            def loss(p):
                acc, tfin = _composite_packed(
                    p, jb.pair_gauss, jb.pair_valid, jb.small_slots, jb.big_slots, jb.big_gauss,
                    jb.big_valid, jb.gauss_rank, jb.tile_start, jb.tile_count, cam, True, False,
                    jnp.int32(lo), tpb, True, nc)
                return jnp.sum(acc * dacc) + jnp.sum(tfin * dtfin)

            jgrad = np.asarray(jax.grad(loss)(jpacked))
            packed = packed32[:, :16].contiguous()
            a, t = composite_fwd_plain(packed, *wargs, rs.cam, nc, **win)
            d = composite_bwd_plain(packed, *wargs, a, t, torch.as_tensor(dacc),
                                    torch.as_tensor(dtfin), rs.cam, nc, **win)
            live = np.asarray(jp.radius) > 0
            np.testing.assert_allclose(d.numpy()[live], jgrad[live], **GRAD)
        else:
            pair_rows = pack_pairs(jpacked32, jb.pair_gauss)
            ja, jt = _composite_pallas_fwd(pair_rows, jb.tile_start, jb.tile_count, cam, True,
                                           jnp.int32(lo), tpb, True, nc)
            jps = np.asarray(_composite_pose_bwd(
                pair_rows, jb.tile_start, jb.tile_count, ja, jt, jnp.asarray(dacc),
                jnp.asarray(dtfin), cam, True, True, nc, jnp.int32(lo), tpb)).sum(2)[:, :12]
            a, t = composite_fwd_plain(packed32, *wargs, rs.cam, nc, **win)
            ps, asum = composite_pose_bwd_plain(packed32, *wargs, a, t, torch.as_tensor(dacc),
                                                torch.as_tensor(dtfin), rs.cam, nc,
                                                abs_sum=True, **win)
            tol = PARTIAL_ATOL * asum.numpy() + GRAD["rtol"] * np.abs(jps)
            assert (np.abs(ps.numpy() - jps) <= tol).all(), f"window {r}"


# -- several ranks: each a process running tests/torch_parallel_workers.py --

def _scene_inputs(**extra):
    cam, g, jrs, arrays, rs = _scene()
    return dict(arrays, cam=np.asarray(list(cam[:6]), np.float64), **extra)


@needs_mesh
@pytest.mark.parametrize("world", [2, 3])
def test_sharded_composite_matches_jax(world, tmp_path):
    """The image and per-Gaussian gradients of the suite's gradient loss,
    mean((image - gt)^2) (tests/test_rasterizer.py), on W ranks with the
    bins built inline and cached, against JAX's single-device Pallas
    composite and its tile-sharded composite on a W-device mesh."""
    cam, g, jrs, arrays, rs = _scene()
    gt = np.random.default_rng(3).uniform(size=(6, cam.height, cam.width)).astype(np.float32)
    jp = jproject(g, jnp.asarray(POSE), jrs)
    bg = jnp.zeros((6,), jnp.float32)

    def rebuild(packed):
        return jp._replace(xy=packed[:, 0:2], conic=packed[:, 2:5], opacity=packed[:, 5],
                           feat=packed[:, 6:12], packed=packed)

    def jloss_single(packed):
        p = rebuild(packed)
        return jnp.mean((composite_tiles_pallas(p, _jbins(p, cam), cam, bg, interpret=True)
                         - gt) ** 2)

    def jloss_sharded(packed):
        return jnp.mean((jcomposite_sharded(rebuild(packed), cam, bg, jmake_mesh(world), jrs,
                                            interpret=True) - gt) ** 2)

    img1 = np.asarray(composite_tiles_pallas(jp, _jbins(jp, cam), cam, bg, interpret=True))
    imgw = np.asarray(jcomposite_sharded(jp, cam, bg, jmake_mesh(world), jrs, interpret=True))
    g1 = np.asarray(jax.grad(jloss_single)(jp.packed))
    gw = np.asarray(jax.grad(jloss_sharded)(jp.packed))
    outs = launch("composite", world, tmp_path,
                   _scene_inputs(pose=POSE, gt=gt))
    live = np.asarray(jp.radius) > 0
    assert live.sum() > 100
    for tag in ("", "_cached"):
        for o in outs[1:]:   # every rank assembles the same image
            assert np.array_equal(o[f"image{tag}"], outs[0][f"image{tag}"])
        img = outs[0][f"image{tag}"]
        np.testing.assert_allclose(img, img1, **IMG)
        np.testing.assert_allclose(img, imgw, **IMG)
        d = np.concatenate([o[f"dpacked{tag}"] for o in outs])
        assert [o[f"dpacked{tag}"].shape[0] for o in outs] == [k for _, k in
                                                                shard_rows(300, world)]
        np.testing.assert_allclose(d[live], g1[live], **GRAD)
        np.testing.assert_allclose(d[live], gw[live], **GRAD)
        assert np.abs(g1[live]).max() > 1e-4


@needs_mesh
@pytest.mark.parametrize("world", [2, 3])
def test_sharded_pose_gradient_matches_jax(world, tmp_path):
    """dq, dT of loss = sum(wgrid * out) through render_tiles_pose_sharded
    (kernels 1 and 3 per window, the 12 sums added over the ranks) against
    JAX's single-device fused path and its tile-sharded one on a W-device
    mesh; the render itself against JAX's."""
    cam, g, jrs, arrays, rs = _scene()
    nc = 5
    q0, T0 = jnp.asarray(POSE[:4]), jnp.asarray(POSE[4:])
    valid = np.asarray(jvalid(cam))
    wgrid = (np.random.default_rng(5).normal(size=(cam.n_tiles, nc, 256))
             * valid[:, None, :]).astype(np.float32)
    jp = jproject(g, jnp.asarray(POSE), jrs)
    bins1 = _jbins(jp, cam, reverse_tables=False)
    mesh = jmake_mesh(world)
    binsw = jwindow_bins_pose(jp, cam, mesh, jrs)

    def loss1(q, T):
        return jnp.sum(jrender_tiles_pose(g, q, T, jrs, bins1, nc=nc, interpret=True) * wgrid)

    def lossw(q, T):
        return jnp.sum(jpose_sharded(g, q, T, jrs, binsw, mesh, nc=nc, interpret=True) * wgrid)

    out1 = np.asarray(jrender_tiles_pose(g, q0, T0, jrs, bins1, nc=nc, interpret=True))
    grads1 = jax.grad(loss1, argnums=(0, 1))(q0, T0)
    gradsw = jax.grad(lossw, argnums=(0, 1))(q0, T0)
    outs = launch("pose", world, tmp_path,
                   _scene_inputs(q=POSE[:4], T=POSE[4:], wgrid=wgrid, nc=np.asarray(nc)))
    for o in outs[1:]:   # the same gradient bits on every rank
        assert np.array_equal(o["dq"], outs[0]["dq"]) and np.array_equal(o["dT"], outs[0]["dT"])
    np.testing.assert_allclose(outs[0]["out"], out1, **IMG)
    for ref in (grads1, gradsw):
        for got, want in ((outs[0]["dq"], ref[0]), (outs[0]["dT"], ref[1])):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-4 * np.abs(want).max())
