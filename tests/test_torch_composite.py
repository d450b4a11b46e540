"""The plain PyTorch versions of the three compositing kernels (what the
CUDA kernels are held to on the card) held against the JAX package on the
CPU: the forward against the JAX oracle and the Pallas kernel in interpret
mode, the mapping backward against `_composite_packed`'s gradients, the pose
backward against `render_tiles_pose` over the cases of
tests/test_pose_fused.py, and the port's `render` against JAX `render`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.ops.binning import build_bins as jbuild_bins
from mm3dgs_slam_tpu.ops.oracle import composite_oracle as joracle
from mm3dgs_slam_tpu.ops.pallas_composite import CHUNK, _composite_packed, composite_tiles_pallas
from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS
from mm3dgs_slam_tpu.ops.render import background as jbackground
from mm3dgs_slam_tpu.ops.render import project_for_pose as jproject
from mm3dgs_slam_tpu.ops.render import render as jrender
from mm3dgs_slam_tpu.ops.render import render_tiles_pose as jrender_tiles_pose
from mm3dgs_slam_tpu.ops.render import tile_pixel_valid as jvalid
from mm3dgs_slam_tpu.ops.render import to_tiles as jto_tiles

from mm3dgs_slam_torch.ops import kernels
from mm3dgs_slam_torch.ops.binning import build_bins
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.composite import (composite_bwd_plain, composite_fwd_plain,
                                             composite_pose_bwd_plain)
from mm3dgs_slam_torch.ops.projection import conic_pose_jacobian_rows
from mm3dgs_slam_torch.ops.render import (ActivatedGaussians, RenderSettings, from_tiles,
                                          means_cam_soa, project_for_pose, render,
                                          render_tiles_pose, to_tiles)

from utils import random_scene, small_camera

torch.set_num_threads(1)
IDENTITY = np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)
POSE = np.array([0.999, 0.02, -0.01, 0.005, 0.01, -0.02, 0.03], np.float32)
IMG = dict(atol=2e-5, rtol=1e-4)


def to_torch(g):
    return ActivatedGaussians(*(torch.as_tensor(np.asarray(x)).clone() for x in g))


@functools.lru_cache(maxsize=None)
def _fwd_scene(white: bool):
    """JAX references for one scene: the oracle image and the Pallas
    (interpret) image, plus the port's projection and bins."""
    cam = small_camera()
    g = random_scene(jax.random.PRNGKey(0), 300, cam, n_dead=30)
    jrs = JRS(cam=cam, white_background=white)
    jp = jproject(g, jnp.asarray(IDENTITY), jrs)
    bg = jbackground(jrs)
    oracle = np.asarray(joracle(jp, cam, bg))
    pallas = np.asarray(composite_tiles_pallas(
        jp, jbuild_bins(jp, cam, 1 << 15, 256, align=CHUNK), cam, bg, interpret=True))
    rs = RenderSettings(cam=Camera(*cam), white_background=white)
    with torch.no_grad():
        tp = project_for_pose(to_torch(g), torch.as_tensor(IDENTITY), rs)
        bins = build_bins(tp, rs.cam)
    return rs, tp, bins, oracle, pallas


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("nc", [3, 5, 6])
def test_plain_forward_matches_oracle_and_pallas(nc, white):
    rs, tp, bins, oracle, pallas = _fwd_scene(white)
    acc, tfin = composite_fwd_plain(tp.packed, bins.pair_gauss, bins.tile_start,
                                    bins.tile_count, rs.cam, nc)
    bgv = 1.0 if white else 0.0
    img = from_tiles(acc + tfin * bgv, rs.cam).numpy()
    np.testing.assert_allclose(img, oracle[:nc], **IMG)
    np.testing.assert_allclose(img, pallas[:nc], **IMG)
    # the wrapper takes the plain version for CPU tensors, without counting
    before = kernels.launch_counts()
    acc2, _ = kernels.composite_fwd(tp.packed, bins.pair_gauss, bins.tile_start,
                                    bins.tile_count, rs.cam, nc)
    assert torch.equal(acc, acc2) and kernels.launch_counts() == before


@pytest.mark.parametrize("nc", [3, 6])
def test_plain_mapping_backward_matches_pallas_grads(nc):
    cam = small_camera()
    g = random_scene(jax.random.PRNGKey(3), 150, cam, n_dead=10)
    jp = jproject(g, jnp.asarray(IDENTITY), JRS(cam=cam))
    jb = jbuild_bins(jp, cam, 1 << 15, 256, align=CHUNK)
    rng = np.random.default_rng(9)
    gt = rng.uniform(size=(cam.n_tiles, nc, 256)).astype(np.float32)
    gt_t = rng.uniform(size=(cam.n_tiles, 1, 256)).astype(np.float32)

    def loss(packed):
        acc, tfin = _composite_packed(
            packed, jb.pair_gauss, jb.pair_valid, jb.small_slots, jb.big_slots, jb.big_gauss,
            jb.big_valid, jb.gauss_rank, jb.tile_start, jb.tile_count, cam, True, False, None,
            None, True, nc)
        return jnp.mean((acc - gt) ** 2) + jnp.mean((tfin - gt_t) ** 2)

    jgrad = np.asarray(jax.grad(loss)(jp.packed))
    packed = torch.as_tensor(np.asarray(jp.packed)).clone()
    bins = build_bins(project_for_pose(to_torch(g), torch.as_tensor(IDENTITY),
                                       RenderSettings(cam=Camera(*cam))), Camera(*cam))
    acc, tfin = composite_fwd_plain(packed, bins.pair_gauss, bins.tile_start, bins.tile_count,
                                    Camera(*cam), nc)
    dacc = 2.0 * (acc - torch.as_tensor(gt)) / acc.numel()
    dtfin = 2.0 * (tfin - torch.as_tensor(gt_t)) / tfin.numel()
    dpacked = composite_bwd_plain(packed, bins.pair_gauss, bins.tile_start, bins.tile_count,
                                  acc, tfin, dacc, dtfin, Camera(*cam), nc)
    live = np.asarray(jp.radius) > 0
    np.testing.assert_allclose(dpacked.numpy()[live], jgrad[live], atol=5e-5, rtol=5e-3)
    assert np.abs(jgrad[live][:, :6 + nc]).max() > 1e-4
    assert float(dpacked[:, 6 + nc:].abs().max()) == 0.0


def _pose_setup(white, iso):
    cam = small_camera(h=64, w=80, f=70.0)
    g = random_scene(jax.random.PRNGKey(5), 900, cam)
    jrs = JRS(cam=cam, pair_cap=1 << 16, max_per_tile=512, chunk=16, max_tiles_per_gaussian=128,
              white_background=white, force_isotropic=iso, bin_d1=4, bin_big_frac=4,
              bin_d2_live=8)
    jb = jbuild_bins(jproject(g, jnp.asarray(POSE), jrs), cam, jrs.pair_cap,
                     jrs.max_tiles_per_gaussian, align=CHUNK, d1=jrs.bin_d1,
                     big_frac=jrs.bin_big_frac, d2_live=jrs.bin_d2_live)
    assert not bool(jb.overflow)
    rs = RenderSettings(cam=Camera(*cam), white_background=white, force_isotropic=iso)
    return cam, g, jrs, jb, rs


@pytest.mark.parametrize("nc", [5, 6])
@pytest.mark.parametrize("white,iso", [(False, False), (True, False), (False, True)])
def test_plain_pose_backward_matches_fused_pallas(nc, white, iso):
    cam, g, jrs, jb, rs = _pose_setup(white, iso)
    valid = jvalid(cam)
    wgrid = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (cam.n_tiles, nc, 256))
                       * valid[:, None, :])

    def jloss(q, T):
        return jnp.sum(jrender_tiles_pose(g, q, T, jrs, jb, nc=nc, interpret=True) * wgrid)

    lj, (gq_j, gt_j) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(POSE[:4]),
                                                                 jnp.asarray(POSE[4:]))
    tg = to_torch(g)
    q = torch.as_tensor(POSE[:4]).clone().requires_grad_(True)
    T = torch.as_tensor(POSE[4:]).clone().requires_grad_(True)
    with torch.no_grad():
        bins = build_bins(project_for_pose(tg, torch.cat([q, T]), rs), rs.cam)
    lt = torch.sum(render_tiles_pose(tg, q, T, rs, bins, nc=nc) * torch.as_tensor(wgrid))
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5)
    for a, b, name in ((q.grad, gq_j, "dq"), (T.grad, gt_j, "dT")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-4, atol=5e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_fused_pose_grads_match_general_autograd():
    """Kernel 3's plain version == autograd through projection + kernel 2's
    plain version (the port's own general path)."""
    cam, g, jrs, jb, rs = _pose_setup(False, False)
    tg = to_torch(g)
    wgrid = torch.randn((cam.n_tiles, 6, 256), generator=torch.Generator().manual_seed(1))
    wgrid = wgrid * to_tiles(torch.ones(cam.height, cam.width), rs.cam)[:, None, :]
    grads = []
    for fused in (True, False):
        q = torch.as_tensor(POSE[:4]).clone().requires_grad_(True)
        T = torch.as_tensor(POSE[4:]).clone().requires_grad_(True)
        pose = torch.cat([q, T])
        with torch.no_grad():
            bins = build_bins(project_for_pose(tg, pose, rs), rs.cam)
        if fused:
            out = render_tiles_pose(tg, q, T, rs, bins, nc=6)
        else:
            o = render(tg, pose, rs, bins=bins)
            out = to_tiles(torch.cat([o["render"], o["depth"]]), rs.cam)
        torch.sum(out * wgrid).backward()
        grads.append((q.grad.numpy(), T.grad.numpy()))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4 * np.abs(b).max())


@pytest.mark.parametrize("transform_means", [True, False])
def test_render_matches_jax_render(transform_means):
    cam = small_camera()
    g = random_scene(jax.random.PRNGKey(8), 300, cam, n_dead=20)
    jrs = JRS(cam=cam, pair_cap=1 << 15, max_per_tile=512, chunk=16, max_tiles_per_gaussian=256,
              transform_means_python=transform_means)
    out_j = jrender(g, jnp.asarray(POSE), jrs)
    rs = RenderSettings(cam=Camera(*cam), transform_means_python=transform_means)
    with torch.no_grad():
        out_t = render(to_torch(g), torch.as_tensor(POSE), rs)
    for k in ("render", "depth"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), **IMG)
    np.testing.assert_array_equal(out_t["radii"].numpy(), np.asarray(out_j["radii"]))
    np.testing.assert_allclose(to_tiles(out_t["render"], rs.cam).numpy(),
                               np.asarray(jto_tiles(out_j["render"], cam)), **IMG)


def test_pose_partials_abs_sum():
    """`abs_sum` leaves the partials as they are and bounds each by the sum
    of its terms' magnitudes, which cancellation leaves far larger."""
    cam, g, jrs, jb, rs = _pose_setup(False, False)
    tg, pose = to_torch(g), torch.as_tensor(POSE)
    with torch.no_grad():
        bins = build_bins(project_for_pose(tg, pose, rs), rs.cam)
        packed32 = torch.cat([project_for_pose(tg, pose, rs).packed, conic_pose_jacobian_rows(
            means_cam_soa(tg.xyz, pose), tg.scales, tg.rotations, tg.xyz, rs.cam)], 1)
    b = (bins.pair_gauss, bins.tile_start, bins.tile_count)
    acc, tfin = composite_fwd_plain(packed32, *b, rs.cam, 5)
    gen = torch.Generator().manual_seed(4)
    a = (packed32, *b, acc, tfin, torch.randn(acc.shape, generator=gen),
         torch.randn(tfin.shape, generator=gen), rs.cam, 5)
    psum = composite_pose_bwd_plain(*a)
    psum2, asum = composite_pose_bwd_plain(*a, abs_sum=True)
    assert torch.equal(psum, psum2)
    assert bool((asum >= psum.abs() * (1 - 1e-6)).all())
    assert bool((asum > 10 * psum.abs()).any())

