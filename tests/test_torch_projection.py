"""mm3dgs_slam_torch projection, oracle and binning held against the JAX
package on the CPU, on the same random scenes (tests/utils.random_scene,
converted to numpy), and kernel 4's plain version (the tracking rows) on
the edge rows of tests/torch_scenes.py's `pose_edge_scene`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.ops.binning import build_bins as jbuild_bins
from mm3dgs_slam_tpu.ops.camera import Camera as JCamera
from mm3dgs_slam_tpu.ops.oracle import composite_oracle as joracle
from mm3dgs_slam_tpu.ops.projection import conic_pose_jacobian_rows as jjac
from mm3dgs_slam_tpu.ops.render import ActivatedGaussians as JActivated
from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS
from mm3dgs_slam_tpu.ops.render import background as jbackground
from mm3dgs_slam_tpu.ops.render import effective_scales as jeffective_scales
from mm3dgs_slam_tpu.ops.render import means_cam_soa as jmeans_cam_soa
from mm3dgs_slam_tpu.ops.render import project_for_pose as jproject

from mm3dgs_slam_torch.ops import kernels
from mm3dgs_slam_torch.ops.binning import build_bins
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.oracle import composite_oracle
from mm3dgs_slam_torch.ops.projection import conic_pose_jacobian_rows, project_gaussians
from mm3dgs_slam_torch.ops.render import (ActivatedGaussians, RenderSettings, background,
                                          effective_scales, means_cam_soa, pack_pose_rows,
                                          project_for_pose)

from torch_scenes import pose_edge_scene
from utils import random_scene, small_camera

torch.set_num_threads(1)
POSE = np.array([0.999, 0.02, -0.01, 0.005, 0.01, -0.02, 0.03], np.float32)
IMG = dict(atol=2e-5, rtol=1e-4)


def to_torch(g, requires_grad=False):
    return ActivatedGaussians(*(torch.as_tensor(np.asarray(x)).clone().requires_grad_(
        requires_grad and np.asarray(x).dtype == np.float32) for x in g))


def tcam(cam):
    return Camera(*cam)


@pytest.mark.parametrize("iso", [False, True])
def test_projection_fields_and_grads_match_jax(iso):
    cam = small_camera()
    g = random_scene(jax.random.PRNGKey(1), 200, cam, n_dead=25)
    jrs = JRS(cam=cam, force_isotropic=iso)
    rs = RenderSettings(cam=tcam(cam), force_isotropic=iso)
    jp = jproject(g, jnp.asarray(POSE), jrs)
    tg = to_torch(g, requires_grad=True)
    pose = torch.as_tensor(POSE).requires_grad_(True)
    tp = project_for_pose(tg, pose, rs)
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    live = np.asarray(jp.radius) > 0
    np.testing.assert_allclose(tp.packed.detach().numpy()[live], np.asarray(jp.packed)[live],
                               rtol=1e-5, atol=1e-4)

    w = np.random.default_rng(2).normal(size=(200, 16)).astype(np.float32) * live[:, None]

    def jloss(xyz, scales, rotations, opacity, shs, pose7):
        p = jproject(g._replace(xyz=xyz, scales=scales, rotations=rotations, opacity=opacity,
                                shs=shs), pose7, jrs)
        return jnp.sum(p.packed * w)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(g.xyz, g.scales, g.rotations, g.opacity,
                                                     g.shs, jnp.asarray(POSE))
    torch.sum(tp.packed * torch.as_tensor(w)).backward()
    tgrads = [tg.xyz.grad, tg.scales.grad, tg.rotations.grad, tg.opacity.grad, tg.shs.grad,
              pose.grad]
    for a, b, name in zip(tgrads, jgrads, ["xyz", "scales", "rot", "op", "shs", "pose"]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=5e-5 * max(np.abs(b).max(), 1), rtol=5e-3,
                                   err_msg=name)


def test_conic_pose_jacobian_rows_match_jax():
    cam = small_camera()
    g = random_scene(jax.random.PRNGKey(4), 150, cam)
    mc = np.asarray(g.xyz) + np.array([0.01, -0.02, 0.05], np.float32)
    j = jjac(jnp.asarray(mc), g.scales, g.rotations, g.xyz, cam)
    tj = conic_pose_jacobian_rows(torch.as_tensor(mc), torch.as_tensor(np.asarray(g.scales)),
                                  torch.as_tensor(np.asarray(g.rotations)),
                                  torch.as_tensor(np.asarray(g.xyz)), tcam(cam))
    j = np.asarray(j)
    np.testing.assert_allclose(tj.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


@pytest.mark.parametrize("iso", [False, True])
def test_pose_rows_cpu_path_is_the_plain_chain_and_matches_jax(iso):
    """`kernels.pose_rows` on the CPU (kernel 4's plain version) on edge rows
    (behind z = 0.2, past both clamp limits, dead rows): no launch counted,
    `pack_pose_rows`'s rows, bit for bit the chain `pack_pose_rows` ran
    before kernel 4 (means_cam_soa, effective_scales, project_gaussians at
    w2c = I, conic_pose_jacobian_rows), and the JAX package's packed rows
    and conic_pose_jacobian_rows within test_conic_pose_jacobian_rows_match_jax's
    tolerances."""
    g, cam = pose_edge_scene("cpu", n=600)
    rs = RenderSettings(cam=cam, force_isotropic=iso)
    q, T = torch.as_tensor(POSE[:4]), torch.as_tensor(POSE[4:])
    before = kernels.launch_counts()
    rows = kernels.pose_rows(g, q, T, cam, iso)
    assert kernels.launch_counts() == before
    assert torch.equal(rows, pack_pose_rows(g, q, T, rs))
    means_cam = means_cam_soa(g.xyz, torch.cat([q, T]))
    scales = effective_scales(g.scales, rs)
    proj = project_gaussians(means_cam, scales, g.rotations, g.opacity, g.shs, g.alive,
                             torch.eye(4), cam, 0, torch.zeros(3))
    jac = conic_pose_jacobian_rows(means_cam, scales, g.rotations, g.xyz, cam)
    assert torch.equal(rows, torch.cat([proj.packed, jac], 1))

    mz = means_cam[:, 2]
    ux, uy = means_cam[:, 0] / mz, means_cam[:, 1] / mz
    assert bool((mz <= 0.2).any()) and bool((~g.alive).any())
    for u, lim in ((ux, cam.tanfovx), (uy, cam.tanfovy)):
        out = (mz > 0.2) & (u.abs() > 1.3 * lim)
        assert bool((out & (u > 0)).any()) and bool((out & (u < 0)).any())
    jcam = JCamera(*cam)
    jg = JActivated(*(jnp.asarray(t.numpy()) for t in g))
    jrs = JRS(cam=jcam, force_isotropic=iso)
    jp = jproject(jg, jnp.asarray(POSE), jrs)
    np.testing.assert_allclose(rows[:, :16].numpy(), np.asarray(jp.packed), rtol=1e-5, atol=1e-4)
    jj = np.asarray(jjac(jmeans_cam_soa(jg.xyz, jnp.asarray(POSE)),
                         jeffective_scales(jg.scales, jrs), jg.rotations, jg.xyz, jcam))
    np.testing.assert_allclose(rows[:, 16:].numpy(), jj, rtol=1e-4, atol=1e-4 * np.abs(jj).max())


@pytest.mark.parametrize("white", [False, True])
def test_oracle_matches_jax_oracle(white):
    cam = small_camera()
    g = random_scene(jax.random.PRNGKey(3), 250, cam, n_dead=20)
    jrs = JRS(cam=cam, white_background=white)
    rs = RenderSettings(cam=tcam(cam), white_background=white)
    ref = joracle(jproject(g, jnp.asarray(POSE), jrs), cam, jbackground(jrs))
    with torch.no_grad():
        out = composite_oracle(project_for_pose(to_torch(g), torch.as_tensor(POSE), rs),
                               rs.cam, background(rs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **IMG)


def _per_tile_lists(pair_gauss, starts, counts):
    pg = np.asarray(pair_gauss)
    return [pg[s:s + c].tolist() for s, c in zip(np.asarray(starts), np.asarray(counts))]


@pytest.mark.parametrize("seed,hw", [(0, (64, 80)), (1, (52, 70))])
def test_binning_lists_equal_jax(seed, hw):
    cam = small_camera(h=hw[0], w=hw[1])
    g = random_scene(jax.random.PRNGKey(seed), 400, cam, n_dead=40)
    jp = jproject(g, jnp.asarray(POSE), JRS(cam=cam))
    jb = jbuild_bins(jp, cam, 1 << 16, 128)
    assert not bool(jb.overflow)
    with torch.no_grad():
        tb = build_bins(project_for_pose(to_torch(g), torch.as_tensor(POSE),
                                         RenderSettings(cam=tcam(cam))), tcam(cam))
    want = _per_tile_lists(jb.pair_gauss, jb.tile_start, jb.tile_count)
    got = _per_tile_lists(tb.pair_gauss, tb.tile_start, tb.tile_count)
    assert got == want
    assert tb.pair_gauss.shape[0] == int(jb.n_pairs)
