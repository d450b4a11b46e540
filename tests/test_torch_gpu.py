"""The three CUDA kernels against their plain PyTorch versions on the card,
on a projected 3D scene and on the hard screen-space scenes of
test_torch_cull.py (long anisotropic splats, saturating layers).

Marked `gpu`; each test decides inside itself whether a card is present and
skips without one (collection is the same on every xdist worker). Run on a
machine with a card (which has no JAX, hence --noconftest):
    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest"""
import numpy as np
import pytest
import torch

from mm3dgs_slam_torch.ops import composite as plain
from mm3dgs_slam_torch.ops import kernels
from mm3dgs_slam_torch.ops.binning import build_bins
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.projection import conic_pose_jacobian_rows
from mm3dgs_slam_torch.ops.render import (ActivatedGaussians, RenderSettings, means_cam_soa,
                                          pose_grads_from_partials, project_for_pose)
from mm3dgs_slam_torch.ops.sh import rgb_to_sh

from test_torch_cull import screen_scene

pytestmark = pytest.mark.gpu
POSE = [0.999, 0.02, -0.01, 0.005, 0.01, -0.02, 0.03]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(dev, n=3000, h=120, w=160, f=140.0):
    cam = Camera(h, w, f, f, w / 2 - 0.5, h / 2 - 0.5)
    rng = np.random.default_rng(0)
    z = rng.uniform(1.0, 6.0, n)
    px, py = rng.uniform(-8, w + 8, n), rng.uniform(-8, h + 8, n)
    xyz = np.stack([(px - cam.cx) / f * z, (py - cam.cy) / f * z, z], -1)
    q = rng.normal(size=(n, 4))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    g = ActivatedGaussians(
        xyz=t(xyz), scales=t(np.exp(rng.uniform(-4.5, -2.5, (n, 3)))),
        rotations=t(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        opacity=t(1 / (1 + np.exp(-2 * rng.normal(size=n)))),
        shs=rgb_to_sh(t(rng.uniform(size=(n, 3))))[:, None, :],
        alive=torch.ones(n, dtype=torch.bool, device=dev))
    rs = RenderSettings(cam=cam)
    pose = t(POSE)
    with torch.no_grad():
        proj = project_for_pose(g, pose, rs)
        bins = build_bins(proj, cam)
    return g, rs, pose, proj.packed.contiguous(), bins


def _args(bins, cam):
    return bins.pair_gauss, bins.tile_start, bins.tile_count, cam


def _hard_scene(kind, dev):
    return screen_scene(kind, 3, dev)


def _fwd_matches_plain(packed, bins, cam, nc):
    before = kernels.FWD.launches
    acc, tfin = kernels.composite_fwd(packed, *_args(bins, cam), nc)
    torch.cuda.synchronize()
    assert kernels.FWD.launches == before + 1
    acc_p, tfin_p = plain.composite_fwd_plain(packed, *_args(bins, cam), nc)
    for white in (0.0, 1.0):
        torch.testing.assert_close(acc + tfin * white, acc_p + tfin_p * white,
                                   atol=2e-5, rtol=1e-4)


def _bwd_matches_plain(packed, bins, cam, nc, dev):
    acc, tfin = kernels.composite_fwd(packed, *_args(bins, cam), nc)
    gen = torch.Generator(device=dev).manual_seed(1)
    dacc = torch.randn(acc.shape, generator=gen, device=dev)
    dtfin = torch.randn(tfin.shape, generator=gen, device=dev)
    a = (packed, *_args(bins, cam)[:3], acc, tfin, dacc, dtfin, cam, nc)
    torch.testing.assert_close(kernels.composite_bwd(*a), plain.composite_bwd_plain(*a),
                               atol=5e-5, rtol=5e-3)


@pytest.mark.parametrize("nc", [3, 4, 5, 6])
def test_fwd_kernel_matches_plain(nc):
    g, rs, pose, packed, bins = _scene(_cuda())
    _fwd_matches_plain(packed, bins, rs.cam, nc)


@pytest.mark.parametrize("kind", ["anisotropic", "saturating"])
@pytest.mark.parametrize("nc", [3, 4, 5, 6])
def test_fwd_kernel_matches_plain_hard_scenes(nc, kind):
    _fwd_matches_plain(*_hard_scene(kind, _cuda()), nc)


@pytest.mark.parametrize("nc", [3, 4])
def test_bwd_kernel_matches_plain(nc):
    dev = _cuda()
    g, rs, pose, packed, bins = _scene(dev)
    _bwd_matches_plain(packed, bins, rs.cam, nc, dev)


@pytest.mark.parametrize("kind", ["anisotropic", "saturating"])
@pytest.mark.parametrize("nc", [3, 4])
def test_bwd_kernel_matches_plain_hard_scenes(nc, kind):
    dev = _cuda()
    _bwd_matches_plain(*_hard_scene(kind, dev), nc, dev)


@pytest.mark.parametrize("kind", ["projected", "anisotropic", "saturating"])
def test_kernel_work_counts_equal_plain_warp_pairs(kind):
    """Kernels 1 and 2 count the (tile, pair, warp box)s their cull keeps
    (work[0]) exactly as the plain walk does, and walk no more (work[1])."""
    dev = _cuda()
    if kind == "projected":
        _, rs, _, packed, bins = _scene(dev)
        cam = rs.cam
    else:
        packed, bins, cam = _hard_scene(kind, dev)
    _, _, want = plain.composite_fwd_plain(packed, *_args(bins, cam), 3, count_work=True)
    w_fwd = torch.zeros(2, dtype=torch.int64, device=dev)
    acc, tfin = kernels.composite_fwd(packed, *_args(bins, cam), 3, work=w_fwd)
    w_bwd = torch.zeros(2, dtype=torch.int64, device=dev)
    kernels.composite_bwd(packed, *_args(bins, cam)[:3], acc, tfin, torch.ones_like(acc),
                          torch.ones_like(tfin), cam, 3, work=w_bwd)
    for kept, walked in (w_fwd.tolist(), w_bwd.tolist()):
        assert kept == want["warp_pairs"]
        assert want["warp_pairs_min"] <= walked <= kept < 8 * want["pairs_walked"]


@pytest.mark.parametrize("nc", [5, 6])
def test_pose_bwd_kernel_matches_plain(nc):
    dev = _cuda()
    g, rs, pose, packed, bins = _scene(dev)
    ext = conic_pose_jacobian_rows(means_cam_soa(g.xyz, pose), g.scales, g.rotations, g.xyz,
                                   rs.cam)
    packed32 = torch.cat([packed, ext], 1).contiguous()
    acc, tfin = kernels.composite_fwd(packed32, *_args(bins, rs.cam), nc)
    gen = torch.Generator(device=dev).manual_seed(2)
    dacc = torch.randn(acc.shape, generator=gen, device=dev)
    dtfin = torch.randn(tfin.shape, generator=gen, device=dev)
    a = (packed32, *_args(bins, rs.cam)[:3], acc, tfin, dacc, dtfin, rs.cam, nc)
    psum_k = kernels.composite_pose_bwd(*a)
    psum_p = plain.composite_pose_bwd_plain(*a)
    torch.testing.assert_close(psum_k, psum_p, atol=5e-5, rtol=5e-3)
    gk = torch.cat(pose_grads_from_partials(psum_k, pose[:4]))
    gp = torch.cat(pose_grads_from_partials(psum_p, pose[:4]))
    torch.testing.assert_close(gk, gp, rtol=5e-4, atol=1e-4)


def test_wrappers_reject_bad_inputs():
    g, rs, pose, packed, bins = _scene(_cuda())
    with pytest.raises(ValueError):
        kernels.composite_fwd(packed.double(), *_args(bins, rs.cam), 3)
    with pytest.raises(ValueError):
        kernels.composite_fwd(packed[:, :8], *_args(bins, rs.cam), 3)
    with pytest.raises(ValueError):
        kernels.composite_fwd(packed, *_args(bins, rs.cam), 7)
    with pytest.raises(ValueError):   # rows are read as float4s: 16-B aligned
        kernels.composite_fwd(packed.reshape(-1)[1:-15].reshape(-1, 16), *_args(bins, rs.cam), 3)
    with pytest.raises(ValueError):
        kernels.composite_fwd(packed, *_args(bins, rs.cam), 3,
                              work=torch.zeros(2, dtype=torch.int32, device=packed.device))
    acc, tfin = kernels.composite_fwd(packed, *_args(bins, rs.cam), 5)
    with pytest.raises(ValueError):   # kernel 2 is compiled for the mapping widths
        kernels.composite_bwd(packed, *_args(bins, rs.cam)[:3], acc, tfin, acc, tfin,
                              rs.cam, 5)
