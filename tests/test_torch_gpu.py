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
# Kernel 3's per-tile partials cancel, so they are held, as in chip_smoke.py,
# to an atol of this fraction of each partial's sum |term| and rtol 5e-3.
PARTIAL_ATOL = 1e-5


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


def _with_pose_columns(packed, seed=0):
    """[n, 16] rows -> [n, 32]: 12 pose columns (rows 16-27) drawn with
    numpy; kernel 3's contraction is linear, so any values test it."""
    n = packed.shape[0]
    cols = np.concatenate([np.random.default_rng(seed).normal(size=(n, 12)), np.zeros((n, 4))], 1)
    return torch.cat([packed, torch.as_tensor(cols, dtype=torch.float32, device=packed.device)],
                     1).contiguous()


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
    """Each kernel counts the (tile, pair, warp box)s its cull keeps
    (work[0]) exactly as the plain walk does, and walks no more (work[1])."""
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
    packed32 = _with_pose_columns(packed)
    acc, tfin = kernels.composite_fwd(packed32, *_args(bins, cam), 5)
    w_pose = torch.zeros(2, dtype=torch.int64, device=dev)
    kernels.composite_pose_bwd(packed32, *_args(bins, cam)[:3], acc, tfin, torch.ones_like(acc),
                               torch.ones_like(tfin), cam, 5, work=w_pose)
    for kept, walked in (w_fwd.tolist(), w_bwd.tolist(), w_pose.tolist()):
        assert kept == want["warp_pairs"]
        assert want["warp_pairs_min"] <= walked <= kept < 8 * want["pairs_walked"]


def _pose_bwd_matches_plain(packed32, bins, cam, nc, dev):
    """Kernel 3's partials against the plain version's; returns both."""
    acc, tfin = kernels.composite_fwd(packed32, *_args(bins, cam), nc)
    gen = torch.Generator(device=dev).manual_seed(2)
    dacc = torch.randn(acc.shape, generator=gen, device=dev)
    dtfin = torch.randn(tfin.shape, generator=gen, device=dev)
    a = (packed32, *_args(bins, cam)[:3], acc, tfin, dacc, dtfin, cam, nc)
    psum_k = kernels.composite_pose_bwd(*a)
    psum_p, asum_p = plain.composite_pose_bwd_plain(*a, abs_sum=True)
    err = (psum_k - psum_p).abs()
    bad = err > PARTIAL_ATOL * asum_p + 5e-3 * psum_p.abs()
    assert not bool(bad.any()), (
        f"{int(bad.sum())} partials off; worst {float(err.max()):.3e}, "
        f"{float((err / asum_p.clamp_min(1e-30)).max()):.3e} of sum |term|")
    assert float(asum_p.sum()) > 0
    return psum_k, psum_p


@pytest.mark.parametrize("nc", [5, 6])
def test_pose_bwd_kernel_matches_plain(nc):
    dev = _cuda()
    g, rs, pose, packed, bins = _scene(dev)
    ext = conic_pose_jacobian_rows(means_cam_soa(g.xyz, pose), g.scales, g.rotations, g.xyz,
                                   rs.cam)
    packed32 = torch.cat([packed, ext], 1).contiguous()
    psum_k, psum_p = _pose_bwd_matches_plain(packed32, bins, rs.cam, nc, dev)
    gk = torch.cat(pose_grads_from_partials(psum_k, pose[:4]))
    gp = torch.cat(pose_grads_from_partials(psum_p, pose[:4]))
    torch.testing.assert_close(gk, gp, rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("nc", [3, 4])
def test_ba_pose_gradient_through_kernel_2_matches_plain(nc):
    """Bundle adjustment's pose gradient: autograd through composite_packed
    (kernel 2's dpacked) into the pose of the projection, against the same
    chain through the plain backward; the per-Gaussian terms cancel, so the
    atol is 1e-5 of their sum |term| (chip_smoke.py's BA_ATOL)."""
    from mm3dgs_slam_torch.ops.render import composite_packed

    dev = _cuda()
    g, rs, pose, packed, bins = _scene(dev)
    acc, tfin = kernels.composite_fwd(packed, *_args(bins, rs.cam), nc)
    gen = torch.Generator(device=dev).manual_seed(2)
    dacc = torch.randn(acc.shape, generator=gen, device=dev)
    dtfin = torch.randn(tfin.shape, generator=gen, device=dev)
    p = pose.clone().requires_grad_(True)
    acc2, tfin2 = composite_packed(project_for_pose(g, p, rs).packed, bins, rs.cam, nc)
    (g_k,) = torch.autograd.grad((acc2 * dacc).sum() + (tfin2 * dtfin).sum(), p)
    d_p = plain.composite_bwd_plain(packed, *_args(bins, rs.cam)[:3], acc, tfin, dacc, dtfin,
                                    rs.cam, nc)
    eye = torch.eye(7, device=dev)
    with torch.no_grad():
        J = torch.stack([torch.func.jvp(lambda q: project_for_pose(g, q, rs).packed,
                                        (pose,), (eye[j],))[1] for j in range(7)])
    terms = J * d_p
    g_p, asum = terms.sum((1, 2)), terms.abs().sum((1, 2))
    assert float(asum.min()) > 0
    assert bool(((g_k - g_p).abs() <= 1e-5 * asum + 5e-4 * g_p.abs()).all()), (g_k, g_p)


@pytest.mark.parametrize("kind", ["anisotropic", "saturating"])
@pytest.mark.parametrize("nc", [5, 6])
def test_pose_bwd_kernel_matches_plain_hard_scenes(nc, kind):
    dev = _cuda()
    packed, bins, cam = _hard_scene(kind, dev)
    _pose_bwd_matches_plain(_with_pose_columns(packed), bins, cam, nc, dev)


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


@pytest.mark.parametrize("hw", [(90, 100), (42, 64)])
def test_kernels_on_partial_tiles(hw):
    """Heights (and a width) that are not multiples of 16, as UTMM.yml's 330
    rows: the last tile row is partial. Kernel 1 at nc 4 and 5, kernel 2 at
    nc 4, kernel 3 at nc 5 against their plain versions."""
    dev = _cuda()
    h, w = hw
    g, rs, pose, packed, bins = _scene(dev, n=2000, h=h, w=w, f=90.0)
    assert h % 16 and rs.cam.tiles_y * 16 > h
    for nc in (4, 5):
        _fwd_matches_plain(packed, bins, rs.cam, nc)
    _bwd_matches_plain(packed, bins, rs.cam, 4, dev)
    ext = conic_pose_jacobian_rows(means_cam_soa(g.xyz, pose), g.scales, g.rotations, g.xyz,
                                   rs.cam)
    psum_k, psum_p = _pose_bwd_matches_plain(torch.cat([packed, ext], 1).contiguous(), bins,
                                             rs.cam, 5, dev)
    torch.testing.assert_close(torch.cat(pose_grads_from_partials(psum_k, pose[:4])),
                               torch.cat(pose_grads_from_partials(psum_p, pose[:4])),
                               rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(340, 600), (32, 600)])
def test_kernels_on_a_partial_tile_column(hw):
    """replica.yml's 600x340 (37.5 x 21.25 tiles: the last tile column 8
    pixels wide, the last row 4 high) and a 2-tile-high strip of it: kernel 1
    at nc 3 and 5, kernel 2 at nc 3 and 4 and kernel 3 at nc 5 against their
    plain versions, with pairs in the partial column, and kernel 1's count of
    kept (tile, pair, warp box)s equal to the plain warp_pairs."""
    dev = _cuda()
    h, w = hw
    g, rs, pose, packed, bins = _scene(dev, n=6000 * h // 340, h=h, w=w, f=300.0)
    cam = rs.cam
    assert w % 16 == 8 and cam.tiles_x * 16 > w
    last_col = torch.arange(cam.n_tiles, device=dev) % cam.tiles_x == cam.tiles_x - 1
    assert int(bins.tile_count[last_col].sum()) > 0
    for nc in (3, 5):
        _fwd_matches_plain(packed, bins, cam, nc)
    for nc in (3, 4):
        _bwd_matches_plain(packed, bins, cam, nc, dev)
    ext = conic_pose_jacobian_rows(means_cam_soa(g.xyz, pose), g.scales, g.rotations, g.xyz, cam)
    packed32 = torch.cat([packed, ext], 1).contiguous()
    psum_k, psum_p = _pose_bwd_matches_plain(packed32, bins, cam, 5, dev)
    torch.testing.assert_close(torch.cat(pose_grads_from_partials(psum_k, pose[:4])),
                               torch.cat(pose_grads_from_partials(psum_p, pose[:4])),
                               rtol=5e-4, atol=1e-4)
    _, _, want = plain.composite_fwd_plain(packed, *_args(bins, cam), 3, count_work=True)
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    kernels.composite_fwd(packed, *_args(bins, cam), 3, work=work)
    assert int(work[0]) == want["warp_pairs"]
