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
from mm3dgs_slam_torch.ops.binning import build_bins, build_slots
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.projection import conic_pose_jacobian_rows
from mm3dgs_slam_torch.ops.render import (ActivatedGaussians, RenderSettings, means_cam_soa,
                                          pose_grads_from_partials, project_for_pose)
from mm3dgs_slam_torch.ops.sh import rgb_to_sh
from mm3dgs_slam_torch.ops.tolerances import (BA_ATOL, GRAD_TOL, IMG_TOL, PARTIAL_ATOL,
                                              POSE_TOL)

from test_torch_cull import screen_scene

pytestmark = pytest.mark.gpu
POSE = [0.999, 0.02, -0.01, 0.005, 0.01, -0.02, 0.03]
# Kernel 3's per-tile partials cancel, so they are held, as in chip_smoke.py,
# to an atol of PARTIAL_ATOL of each partial's sum |term| and GRAD_TOL's rtol.
# Kernel 2's gradients and per-slot rows are held to GRAD_TOL; where float32
# cannot reach it (a dense scene, where even the float64 backward of the
# float32 forward's outputs misses it; the rows of the hard scenes), against
# the float64 evaluation (_bwd_as_accurate_as_plain, _rows_as_accurate_as_plain).


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
        torch.testing.assert_close(acc + tfin * white, acc_p + tfin_p * white, **IMG_TOL)


def _bwd_matches_plain(packed, bins, cam, nc, dev):
    acc, tfin = kernels.composite_fwd(packed, *_args(bins, cam), nc)
    gen = torch.Generator(device=dev).manual_seed(1)
    dacc = torch.randn(acc.shape, generator=gen, device=dev)
    dtfin = torch.randn(tfin.shape, generator=gen, device=dev)
    a = (packed, *_args(bins, cam)[:3], acc, tfin, dacc, dtfin, cam, nc)
    torch.testing.assert_close(kernels.composite_bwd(*a), plain.composite_bwd_plain(*a),
                               **GRAD_TOL)


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


def _dense_scene(dev):
    """20,000 random Gaussians at 640x480 (227,220 pairs): deep saturating
    layers, behind which kernel 2's dL/dalpha cancels."""
    return _scene(dev, n=20000, h=480, w=640, f=525.0)


def _bwd_as_accurate_as_plain(dk, packed, args, nc):
    """Kernel 2's dpacked `dk` on `args` (pair_gauss, tile_start,
    tile_count, acc, tfin, dacc, dtfin, cam) where GRAD_TOL is out of reach
    of float32: against the float64 evaluation of the plain formulas (on the
    float64 forward) it is no further off than the float32 plain version,
    its error norm and its count of gradients beyond GRAD_TOL each within
    2x of the plain version's. Prints the readings, with those of the
    float64 backward fed the float32 forward's acc and T."""
    pair_gauss, tile_start, tile_count, acc, tfin, dacc, dtfin, cam = args
    bins = (pair_gauss, tile_start, tile_count)
    p64, dacc64, dtfin64 = packed.double(), dacc.double(), dtfin.double()
    acc64, tfin64 = plain.composite_fwd_plain(p64, *bins, cam, nc)
    d64 = plain.composite_bwd_plain(p64, *bins, acc64, tfin64, dacc64, dtfin64, cam, nc)
    got = {"kernel 2": dk, "plain": plain.composite_bwd_plain(packed, *args, nc),
           "float64 on the float32 forward": plain.composite_bwd_plain(
               p64, *bins, acc.double(), tfin.double(), dacc64, dtfin64, cam, nc)}
    tol = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * d64.abs()
    norm, beyond = {}, {}
    for name, d in got.items():
        e = (d.double() - d64).abs()
        norm[name], beyond[name] = float(e.norm()), int((e > tol).sum())
        print(f"[kernel 2, nc {nc}, {int(tile_count.sum())} pairs] {name} against float64: "
              f"max error {float(e.max()):.4g}, norm {norm[name]:.4g}, beyond GRAD_TOL "
              f"{beyond[name]} of {int((d64 != 0).sum())} (max |g| {float(d64.abs().max()):.4g})")
    assert norm["kernel 2"] <= 2 * norm["plain"]
    assert beyond["kernel 2"] <= 2 * beyond["plain"]


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
    bad = err > PARTIAL_ATOL * asum_p + GRAD_TOL["rtol"] * psum_p.abs()
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
    torch.testing.assert_close(gk, gp, **POSE_TOL)


@pytest.mark.parametrize("nc", [3, 4])
def test_ba_pose_gradient_through_kernel_2_matches_plain(nc):
    """Bundle adjustment's pose gradient: autograd through composite_packed
    (kernel 2's dpacked) into the pose of the projection, against the same
    chain through the plain backward; the per-Gaussian terms cancel, so the
    atol is BA_ATOL of their sum |term|."""
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
    assert bool(((g_k - g_p).abs() <= BA_ATOL * asum + POSE_TOL["rtol"] * g_p.abs()).all()), (
        g_k, g_p)


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
    with pytest.raises(ValueError):   # the whole grid's bins for a window of 10 tiles
        kernels.composite_fwd(packed, *_args(bins, rs.cam), 3, tile_lo=0, n_local=10)
    with pytest.raises(ValueError):
        kernels.composite_fwd(packed, *_args(bins, rs.cam), 3, tile_lo=-1)


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
                               **POSE_TOL)


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
                               **POSE_TOL)
    _, _, want = plain.composite_fwd_plain(packed, *_args(bins, cam), 3, count_work=True)
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    kernels.composite_fwd(packed, *_args(bins, cam), 3, work=work)
    assert int(work[0]) == want["warp_pairs"]


def _seeded_scene(dev, h=480, w=640, f=525.0):
    """A frame seeded one Gaussian per pixel, as the mapper seeds its first
    frame (logit-0 opacity, pixel-footprint scales), from a smooth numpy
    depth and colour, and seen from a pose 2 cm and about a degree off: the
    kind of map the main path renders (chip_smoke.py's check scene)."""
    from mm3dgs_slam_torch.models import gaussians as G
    from mm3dgs_slam_torch.slam.map_ops import new_gaussian_candidates

    cam = Camera(h, w, f, f, w / 2 - 0.5, h / 2 - 0.5)
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = 2.0 + 0.6 * np.sin(xx / 53.0) * np.cos(yy / 41.0) + 0.02 * rng.normal(size=(h, w))
    shade = 0.5 + 0.4 * np.sin(xx / 17.0 + yy / 29.0)
    color = np.clip(shade[None] * np.array([1.0, 0.7, 0.4])[:, None, None]
                    + 0.05 * rng.normal(size=(3, h, w)), 0.0, 1.0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    rs = RenderSettings(cam=cam)
    empty = G.empty_map(0, dev)
    stats = new_gaussian_candidates(empty.activated(), t([1, 0, 0, 0, 0, 0, 0]), t(color),
                                    t(depth), rs, True)
    m, _, _ = G.append_gaussians(empty, G.init_adam(empty), stats.candidates)
    g = m.activated()
    q = np.array([1.0, 0.005, -0.008, 0.003])
    pose = t(np.concatenate([q / np.linalg.norm(q), [0.02, -0.01, 0.015]]))
    with torch.no_grad():
        proj = project_for_pose(g, pose, rs)
        bins = build_bins(proj, cam)
    return g, rs, pose, proj.packed.contiguous(), bins


@pytest.mark.parametrize("scene", ["seeded", "dense"])
@pytest.mark.parametrize("world", [2, 7])
def test_windowed_launches_match_plain_and_whole_grid(world, scene):
    """Each kernel launched over the tile windows of W ranks at 640x480
    (1,200 tiles; W 7 leaves 4 pad tiles), as the tile-sharded render runs
    it, on a frame seeded one Gaussian per pixel and on the dense scene:
    the windows stitched against the whole-grid launch (kernel 1's outputs
    and kernel 3's partials equal, kernel 2's dpacked summed over the
    windows within GRAD_TOL, the pad acc 0, T 1 and zero partials); on the
    seeded scene every window against its windowed plain version, on the
    dense one kernel 2's whole-grid launch against the float64 evaluation
    (there a pair whose alpha lies a few ulps from 1/255 is kept by one
    float32 evaluation and skipped by another, so no per-value tolerance
    holds kernel against plain)."""
    from mm3dgs_slam_torch.parallel.mesh import tiles_per_shard

    dev = _cuda()
    if scene == "seeded":
        g, rs, pose, packed, bins = _seeded_scene(dev)
    else:
        g, rs, pose, packed, bins = _dense_scene(dev)
    cam = rs.cam
    tpb = tiles_per_shard(cam, world)
    ext = conic_pose_jacobian_rows(means_cam_soa(g.xyz, pose), g.scales, g.rotations, g.xyz, cam)
    packed32 = torch.cat([packed, ext], 1).contiguous()
    with torch.no_grad():
        proj = project_for_pose(g, pose, rs)
    gen = torch.Generator(device=dev).manual_seed(3)
    pad = lambda x: torch.cat([x, x.new_zeros((world * tpb - x.shape[0],) + x.shape[1:])])  # noqa: E731
    acc5, tfin5 = kernels.composite_fwd(packed32, *_args(bins, cam), 5)
    acc3, tfin3 = kernels.composite_fwd(packed, *_args(bins, cam), 3)
    d5 = torch.randn(pad(acc5).shape, generator=gen, device=dev)
    dt = torch.randn(pad(tfin5).shape, generator=gen, device=dev)
    d3 = d5[:, :3].contiguous()
    psum = kernels.composite_pose_bwd(packed32, *_args(bins, cam)[:3], acc5, tfin5,
                                      d5[:cam.n_tiles], dt[:cam.n_tiles], cam, 5)
    whole = (*_args(bins, cam)[:3], acc3, tfin3, d3[:cam.n_tiles], dt[:cam.n_tiles], cam)
    dpacked = kernels.composite_bwd(packed, *whole, 3)
    if scene == "dense":
        _bwd_as_accurate_as_plain(dpacked, packed, whole, 3)
    windowed = kernels.FWD.launches_windowed
    accs, psums, dsum = [], [], torch.zeros_like(dpacked)
    for r in range(world):
        lo, sl = r * tpb, slice(r * tpb, (r + 1) * tpb)
        wb = build_bins(proj, cam, lo, tpb)
        win = dict(tile_lo=lo, n_local=tpb)
        a, t = kernels.composite_fwd(packed32, *_args(wb, cam), 5, **win)
        pa = (packed32, *_args(wb, cam)[:3], a, t, d5[sl], dt[sl], cam, 5)
        pk = kernels.composite_pose_bwd(*pa, **win)
        a3, t3 = kernels.composite_fwd(packed, *_args(wb, cam), 3, **win)
        ba = (*_args(wb, cam)[:3], a3, t3, d3[sl], dt[sl], cam)
        dk = kernels.composite_bwd(packed, *ba, 3, **win)
        if scene == "seeded":
            ap, tp = plain.composite_fwd_plain(packed32, *_args(wb, cam), 5, **win)
            torch.testing.assert_close(a, ap, **IMG_TOL)
            torch.testing.assert_close(t, tp, **IMG_TOL)
            pp, asum = plain.composite_pose_bwd_plain(*pa, abs_sum=True, **win)
            assert bool(((pk - pp).abs() <= PARTIAL_ATOL * asum
                         + GRAD_TOL["rtol"] * pp.abs()).all())
            torch.testing.assert_close(dk, plain.composite_bwd_plain(packed, *ba, 3, **win),
                                       **GRAD_TOL)
        accs.append(torch.cat([a, t], 1))
        psums.append(pk)
        dsum += dk
    torch.cuda.synchronize()
    assert kernels.FWD.launches_windowed == windowed + 2 * world
    stitched, psum_s = torch.cat(accs), torch.cat(psums)
    assert torch.equal(stitched[:cam.n_tiles], torch.cat([acc5, tfin5], 1))
    assert torch.equal(psum_s[:cam.n_tiles], psum)
    assert bool((stitched[cam.n_tiles:, :5] == 0).all())
    assert bool((stitched[cam.n_tiles:, 5] == 1.0).all())
    assert bool((psum_s[cam.n_tiles:] == 0).all())
    torch.testing.assert_close(dsum, dpacked, **GRAD_TOL)
    assert float(dpacked.abs().max()) > 1e-3


def _rows_as_accurate_as_plain(rows_k, packed, args, nc, **win):
    """Kernel 2's per-slot rows `rows_k` on `args` (pair_gauss, tile_start,
    tile_count, acc, tfin, dacc, dtfin, cam) where a row's pixel terms
    cancel beyond what float32 holds to GRAD_TOL (the anisotropic scene has
    a row of 2.66 that float32 sums in two orders put 0.021 apart): against
    the float64 evaluation of the plain first pass (on the float64 forward)
    its error norm is within 2x of the float32 plain version's. Prints
    both readings."""
    pair_gauss, tile_start, tile_count, acc, tfin, dacc, dtfin, cam = args
    bins = (pair_gauss, tile_start, tile_count)
    p64 = packed.double()
    acc64, tfin64 = plain.composite_fwd_plain(p64, *bins, cam, nc, **win)
    r64 = plain.composite_bwd_pairs_plain(p64, *bins, acc64, tfin64, dacc.double(),
                                          dtfin.double(), cam, nc, **win)
    got = {"kernel 2": rows_k, "plain": plain.composite_bwd_pairs_plain(packed, *args, nc, **win)}
    tol = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * r64.abs()
    norm = {}
    for name, r in got.items():
        e = (r.double() - r64).abs()
        norm[name] = float(e.norm())
        print(f"[kernel 2 rows, nc {nc}, {r.shape[0]} slots] {name} against float64: max "
              f"error {float(e.max()):.4g}, norm {norm[name]:.4g}, beyond GRAD_TOL "
              f"{int((e > tol).sum())} of {int((r64 != 0).sum())} (max |row| "
              f"{float(r64.abs().max()):.4g})")
    assert norm["kernel 2"] <= 2 * norm["plain"]


def _bwd_twice(packed, bins, cam, nc, dev, accurate=False, **win):
    """Kernel 2 on the same inputs (over the window `win` of `bins`, the
    whole grid by default): the rows pass launched twice, then both passes
    through `composite_bwd`; the rows and dpacked the same bits each time,
    and dpacked bit-equal to the plain slot reduce of the kernel's rows
    (the same adds in the same order). The rows are held to their plain
    version at GRAD_TOL, or, on the scenes where float32 cannot reach it
    (`accurate`), against the float64 evaluation
    (_rows_as_accurate_as_plain)."""
    a, t = kernels.composite_fwd(packed, *_args(bins, cam), nc, **win)
    gen = torch.Generator(device=dev).manual_seed(5)
    dacc = torch.randn(a.shape, generator=gen, device=dev)
    dtfin = torch.randn(t.shape, generator=gen, device=dev)
    args = (packed, *_args(bins, cam)[:3], a, t, dacc, dtfin, cam, nc)
    n = packed.shape[0]
    slots = build_slots(bins.pair_gauss, n)
    before = kernels.BWD.launches, kernels.REDUCE.launches
    rows1 = kernels.composite_bwd_rows(*args, **win)
    rows2 = kernels.composite_bwd_rows(*args, **win)
    d1 = kernels.slot_reduce(rows1, slots, n, windowed=bool(win))
    d2 = kernels.composite_bwd(*args, slots=slots, **win)
    torch.cuda.synchronize()
    assert (kernels.BWD.launches, kernels.REDUCE.launches) == (before[0] + 3, before[1] + 2)
    assert torch.equal(rows1, rows2) and torch.equal(d1, d2)
    if accurate:
        _rows_as_accurate_as_plain(rows1, packed, args[1:-1], nc, **win)
    else:
        torch.testing.assert_close(rows1, plain.composite_bwd_pairs_plain(*args, **win),
                                   **GRAD_TOL)
    assert torch.equal(d1, plain.slot_reduce_plain(rows1, slots, n))
    assert float(d1[:, 6 + nc:].abs().max()) == 0.0
    return d1


@pytest.mark.parametrize("kind", ["projected", "anisotropic", "saturating", "dense"])
@pytest.mark.parametrize("nc", [3, 4])
def test_bwd_kernel_is_bit_identical_across_launches(nc, kind):
    """The whole grid, on the projected scene and the hard ones (the
    saturating one has tiles of more than 256 pairs, both halves of a batch
    and blocks that stop early: zero rows past the stop; the dense one
    227,220 pairs at 640x480); the rows of the hard and dense scenes
    against the float64 evaluation."""
    dev = _cuda()
    if kind == "projected":
        _, rs, _, packed, bins = _scene(dev)
        cam = rs.cam
    elif kind == "dense":
        _, rs, _, packed, bins = _dense_scene(dev)
        cam = rs.cam
    else:
        packed, bins, cam = _hard_scene(kind, dev)
    d = _bwd_twice(packed, bins, cam, nc, dev, accurate=kind != "projected")
    assert float(d.abs().max()) > 0


@pytest.mark.parametrize("world", [2, 7])
def test_bwd_kernel_windows_are_bit_identical_across_launches(world):
    """Every tile window of W ranks at 640x480 on the seeded scene (W 7
    leaves 4 pad tiles): see _bwd_twice."""
    from mm3dgs_slam_torch.parallel.mesh import tiles_per_shard

    dev = _cuda()
    g, rs, pose, packed, bins = _seeded_scene(dev)
    tpb = tiles_per_shard(rs.cam, world)
    with torch.no_grad():
        proj = project_for_pose(g, pose, rs)
    windowed = kernels.REDUCE.launches_windowed
    for r in range(world):
        _bwd_twice(packed, build_bins(proj, rs.cam, r * tpb, tpb), rs.cam, 3, dev,
                   tile_lo=r * tpb, n_local=tpb)
    assert kernels.REDUCE.launches_windowed == windowed + 2 * world


def _long_tail_rows(dev, nc, n=40001, seed=0):
    """A drawn slot table with a long tail, and rows for it: 60,000 slots
    over the first 30,000 of n Gaussians (the others have none; n is not a
    multiple of 32), and 8 Gaussians with 300-800 slots each, spread among
    them; rows over twelve decades, so that the sums depend on the order."""
    rng = np.random.default_rng(seed)
    heavy = rng.choice(30000, 8, replace=False)
    pg = np.concatenate([rng.integers(0, 30000, 60000),
                         np.repeat(heavy, rng.integers(300, 800, 8))])
    pg = pg[rng.permutation(pg.shape[0])]
    rows = (rng.standard_normal((pg.shape[0], 6 + nc))
            * 10.0 ** rng.integers(-6, 6, (pg.shape[0], 6 + nc)))
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)  # noqa: E731
    return t(rows, np.float32), t(pg, np.int32), n


@pytest.mark.parametrize("kind", ["anisotropic", "saturating", "long_tail"])
@pytest.mark.parametrize("nc", [3, 4])
def test_slot_reduce_kernel_equals_plain(nc, kind):
    """Kernel 2's second pass alone, on the kernel's rows of the hard scenes
    and on a long-tail table: two launches and the plain reduce of the same
    rows the same bits, the columns past 6 + nc +0."""
    dev = _cuda()
    if kind == "long_tail":
        rows, pair_gauss, n = _long_tail_rows(dev, nc)
    else:
        packed, bins, cam = _hard_scene(kind, dev)
        acc, tfin = kernels.composite_fwd(packed, *_args(bins, cam), nc)
        gen = torch.Generator(device=dev).manual_seed(7)
        rows = kernels.composite_bwd_rows(
            packed, *_args(bins, cam)[:3], acc, tfin,
            torch.randn(acc.shape, generator=gen, device=dev),
            torch.randn(tfin.shape, generator=gen, device=dev), cam, nc)
        pair_gauss, n = bins.pair_gauss, packed.shape[0]
    slots = build_slots(pair_gauss, n)
    before = kernels.REDUCE.launches
    d1 = kernels.slot_reduce(rows, slots, n)
    d2 = kernels.slot_reduce(rows, slots, n)
    torch.cuda.synchronize()
    assert kernels.REDUCE.launches == before + 2
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(bits(d1), bits(d2))
    assert torch.equal(bits(d1), bits(plain.slot_reduce_plain(rows, slots, n)))
    assert not bits(d1[:, 6 + nc:].contiguous()).any()
    counts = slots.gauss_start[1:] - slots.gauss_start[:-1]
    assert int(counts.max()) > (300 if kind == "long_tail" else 1)
    assert float(d1.abs().max()) > 0


def test_bench_kernel_check_passes():
    """The bench's own kernel check (kernels 1-3 against their plain
    versions on its 2,048-Gaussian 120x160 scene) on the card."""
    from mm3dgs_slam_torch import bench

    out = bench.kernel_check(_cuda())
    assert out["opacity_grad_max"] > 0 and max(out.values()) < 1e3
