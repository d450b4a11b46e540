"""Kernel 2's fixed-order mapping backward, held on the CPU: its first pass
(the per-slot rows, plain version) against the JAX package's `_bwd_kernel`
rows (Pallas in interpret mode), the slot table of `binning.build_slots` (a
hypothesis property, over whole grids and tile windows), the slot reduce
against the per-rank `index_add_` accumulation it replaced, and the slot
table's path through the render glue and the mapping loop."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mm3dgs_slam_tpu.ops.binning import build_bins as jbuild_bins
from mm3dgs_slam_tpu.ops.pallas_composite import CHUNK, _composite_pallas_bwd_rows, pack_pairs
from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS
from mm3dgs_slam_tpu.ops.render import project_for_pose as jproject

from mm3dgs_slam_torch.ops import kernels
from mm3dgs_slam_torch.ops.binning import build_bins, build_slots
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.composite import (composite_bwd_pairs_plain, composite_bwd_plain,
                                             composite_fwd_plain, slot_reduce_plain)
from mm3dgs_slam_torch.ops.render import (ActivatedGaussians, RenderSettings, composite_packed,
                                          project_for_pose)

from utils import random_scene, small_camera

torch.set_num_threads(1)
IDENTITY = np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)
GRAD = dict(atol=5e-5, rtol=5e-3)   # per-gaussian gradients, tests/test_rasterizer.py:119
U32 = 2.0 ** -24                    # float32 unit roundoff


def _project(g, cam):
    rs = RenderSettings(cam=Camera(*cam))
    with torch.no_grad():
        tg = ActivatedGaussians(*(torch.as_tensor(np.asarray(x)).clone() for x in g))
        return project_for_pose(tg, torch.as_tensor(IDENTITY), rs), rs.cam


def _backward_inputs(packed, bins, cam, nc, seed):
    """(acc, tfin) of the plain forward and numpy-drawn (dacc, dtfin)."""
    acc, tfin = composite_fwd_plain(packed, *bins, cam, nc)
    rng = np.random.default_rng(seed)
    return (acc, tfin, torch.as_tensor(rng.standard_normal(acc.shape).astype(np.float32)),
            torch.as_tensor(rng.standard_normal(tfin.shape).astype(np.float32)))


@pytest.mark.parametrize("nc", [3, 4])
def test_pair_rows_match_jax_bwd_kernel_rows(nc):
    """The plain per-slot rows against `_composite_pallas_bwd_rows` (the
    Pallas `_bwd_kernel`, interpret mode) on the same acc, tfin, dacc and
    dtfin, slot to slot through each package's tile_start (JAX pads each
    tile's slab to CHUNK)."""
    cam = small_camera()
    g = random_scene(jax.random.PRNGKey(3), 150, cam, n_dead=10)
    jp = jproject(g, jnp.asarray(IDENTITY), JRS(cam=cam))
    jb = jbuild_bins(jp, cam, 1 << 15, 256, align=CHUNK)
    proj, tcam = _project(g, cam)
    bins = build_bins(proj, tcam)
    packed = proj.packed.contiguous()
    acc, tfin, dacc, dtfin = _backward_inputs(packed, bins, tcam, nc, 11)
    rows = composite_bwd_pairs_plain(packed, *bins, acc, tfin, dacc, dtfin, tcam, nc)
    jrows = np.asarray(_composite_pallas_bwd_rows(
        pack_pairs(jp.packed, jb.pair_gauss, jb.pair_valid), jb.tile_start, jb.tile_count,
        jnp.asarray(acc.numpy()), jnp.asarray(tfin.numpy()), jnp.asarray(dacc.numpy()),
        jnp.asarray(dtfin.numpy()), cam, interpret=True, chan_major=True, nc=nc))
    count = bins.tile_count.numpy()
    np.testing.assert_array_equal(count, np.asarray(jb.tile_count))
    slots = lambda start: np.concatenate(  # noqa: E731
        [start[t] + np.arange(count[t]) for t in range(len(count))])
    pslot, jslot = slots(bins.tile_start.numpy()), slots(np.asarray(jb.tile_start))
    assert len(pslot) == rows.shape[0] == bins.pair_gauss.shape[0]
    np.testing.assert_array_equal(bins.pair_gauss.numpy()[pslot],
                                  np.asarray(jb.pair_gauss)[jslot])
    np.testing.assert_allclose(rows.numpy()[pslot], jrows[:6 + nc, jslot].T, **GRAD)
    assert np.abs(jrows[:6 + nc, jslot]).max() > 1e-4


def _check_slots(pair_gauss, n):
    """Gaussian g's slots are exactly the indices where pair_gauss == g, in
    ascending order, and the segments tile [0, P)."""
    start, slot = build_slots(pair_gauss, n)
    assert start.dtype == slot.dtype == torch.int32
    assert start.shape == (n + 1,) and slot.shape == pair_gauss.shape
    assert int(start[0]) == 0 and int(start[-1]) == pair_gauss.shape[0]
    pg = pair_gauss.numpy()
    for g in range(n):
        np.testing.assert_array_equal(slot[int(start[g]):int(start[g + 1])].numpy(),
                                      np.flatnonzero(pg == g))


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_slot_table_lists_each_gaussians_slots_in_order(data):
    n = data.draw(st.integers(1, 40))
    pair_gauss = data.draw(st.lists(st.integers(0, n - 1), max_size=300))
    _check_slots(torch.tensor(pair_gauss, dtype=torch.int32).reshape(-1), n)


@functools.lru_cache(maxsize=None)
def _window_scene():
    cam = small_camera(h=64, w=96, f=80.0)
    proj, tcam = _project(random_scene(jax.random.PRNGKey(8), 400, cam, n_dead=20), cam)
    return proj, tcam, build_bins(proj, tcam)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 23), st.integers(1, 30))
def test_slot_table_of_a_window_covers_its_pairs(tile_lo, n_local):
    """Over a tile window (which may run past the grid), the window's bins
    hold exactly the whole grid's pairs of its tiles, and their slot table
    lists each Gaussian's slots among them."""
    proj, cam, whole = _window_scene()
    wb = build_bins(proj, cam, tile_lo, n_local)
    hi = min(tile_lo + n_local, cam.n_tiles)
    a = int(whole.tile_start[tile_lo])
    b = int(whole.tile_start[hi - 1] + whole.tile_count[hi - 1]) if hi > tile_lo else a
    assert torch.equal(wb.pair_gauss, whole.pair_gauss[a:b])
    _check_slots(wb.pair_gauss, proj.packed.shape[0])


@pytest.mark.parametrize("world", [1, 2, 3])
def test_every_bins_builder_gives_exactly_its_windows_pairs(world):
    """Kernel 2's rows pass writes the slots of its window's tiles, each
    tile's run right after the previous one's, into rows it does not
    clear, and the slot reduce reads every slot of pair_gauss: so every way
    the port builds bins gives pair_gauss exactly those slots (tile_start
    from 0, P = tile_start[-1] + tile_count[-1]). Through build_bins over
    the whole grid (the render glue's and the bench's), the mesh's
    build_window_bins for each rank of `world` (tile windows past the grid
    included), and the mapping loop's _map_bins."""
    from mm3dgs_slam_torch.parallel.mesh import Mesh
    from mm3dgs_slam_torch.parallel.tile_sharded import build_window_bins
    from mm3dgs_slam_torch.slam import map_opt

    proj, cam, whole = _window_scene()
    built = [whole] + [build_window_bins(proj, cam, Mesh(size=world, rank=r, device=None,
                                                         backend=None))
                       for r in range(world)]
    m, rs = _seeded_map(cam, world)
    built.append(map_opt._map_bins(m, torch.as_tensor(IDENTITY),
                                   map_opt.MapOptSettings(rs=rs, iters=1))[0])
    for b in built:
        start, count = b.tile_start.long(), b.tile_count.long()
        assert int(start[0]) == 0
        assert torch.equal(start[1:], (start + count)[:-1])
        assert b.pair_gauss.shape[0] == int(start[-1] + count[-1])
    assert sum(b.pair_gauss.shape[0] for b in built[1:1 + world]) == whole.pair_gauss.shape[0]
    assert built[-1].pair_gauss.shape[0] > 0


def _rank_order_index_add(rows, bins, n):
    """The accumulation the slot reduce replaced: for each depth rank r in
    turn, one `index_add_` of every tile's rank-r slot, in tile order."""
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype)
    start, count = bins.tile_start.long(), bins.tile_count.long()
    for r in range(int(count.max())):
        slot = (start + r)[count > r]
        out.index_add_(0, bins.pair_gauss[slot].long(), rows[slot])
    return out


@pytest.mark.parametrize("nc", [3, 4])
def test_slot_reduce_only_reorders_the_index_add_sum(nc):
    """dpacked from the slot reduce is bit-equal to one `index_add_` of the
    rows in slot order (the CPU adds in index order), and to the per-rank
    `index_add_` it replaced for every Gaussian with at most two slots
    (a + b = b + a); for the others the two orders differ by rounding alone,
    at most 2 (k - 1) u sum |row| for k slots."""
    cam = small_camera(h=120, w=160, f=140.0)
    proj, tcam = _project(random_scene(jax.random.PRNGKey(7), 3000, cam, n_dead=10), cam)
    bins = build_bins(proj, tcam)
    packed, n = proj.packed.contiguous(), proj.packed.shape[0]
    args = (packed, *bins, *_backward_inputs(packed, bins, tcam, nc, 7), tcam, nc)
    rows = composite_bwd_pairs_plain(*args)
    dpacked = composite_bwd_plain(*args)
    idx = bins.pair_gauss.long()
    assert torch.equal(dpacked[:, :6 + nc], torch.zeros((n, 6 + nc)).index_add_(0, idx, rows))
    assert float(dpacked[:, 6 + nc:].abs().max()) == 0.0
    by_rank = _rank_order_index_add(rows, bins, n)
    k = torch.bincount(idx, minlength=n)
    few = k <= 2
    assert torch.equal(dpacked[few, :6 + nc], by_rank[few])
    abs_sum = torch.zeros((n, 6 + nc)).index_add_(0, idx, rows.abs())
    bound = 2 * (k - 1).clamp(min=0)[:, None] * U32 * abs_sum * (1 + 1e-3)
    assert bool(((dpacked[:, :6 + nc] - by_rank).abs() <= bound).all())
    assert int((k > 2).sum()) > 100 and float(rows.abs().max()) > 1e-3


@pytest.mark.parametrize("nc", [3, 4])
def test_cpu_wrappers_give_the_plain_passes(nc):
    """On CPU tensors kernels.composite_bwd_rows is the plain first pass,
    slot_reduce the plain reduce and composite_bwd the two, with or
    without a given slot table, all bit-equal; nothing is counted."""
    cam = small_camera()
    proj, tcam = _project(random_scene(jax.random.PRNGKey(2), 200, cam, n_dead=5), cam)
    bins = build_bins(proj, tcam)
    packed, n = proj.packed.contiguous(), proj.packed.shape[0]
    args = (packed, *bins, *_backward_inputs(packed, bins, tcam, nc, 2), tcam, nc)
    slots = build_slots(bins.pair_gauss, n)
    before = kernels.launch_counts()
    rows = kernels.composite_bwd_rows(*args)
    d = kernels.composite_bwd(*args)
    assert torch.equal(rows, composite_bwd_pairs_plain(*args))
    assert torch.equal(d, composite_bwd_plain(*args))
    assert torch.equal(kernels.composite_bwd(*args, slots=slots), d)
    assert torch.equal(kernels.slot_reduce(rows, slots, n), slot_reduce_plain(rows, slots, n))
    assert kernels.launch_counts() == before


def _seeded_map(cam, seed):
    """A map seeded one Gaussian per pixel from a numpy-drawn colour and
    depth at the identity pose, and its render settings."""
    from mm3dgs_slam_torch.models import gaussians as G
    from mm3dgs_slam_torch.slam.map_ops import new_gaussian_candidates

    rs = RenderSettings(cam=cam)
    rng = np.random.default_rng(seed)
    color = torch.as_tensor(rng.uniform(size=(3, cam.height, cam.width)), dtype=torch.float32)
    depth = torch.as_tensor(rng.uniform(2.0, 3.0, (cam.height, cam.width)), dtype=torch.float32)
    empty = G.empty_map(0, "cpu")
    stats = new_gaussian_candidates(empty.activated(), torch.as_tensor(IDENTITY), color, depth,
                                    rs, True)
    m, _, _ = G.append_gaussians(empty, G.init_adam(empty), stats.candidates)
    return m, rs


def test_composite_packed_backward_with_a_slot_table():
    """The render glue's backward through a given slot table (the mapping
    loop's, built once per set of bins) and through one it builds itself
    give the same bits, and the mapping loop's `_map_bins` hands out the
    slot table of its bins."""
    from mm3dgs_slam_torch.slam import map_opt

    cam = small_camera()
    proj, tcam = _project(random_scene(jax.random.PRNGKey(4), 200, cam, n_dead=5), cam)
    bins = build_bins(proj, tcam)
    w = torch.as_tensor(np.random.default_rng(4).standard_normal((tcam.n_tiles, 3, 256)),
                        dtype=torch.float32)
    grads = []
    for slots in (None, build_slots(bins.pair_gauss, proj.packed.shape[0])):
        packed = proj.packed.detach().clone().requires_grad_(True)
        acc, tfin = composite_packed(packed, bins, tcam, 3, slots=slots)
        (grad,) = torch.autograd.grad((acc * w).sum() + tfin.sum(), packed)
        grads.append(grad)
    assert torch.equal(grads[0], grads[1]) and float(grads[0].abs().max()) > 0

    m, rs = _seeded_map(tcam, 6)
    tile_bins, slots = map_opt._map_bins(m, torch.as_tensor(IDENTITY),
                                         map_opt.MapOptSettings(rs=rs, iters=1))
    want = build_slots(tile_bins.pair_gauss, m.n)
    assert torch.equal(slots.gauss_start, want.gauss_start)
    assert torch.equal(slots.gauss_slot, want.gauss_slot) and slots.gauss_slot.shape[0] > 0


def _write_run(d, rng_seed=0, psnr_nudge=False, ply_nudge=False):
    """A run directory with results.npz and two PLY snapshots; the nudges
    move one PSNR or one opacity to the next float."""
    from mm3dgs_slam_torch.models import ply_io

    rng = np.random.default_rng(rng_seed)
    t = np.linspace(0, 1, 5)
    poses = np.stack([np.ones(5), 0.01 * t, 0 * t, 0 * t, 0.1 * t, 0.05 * t, 0.02 * t],
                     1).astype(np.float32)
    psnr = np.array([30.0, 31.0])
    if psnr_nudge:
        psnr[1] = np.nextafter(psnr[1], np.inf)
    d.mkdir(parents=True)
    np.savez(d / "results", pose_est=poses, pose_gt=poses, ate_rmse=0.004, psnr_list=psnr,
             ssim_list=[0.95, 0.96], lpips_list=[float("nan")] * 2,
             lpips_proxy_list=[0.1, 0.2])
    n = 200
    ply = dict(xyz=rng.normal(size=(n, 3)), features_dc=rng.normal(size=(n, 1, 3)),
               features_rest=rng.normal(size=(n, 1, 3)), opacity=rng.normal(size=(n, 1)),
               scaling=rng.normal(size=(n, 3)) - 3, rotation=rng.normal(size=(n, 4)),
               rgb=rng.uniform(size=(n, 3)))
    ply = {k: np.asarray(v, np.float32) for k, v in ply.items()}
    for it in (2, 4):
        if ply_nudge and it == 4:
            ply["opacity"][7, 0] = np.nextafter(ply["opacity"][7, 0], np.float32(np.inf))
        ply_io.save_ply(str(d / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"), **ply)


@pytest.mark.parametrize("nudge", ["none", "psnr", "ply"])
def test_diff_results_exact_wants_the_same_bits(tmp_path, nudge):
    """`diff_results --exact` (the comparison of two golden runs of one
    commit) passes on the same bits and fails on one float moved by an ulp,
    in results.npz or in a PLY, where the 1% checks alone pass."""
    import contextlib
    import io

    from mm3dgs_slam_torch.scripts import diff_results

    _write_run(tmp_path / "a")
    _write_run(tmp_path / "b", psnr_nudge=nudge == "psnr", ply_nudge=nudge == "ply")
    argv = [str(tmp_path / "a"), str(tmp_path / "b")]
    for exact, want in ((False, 0), (True, 0 if nudge == "none" else 1)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = diff_results.main(argv + ["--exact"] * exact)
        assert code == want, out.getvalue()
        assert ("BIT-IDENTICAL: PASS" in out.getvalue()) == (exact and nudge == "none")
    assert diff_results.same_bits(*argv) == (nudge == "none")
