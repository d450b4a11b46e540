"""Kernel 2's second pass, the slot reduce (JAX `_table_reduce`), on the CPU:
`kernels.slot_reduce` on CPU tensors and `slot_reduce_plain` against a
sequential float32 loop written here (dpacked row g = 0 + r_s0 + r_s1 + ...
over Gaussian g's slots in ascending slot order, the order the CUDA kernel
adds in), bit for bit, on hypothesis-drawn slot tables (Gaussians without a
slot, one Gaussian with hundreds) and on the tile windows of 1-3 ranks; and
against the JAX package's `_table_reduce` of the same rows, which adds in
another order (within the rounding of two orders)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mm3dgs_slam_tpu.ops.binning import build_bins as jbuild_bins
from mm3dgs_slam_tpu.ops.pallas_composite import CHUNK, _table_reduce
from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS
from mm3dgs_slam_tpu.ops.render import project_for_pose as jproject

from mm3dgs_slam_torch.ops import kernels
from mm3dgs_slam_torch.ops.binning import build_bins, build_slots
from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.composite import slot_reduce_plain
from mm3dgs_slam_torch.ops.render import ActivatedGaussians, RenderSettings, project_for_pose
from mm3dgs_slam_torch.ops.sh import rgb_to_sh

from utils import random_scene, small_camera

torch.set_num_threads(1)
IDENTITY = np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)
U32 = 2.0 ** -24                    # float32 unit roundoff


def _sequential(rows: np.ndarray, pair_gauss: np.ndarray, n: int) -> np.ndarray:
    """dpacked [n, 16] by one float32 add per slot, the slots in ascending
    order: each Gaussian's accumulator starts at +0 and takes its slots'
    rows in the order they come."""
    out = np.zeros((n, 16), np.float32)
    nf = rows.shape[1]
    for s, g in enumerate(pair_gauss):
        out[g, :nf] += rows[s]
    return out


def _rows(rng, n_pairs: int, nc: int) -> np.ndarray:
    """[P, 6 + nc] float32 rows whose sums depend on the order of the adds:
    magnitudes over twelve decades, and zero rows (slots no pixel used) and
    negative zeros among them."""
    r = rng.standard_normal((n_pairs, 6 + nc)) * 10.0 ** rng.integers(-6, 6, (n_pairs, 6 + nc))
    r[rng.random(n_pairs) < 0.1] = 0.0
    r[rng.random((n_pairs, 6 + nc)) < 0.05] = -0.0
    return r.astype(np.float32)


def _bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.int32)


def _check_reduce(rows: np.ndarray, pair_gauss: np.ndarray, n: int):
    """The wrapper on CPU tensors, the plain reduce and the sequential loop:
    the same bits (signed zeros included), the columns past 6 + nc +0; no
    launch counted."""
    want = _sequential(rows, pair_gauss, n)
    tr, tp = torch.as_tensor(rows), torch.as_tensor(pair_gauss.astype(np.int32))
    slots = build_slots(tp, n)
    before = kernels.launch_counts()
    got = kernels.slot_reduce(tr, slots, n)
    assert kernels.launch_counts() == before
    plain = slot_reduce_plain(tr, slots, n)
    assert got.shape == plain.shape == (n, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(plain.numpy()), _bits(want))
    assert not _bits(want[:, rows.shape[1]:]).any()
    return want


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 80), n_pairs=st.integers(0, 300), heavy=st.integers(0, 600),
       empty=st.integers(0, 20), nc=st.sampled_from([3, 4]), seed=st.integers(0, 2 ** 32 - 1))
def test_slot_reduce_adds_each_gaussians_slots_in_order(n, n_pairs, heavy, empty, nc, seed):
    """A drawn table: `n_pairs` slots over the first n - `empty` Gaussians
    (the others have none), and one Gaussian with `heavy` more slots spread
    among them (several hundred: the long segments a large splat gives)."""
    rng = np.random.default_rng(seed)
    used = max(n - empty, 1)
    pair_gauss = np.concatenate([rng.integers(0, used, n_pairs),
                                 np.full(heavy, rng.integers(0, used))])
    pair_gauss = pair_gauss[rng.permutation(pair_gauss.shape[0])]
    want = _check_reduce(_rows(rng, pair_gauss.shape[0], nc), pair_gauss, n)
    counts = np.bincount(pair_gauss, minlength=n)
    assert not _bits(want[counts == 0]).any()


@functools.lru_cache(maxsize=None)
def _numpy_scene(n=600, h=64, w=96, f=80.0, seed=0):
    """A projected scene of n Gaussians drawn with numpy (no JAX) and its
    camera: splats of 1-6 pixels, some spanning tiles."""
    cam = Camera(h, w, f, f, w / 2 - 0.5, h / 2 - 0.5)
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 6.0, n)
    px, py = rng.uniform(-8, w + 8, n), rng.uniform(-8, h + 8, n)
    q = rng.normal(size=(n, 4))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    g = ActivatedGaussians(
        xyz=t(np.stack([(px - cam.cx) / f * z, (py - cam.cy) / f * z, z], -1)),
        scales=t(np.exp(rng.uniform(-4.5, -2.0, (n, 3)))),
        rotations=t(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        opacity=t(1 / (1 + np.exp(-2 * rng.normal(size=n)))),
        shs=rgb_to_sh(t(rng.uniform(size=(n, 3))))[:, None, :],
        alive=torch.ones(n, dtype=torch.bool))
    with torch.no_grad():
        return project_for_pose(g, torch.as_tensor(IDENTITY), RenderSettings(cam=cam)), cam


@pytest.mark.parametrize("world", [1, 2, 3])
@settings(max_examples=6, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(rank=st.integers(0, 2), nc=st.sampled_from([3, 4]), seed=st.integers(0, 2 ** 32 - 1))
def test_slot_reduce_of_a_tile_window(world, rank, nc, seed):
    """The slot table of each rank's window bins (`build_window_bins`, as the
    sharded map builds them): the window's Gaussians are a few of all N, the
    others get zero rows, as each rank's reduce writes all N rows."""
    from mm3dgs_slam_torch.parallel.mesh import Mesh
    from mm3dgs_slam_torch.parallel.tile_sharded import build_window_bins

    proj, cam = _numpy_scene()
    n = proj.packed.shape[0]
    wb = build_window_bins(proj, cam, Mesh(size=world, rank=rank % world, device=None,
                                           backend=None))
    pair_gauss = wb.pair_gauss.numpy()
    assert pair_gauss.shape[0] > 0
    assert world == 1 or np.unique(pair_gauss).shape[0] < n
    _check_reduce(_rows(np.random.default_rng(seed), pair_gauss.shape[0], nc), pair_gauss, n)


@pytest.mark.parametrize("nc", [3, 4])
def test_slot_reduce_against_jax_table_reduce(nc):
    """The same rows at each package's slots (JAX pads each tile's slab to
    CHUNK and reduces through its two-tier tables, `small_slots` /
    `big_slots`): the port's dpacked within 2 (k - 1) u sum |row| of JAX's
    for a Gaussian of k slots (either order within (k - 1) u sum |row| of the
    exact sum), equal where k <= 1, both zero past 6 + nc."""
    cam = small_camera(h=96, w=128, f=110.0)
    g = random_scene(jax.random.PRNGKey(5), 1500, cam, n_dead=10)
    jp = jproject(g, jnp.asarray(IDENTITY), JRS(cam=cam))
    jb = jbuild_bins(jp, cam, 1 << 16, 256, align=CHUNK)
    tcam = Camera(*cam)
    with torch.no_grad():
        tg = ActivatedGaussians(*(torch.as_tensor(np.array(x)) for x in g))
        proj = project_for_pose(tg, torch.as_tensor(IDENTITY), RenderSettings(cam=tcam))
    bins = build_bins(proj, tcam)
    n = proj.packed.shape[0]
    count = bins.tile_count.numpy()
    np.testing.assert_array_equal(count, np.asarray(jb.tile_count))
    slots = lambda start: np.concatenate(  # noqa: E731
        [start[t] + np.arange(count[t]) for t in range(len(count))])
    pslot, jslot = slots(bins.tile_start.numpy()), slots(np.asarray(jb.tile_start))
    pair_gauss = bins.pair_gauss.numpy()
    assert pslot.shape[0] == pair_gauss.shape[0]
    np.testing.assert_array_equal(pair_gauss[pslot], np.asarray(jb.pair_gauss)[jslot])
    rows = _rows(np.random.default_rng(nc), pair_gauss.shape[0], nc)
    dpair = np.zeros((16, int(jb.pair_gauss.shape[0])), np.float32)
    dpair[:6 + nc, jslot] = rows[pslot].T
    jd = np.asarray(_table_reduce(jnp.asarray(dpair), jb.small_slots, jb.big_slots,
                                  jb.big_gauss, jb.big_valid, jb.gauss_rank))
    pd = _check_reduce(rows, pair_gauss, n)
    k = np.bincount(pair_gauss, minlength=n)
    abs_sum = np.zeros((n, 16), np.float64)
    np.add.at(abs_sum, pair_gauss, np.pad(np.abs(rows.astype(np.float64)), ((0, 0), (0, 10 - nc))))
    bound = 2 * np.maximum(k - 1, 0)[:, None] * U32 * abs_sum * (1 + 1e-3)
    assert np.all(np.abs(pd.astype(np.float64) - jd) <= bound)
    np.testing.assert_array_equal(pd[k <= 1], jd[k <= 1])
    assert not jd[:, 6 + nc:].any() and (k > 2).sum() > 50
