"""The per-warp cull of kernels 1 and 2 (csrc/composite_common.cuh), held on
the CPU: `box_alpha_keep` over 16x16 tiles against JAX `_tile_alpha_cull`;
on random screen-space scenes, every pixel-pair a walk uses or stops on lies
in an 8x4 warp box the cull keeps; and `composite_fwd_plain`'s work counts
against a walk of each tile on its own.

`screen_scene` also gives `tests/test_torch_gpu.py` its hard scenes, so this
module imports JAX only inside the test that needs it."""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mm3dgs_slam_torch.ops import kernels
from mm3dgs_slam_torch.ops.binning import alpha_tau, box_alpha_keep, build_bins
from mm3dgs_slam_torch.ops.camera import PIX, Camera
from mm3dgs_slam_torch.ops.composite import (BOX_H, BOX_W, N_BOXES, composite_fwd_plain, per_box,
                                             tile_pixel_coords, warp_box_origins)
from mm3dgs_slam_torch.ops.projection import ProjectedGaussians

torch.set_num_threads(1)
KINDS = ("anisotropic", "saturating", "faint", "mixed")


def screen_scene(kind: str, seed: int, device="cpu", h=48, w=64, n=160):
    """Screen-space Gaussians drawn with numpy and binned for an h x w
    camera: (packed [n, 16], bins, cam). Kinds: `anisotropic`, long thin
    splats (sigma 6-25 px by 0.4-2 px) that span tiles; `saturating`,
    near-opaque layers (op 0.9-1) that stop pixels early and end blocks at
    a batch boundary; `faint`, opacities just above 1/255, whose alpha clears
    1/255 only near the center; `mixed`, all three."""
    rng = np.random.default_rng(seed)
    if kind == "saturating":
        h, w, n = 32, 32, 700        # > 256 pairs per tile
    cam = Camera(h, w, 50.0, 50.0, w / 2 - 0.5, h / 2 - 0.5)
    pick = {"anisotropic": 0, "saturating": 1, "faint": 2}
    k = rng.integers(0, 3, n) if kind == "mixed" else np.full(n, pick[kind])
    major = np.select([k == 0, k == 1], [rng.uniform(6, 25, n), rng.uniform(3, 12, n)],
                      rng.uniform(1, 10, n))
    minor = np.select([k == 0, k == 1], [rng.uniform(0.4, 2, n), rng.uniform(3, 12, n)],
                      rng.uniform(1, 10, n))
    op = np.select([k == 0, k == 1], [rng.uniform(0.05, 1, n), rng.uniform(0.9, 1, n)],
                   rng.uniform(1, 1.3, n) / 255)
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    rot = np.stack([np.stack([cs, -sn], -1), np.stack([sn, cs], -1)], -2)
    cov = rot @ (np.stack([major, minor], -1)[:, :, None] ** 2 * np.swapaxes(rot, 1, 2))
    inv = np.linalg.inv(cov)
    xy = np.stack([rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n)], -1)
    z = rng.uniform(1, 5, n)
    feat = np.concatenate([rng.uniform(size=(n, 3)), np.stack([z, np.ones(n), z * z], -1)], 1)
    packed = np.concatenate([xy, inv[:, 0, 0:1], inv[:, 0, 1:2], inv[:, 1, 1:2], op[:, None],
                             feat, np.zeros((n, 4))], 1)
    packed = torch.as_tensor(packed, dtype=torch.float32, device=device)
    radius = torch.as_tensor(np.ceil(3 * np.sqrt(np.linalg.eigvalsh(cov)[:, 1])),
                             dtype=torch.int32, device=device)
    proj = ProjectedGaussians(xy=packed[:, 0:2], depth=packed[:, 9], conic=packed[:, 2:5],
                              radius=radius, opacity=packed[:, 5], feat=packed[:, 6:12],
                              packed=packed)
    return packed, build_bins(proj, cam), cam


def walk_tiles(packed, bins, cam):
    """Each tile walked on its own with the reference rules, a block ending
    at the first batch of 256 pairs where all its pixels have stopped:
    [(tile, pair row, used [256], stopped [256])] for every walked pair."""
    px, py = tile_pixel_coords(cam, packed.device)
    out = []
    for t in range(cam.n_tiles):
        s, c = int(bins.tile_start[t]), int(bins.tile_count[t])
        T = torch.ones(PIX)
        done = torch.zeros(PIX, dtype=torch.bool)
        for r in range(c):
            if r % PIX == 0 and bool(done.all()):
                break
            row = packed[int(bins.pair_gauss[s + r])]
            dx, dy = row[0] - px[t], row[1] - py[t]
            power = -0.5 * (row[2] * dx * dx + row[4] * dy * dy) - row[3] * dx * dy
            alpha = torch.clamp(row[5] * torch.exp(power), max=0.99)
            hit = (power <= 0.0) & (alpha >= 1.0 / 255.0) & ~done
            test_T = T * (1.0 - alpha)
            stop = hit & (test_T < 1e-4)
            use = hit & ~stop
            out.append((t, row, use, stop))
            T = torch.where(use, test_T, T)
            done |= stop
    return out


def boxes_kept(cam, t, row):
    """[8] bool: box_alpha_keep of the pair's row for each warp box of tile t."""
    bx, by = warp_box_origins(cam, row.device)
    rows = row[None].expand(N_BOXES, -1)
    return box_alpha_keep(bx[t], by[t], BOX_W, BOX_H, rows[:, 0:2], rows[:, 2:5],
                          alpha_tau(rows[:, 5]))


def test_box_alpha_keep_16x16_matches_jax_tile_cull():
    from mm3dgs_slam_tpu.ops.binning import _tile_alpha_cull

    rng = np.random.default_rng(0)
    m, tiles_x, tiles_y = 4000, 10, 8
    tile = rng.integers(0, tiles_x * tiles_y, m).astype(np.int32)
    xy = np.stack([rng.uniform(-30, 16 * tiles_x + 30, m),
                   rng.uniform(-30, 16 * tiles_y + 30, m)], -1).astype(np.float32)
    s = np.exp(rng.uniform(np.log(0.3), np.log(40), (m, 2)))
    th = rng.uniform(0, np.pi, m)
    cs, sn = np.cos(th), np.sin(th)
    cov_xx = cs ** 2 * s[:, 0] ** 2 + sn ** 2 * s[:, 1] ** 2
    cov_yy = sn ** 2 * s[:, 0] ** 2 + cs ** 2 * s[:, 1] ** 2
    cov_xy = cs * sn * (s[:, 0] ** 2 - s[:, 1] ** 2)
    det = cov_xx * cov_yy - cov_xy ** 2
    conic = np.stack([cov_yy / det, -cov_xy / det, cov_xx / det], -1).astype(np.float32)
    tau = np.log(255 * rng.uniform(1 / 255, 1, m)).astype(np.float32)
    want = np.asarray(_tile_alpha_cull(tile[:, None], xy, conic, tau, tiles_x))[:, 0] >= 0
    t = torch.as_tensor(tile).long()
    got = box_alpha_keep((t % tiles_x).float() * 16, (t // tiles_x).float() * 16, 16, 16,
                         torch.as_tensor(xy), torch.as_tensor(conic), torch.as_tensor(tau))
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=6, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(KINDS), seed=st.integers(0, 2 ** 32 - 1))
def test_cull_keeps_every_used_or_stopping_pixel_pair(kind, seed):
    packed, bins, cam = screen_scene(kind, seed)
    missed = needed = 0
    for t, row, use, stop in walk_tiles(packed, bins, cam):
        need = per_box((use | stop)[None])[0]
        needed += int(need.sum())
        missed += int((need & ~boxes_kept(cam, t, row)).sum())
    assert needed > 0
    assert missed == 0


@pytest.mark.parametrize("kind", KINDS)
def test_work_counts_between_exact_minimum_and_no_cull(kind):
    packed, bins, cam = screen_scene(kind, 7)
    walked = walk_tiles(packed, bins, cam)
    least = sum(int(per_box((u | s)[None]).sum()) for _, _, u, s in walked)
    kept = sum(int(boxes_kept(cam, t, row).sum()) for t, row, _, _ in walked)
    _, _, work = composite_fwd_plain(packed, *bins, cam, 3, count_work=True)
    assert work["pairs_walked"] == len(walked)
    assert work["used"] == sum(int(u.sum()) for _, _, u, _ in walked)
    assert work["stops"] == sum(int(s.sum()) for _, _, _, s in walked)
    assert work["warp_pairs_min"] == least
    assert work["warp_pairs"] == kept
    assert least <= kept <= N_BOXES * len(walked)
    if kind == "saturating":   # blocks end at a batch boundary
        assert len(walked) < int(bins.tile_count.sum())
        assert kept < N_BOXES * len(walked)


def test_work_counter_is_the_cards_alone():
    """The CPU path has no cull to count: a work tensor there is refused."""
    packed, bins, cam = screen_scene("mixed", 1)
    work = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.composite_fwd(packed, *bins, cam, 3, work=work)
    acc, tfin = kernels.composite_fwd(packed, *bins, cam, 3)
    with pytest.raises(ValueError):
        kernels.composite_bwd(packed, *bins, acc, tfin, acc, tfin, cam, 3, work=work)
