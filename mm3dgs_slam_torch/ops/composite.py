"""Plain PyTorch versions of the three compositing kernels.

Each function computes what its CUDA kernel (`csrc/`) computes, with the
same per-pixel float32 arithmetic: vectorised over every tile's 256 pixels
at once, looping over depth rank. Tensors on the CPU take these (the tests
hold them against the JAX package); on the card the kernels are held
against them.

Semantics of the reference rasterizer (JAX counterparts: ops/oracle.py,
ops/pallas_composite.py): alpha = min(0.99, op * exp(power)), with the
clamp straight-through in the backward; a pixel skips a pair when
power > 0 or alpha < 1/255; it stops when T * (1 - alpha) < 1e-4, which
freezes T and drops that pair.

The backwards replay the walk front to back with a prefix accumulator
(JAX `_chunk_gradient`, pallas_composite.py:547): with
C = sum_j w_j f_j and A_j = sum_{k<=j} w_k (f_k . dC),

    dL/dalpha_j = T_j (f_j . dC) - ((C . dC) - A_j + dT_fin T_fin) / (1 - alpha_j).

The second term is a difference of two sums that cancel behind a
saturating layer, divided by up to 1 - 0.99, and the walk's thresholds
(alpha >= 1/255, the stop) switch a pair on or off on a last-bit change of
its alpha: on dense scenes two float32 evaluations in another order differ
beyond any per-value tolerance. Float64 inputs give the float64 evaluation
of the same formulas, which the card's tests hold both against.

Layouts: `packed` rows [N, ld] (ld = 16, or 32 with the pose-Jacobian
extension); acc channel-major [n_tiles, nc, 256]; tfin [n_tiles, 1, 256].

Each function also walks a tile window (`tile_lo`, `n_local`; JAX
`_composite_pallas_fwd(..., tile_lo, n_local)`): local tile t is global tile
t + tile_lo, the bins are window-local (`binning.build_bins` with the same
window) and the outputs have n_local rows; tiles past the grid (the last
window's pad) give acc 0, T 1 and zero gradients.

The kernels split a tile among 8 warps, each an 8x4 pixel box (warp w at
column w % 2, row w // 2 of the boxes), and a warp looks only at the pairs
that `binning.box_alpha_keep` keeps for its box; `composite_fwd_plain`'s
`count_work` counts that work the same way.

Kernel 2's plain version is its two passes: `composite_bwd_pairs_plain`
(a row per (tile, pair) slot) and `slot_reduce_plain` (each Gaussian's rows
added in ascending slot order, the kernel's order of adds).
"""
from __future__ import annotations

import torch

from .binning import SlotTable, alpha_tau, box_alpha_keep, build_slots
from .camera import PIX, TILE, Camera

BOX_W, BOX_H = 8, 4                       # a warp's pixel box
BOXES_X, N_BOXES = TILE // BOX_W, PIX // (BOX_W * BOX_H)


def _window(cam: Camera, tile_lo: int, n_local: int | None) -> int:
    return cam.n_tiles - tile_lo if n_local is None else n_local


def tile_pixel_coords(cam: Camera, device, tile_lo: int = 0, n_local: int | None = None):
    """[n_local, 256] float pixel x and y of every lane of the window's tiles."""
    t = tile_lo + torch.arange(_window(cam, tile_lo, n_local), device=device)[:, None]
    p = torch.arange(PIX, device=device)[None, :]
    px = ((t % cam.tiles_x) * TILE + p % TILE).to(torch.float32)
    py = ((t // cam.tiles_x) * TILE + p // TILE).to(torch.float32)
    return px, py


def _gather_rank(packed, pair_gauss, tile_start, tile_count, r):
    """Pair of depth rank r in every tile: (valid [T], g [T], row [T, ld])."""
    valid = tile_count > r
    idx = torch.where(valid, tile_start + r, torch.zeros_like(tile_start))
    g = pair_gauss[idx.long()].long()
    return valid, g, packed[g]


def _alpha(row, px, py, valid):
    dx = row[:, 0:1] - px
    dy = row[:, 1:2] - py
    c0, c1, c2 = row[:, 2:3], row[:, 3:4], row[:, 4:5]
    power = -0.5 * (c0 * dx * dx + c2 * dy * dy) - c1 * dx * dy
    expp = torch.exp(power)
    alpha = torch.clamp(row[:, 5:6] * expp, max=0.99)
    contribute = valid[:, None] & (power <= 0.0) & (alpha >= 1.0 / 255.0)
    return dx, dy, expp, alpha, contribute


def warp_box_origins(cam: Camera, device, tile_lo: int = 0, n_local: int | None = None):
    """[n_local, 8] float x and y of the first pixel of every warp's box."""
    t = tile_lo + torch.arange(_window(cam, tile_lo, n_local), device=device)[:, None]
    w = torch.arange(N_BOXES, device=device)[None, :]
    x = (t % cam.tiles_x) * TILE + (w % BOXES_X) * BOX_W
    y = (t // cam.tiles_x) * TILE + (w // BOXES_X) * BOX_H
    return x.to(torch.float32), y.to(torch.float32)


def per_box(flags):
    """[T, 256] pixel flags -> [T, 8] any per warp box."""
    t = flags.shape[0]
    rows = TILE // BOX_H
    return flags.view(t, rows, BOX_H, BOXES_X, BOX_W).any(4).any(2).reshape(t, N_BOXES)


WORK_KEYS = ("tested", "used", "stops", "pairs_used", "pairs_walked", "warp_pairs_min",
             "warp_pairs")


@torch.no_grad()
def composite_fwd_plain(packed, pair_gauss, tile_start, tile_count,
                        cam: Camera, nc: int, count_work: bool = False,
                        tile_lo: int = 0, n_local: int | None = None):
    """Kernel 1's plain version: (acc [T, nc, 256], tfin [T, 1, 256]).

    `count_work` also returns the work of the walk, a dict of ints:
    `tested`, the pixel-pairs a pixel evaluates before it stops; `used`,
    those it composites (neither skipped nor the stopping one); `stops`,
    the pixels that stop; `pairs_used`, the (tile, pair)s that at least one
    pixel of the tile composites; `pairs_walked`, the (tile, pair)s a block
    reaches before it ends at the first batch of 256 where all its pixels
    have stopped; `warp_pairs_min`, the (tile, pair, warp box)s in which a
    pixel uses or stops on the pair, the fewest an exact per-warp cull can
    walk; `warp_pairs`, the (tile, pair, warp box)s among the walked ones
    that `box_alpha_keep` keeps, which the kernels count in `work[0]`."""
    dev = packed.device
    px, py = tile_pixel_coords(cam, dev, tile_lo, n_local)
    n_tiles = px.shape[0]
    T = torch.ones((n_tiles, PIX), dtype=packed.dtype, device=dev)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=dev)
    acc = torch.zeros((n_tiles, nc, PIX), dtype=packed.dtype, device=dev)
    work = torch.zeros(len(WORK_KEYS), dtype=torch.int64, device=dev)
    if count_work:
        bx, by = (o.reshape(-1) for o in warp_box_origins(cam, dev, tile_lo, n_local))
    n_ranks = int(tile_count.max()) if n_tiles else 0
    for r in range(n_ranks):
        valid, g, row = _gather_rank(packed, pair_gauss, tile_start, tile_count, r)
        _, _, _, alpha, contribute = _alpha(row, px, py, valid)
        test_T = T * (1.0 - alpha)
        newly = contribute & ~done & (test_T < 1e-4)
        use = contribute & ~done & ~newly
        if count_work:
            if r % PIX == 0:   # a block ends at a batch boundary
                live = ~done.all(dim=1)
            walked = valid & live
            rows = row.repeat_interleave(N_BOXES, 0)
            kept = box_alpha_keep(bx, by, BOX_W, BOX_H, rows[:, 0:2], rows[:, 2:5],
                                  alpha_tau(rows[:, 5])).view(n_tiles, N_BOXES)
            work += torch.stack([
                (valid[:, None] & ~done).sum(), use.sum(), newly.sum(),
                use.any(dim=1).sum(), walked.sum(), per_box(use | newly).sum(),
                (kept & walked[:, None]).sum()])
        w = torch.where(use, alpha * T, torch.zeros_like(T))
        acc += w[:, None, :] * row[:, 6:6 + nc, None]
        T = torch.where(use, test_T, T)
        done |= newly
    if count_work:
        return acc, T[:, None, :], dict(zip(WORK_KEYS, work.tolist()))
    return acc, T[:, None, :]


def _replay(packed, pair_gauss, tile_start, tile_count, acc, tfin, dacc,
            dtfin, cam: Camera, nc: int, tile_lo: int, n_local: int | None):
    """The backward walk: per depth rank, yields (valid [T], g [T],
    row [T, ld], dx, dy, dpower, dop, w), the last four per pixel
    [T, 256]; dpower = dL/dpower and dop = dL/dop at each pixel."""
    dev = packed.device
    px, py = tile_pixel_coords(cam, dev, tile_lo, n_local)
    n_tiles = px.shape[0]
    cdc = torch.sum(acc * dacc, dim=1)               # (C . dC) per pixel
    tail = dtfin[:, 0] * tfin[:, 0]                  # dT_fin * T_fin
    T = torch.ones((n_tiles, PIX), dtype=packed.dtype, device=dev)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=dev)
    A = torch.zeros((n_tiles, PIX), dtype=packed.dtype, device=dev)
    zero = torch.zeros_like(T)
    n_ranks = int(tile_count.max()) if n_tiles else 0
    for r in range(n_ranks):
        valid, g, row = _gather_rank(packed, pair_gauss, tile_start, tile_count, r)
        dx, dy, expp, alpha, contribute = _alpha(row, px, py, valid)
        test_T = T * (1.0 - alpha)
        newly = contribute & ~done & (test_T < 1e-4)
        use = contribute & ~done & ~newly
        w = torch.where(use, alpha * T, zero)
        fdc = torch.sum(row[:, 6:6 + nc, None] * dacc, dim=1)
        A = A + w * fdc
        dalpha = T * fdc - (cdc - A + tail) / (1.0 - alpha)
        # the 0.99 clamp is straight-through: dalpha/dpower = op * exp(power)
        dop = torch.where(use, expp * dalpha, zero)
        yield valid, g, row, dx, dy, row[:, 5:6] * dop, dop, w
        T = torch.where(use, test_T, T)
        done |= newly


def _field_grads(row, dx, dy, dpower):
    """Per-pixel d(xy_x, xy_y, c0, c1, c2) of each rank's pair: [T, 5, 256]."""
    c0, c1, c2 = row[:, 2:3], row[:, 3:4], row[:, 4:5]
    return torch.stack([-(c0 * dx + c1 * dy) * dpower,
                        -(c2 * dy + c1 * dx) * dpower,
                        -0.5 * dx * dx * dpower,
                        -dx * dy * dpower,
                        -0.5 * dy * dy * dpower], 1)


@torch.no_grad()
def composite_bwd_pairs_plain(packed, pair_gauss, tile_start, tile_count, acc, tfin,
                              dacc, dtfin, cam: Camera, nc: int, tile_lo: int = 0,
                              n_local: int | None = None):
    """Kernel 2's first pass (JAX `_bwd_kernel`): the per-slot rows [P, 6 + nc],
    row s the gradient of (tile, pair) slot s's xy, conic, opacity and nc
    features, summed over the tile's pixels; exactly zero for a slot that
    no pixel uses."""
    rows = torch.zeros((pair_gauss.shape[0], 6 + nc), dtype=packed.dtype, device=packed.device)
    for r, (valid, g, row, dx, dy, dpower, dop, w) in enumerate(_replay(
            packed, pair_gauss, tile_start, tile_count, acc, tfin, dacc, dtfin,
            cam, nc, tile_lo, n_local)):
        dfeat = torch.sum(w[:, None, :] * dacc, dim=2)           # [T, nc]
        per_pair = torch.cat([torch.sum(_field_grads(row, dx, dy, dpower), 2),
                              torch.sum(dop, 1, keepdim=True), dfeat], dim=1)
        slot = (tile_start + r)[valid].long()
        rows[slot] = per_pair[valid]
    return rows


@torch.no_grad()
def slot_reduce_plain(rows, slots: SlotTable, n: int):
    """Kernel 2's second pass (JAX `_table_reduce`): dpacked [n, 16], row g
    the sum of its slots' rows in ascending slot order (0 + r_0 + r_1 + ...,
    the kernel's order); the columns past the rows' 6 + nc are exactly zero."""
    start, slot = slots.gauss_start.long(), slots.gauss_slot.long()
    count = start[1:] - start[:-1]
    out = torch.zeros((n, 16), dtype=rows.dtype, device=rows.device)
    nf = rows.shape[1]
    for j in range(int(count.max()) if n else 0):
        has = count > j
        out[has, :nf] += rows[slot[start[:-1][has] + j]]
    return out


@torch.no_grad()
def composite_bwd_plain(packed, pair_gauss, tile_start, tile_count, acc, tfin,
                        dacc, dtfin, cam: Camera, nc: int, tile_lo: int = 0,
                        n_local: int | None = None):
    """Kernel 2's plain version: dpacked [N, 16] (xy, conic, opacity and
    the nc walked feature columns; the others are exactly zero), the two
    passes in turn through the slot table of `binning.build_slots`."""
    rows = composite_bwd_pairs_plain(packed, pair_gauss, tile_start, tile_count, acc, tfin,
                                     dacc, dtfin, cam, nc, tile_lo, n_local)
    n = packed.shape[0]
    return slot_reduce_plain(rows, build_slots(pair_gauss, n), n)


@torch.no_grad()
def composite_pose_bwd_plain(packed32, pair_gauss, tile_start, tile_count, acc,
                             tfin, dacc, dtfin, cam: Camera, nc: int,
                             abs_sum: bool = False, tile_lo: int = 0,
                             n_local: int | None = None):
    """Kernel 3's plain version: per-tile pose-gradient partials [T, 12]:
    [sum dmean_cam (3) | sum dmean_cam (x) mean_world (9, row-major)].

    d(xy)/d(mean_cam) is rebuilt from the packed xy and z and the
    intrinsics (px = fx x/z + cx - 0.5, the half-pixel ndc2Pix convention);
    d(conic)/d(mean_cam) rides rows 16-24, the world mean rows 25-27
    (projection.conic_pose_jacobian_rows). Contracted per pixel-pair, as the
    kernel does. The partials cancel heavily, so float rounding in them
    scales with the sum of their terms' magnitudes: `abs_sum` also returns
    that sum, sum |term| over the tile's pixel-pairs [T, 12]."""
    fx, fy, bx, by = cam.fx, cam.fy, cam.cx - 0.5, cam.cy - 0.5
    psum = torch.zeros((_window(cam, tile_lo, n_local), 12), dtype=packed32.dtype,
                       device=packed32.device)
    asum = torch.zeros_like(psum)
    for valid, g, row, dx, dy, dpower, _dop, w in _replay(
            packed32, pair_gauss, tile_start, tile_count, acc, tfin, dacc, dtfin,
            cam, nc, tile_lo, n_local):
        dxy_x, dxy_y, dc0, dc1, dc2 = _field_grads(row, dx, dy, dpower).unbind(1)
        z = row[:, 9:10]
        dz = w * dacc[:, 3]
        if nc == 6:
            dz = dz + 2.0 * z * (w * dacc[:, 5])
        p_w = 1.0 / (z + 1e-7)
        jc = row[:, 16:25, None]
        dm_x = dxy_x * (fx * p_w) + dc0 * jc[:, 0] + dc1 * jc[:, 3] + dc2 * jc[:, 6]
        dm_y = dxy_y * (fy * p_w) + dc0 * jc[:, 1] + dc1 * jc[:, 4] + dc2 * jc[:, 7]
        dm_z = (dxy_x * (p_w * (bx - row[:, 0:1])) + dxy_y * (p_w * (by - row[:, 1:2]))
                + dc0 * jc[:, 2] + dc1 * jc[:, 5] + dc2 * jc[:, 8] + dz)
        dm = torch.stack([dm_x, dm_y, dm_z], 1)                   # [T, 3, 256]
        outer = (dm[:, :, None] * row[:, None, 25:28, None]).reshape(-1, 9, PIX)
        terms = torch.where(valid[:, None, None], torch.cat([dm, outer], 1), 0.0)
        psum += terms.sum(2)
        if abs_sum:
            asum += terms.abs().sum(2)
    return (psum, asum) if abs_sum else psum
