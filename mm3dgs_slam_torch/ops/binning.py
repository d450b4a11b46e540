"""Tile binning: depth-sorted per-tile pair lists, sized exactly per frame
(JAX counterpart: ops/binning.py:233 `build_bins`).

  1. count the getRect tiles of every live Gaussian and expand one
     candidate (gaussian, tile) pair per covered tile,
  2. drop candidates that the exact alpha tight-cull proves are no-ops,
  3. one `torch.sort` on the key tile * N + depth_rank,
  4. per-tile segment bounds by `searchsorted` on the sorted keys.

A tile window (`tile_lo`, `n_local`: JAX `build_bins(..., tile_lo=,
n_local=)`) bins only the global tiles [tile_lo, tile_lo + n_local), with
window-local `tile_start`/`tile_count`; each tile's pair list is the one
the whole-image build gives, and tiles past the grid (the last window's
pad) are empty.

The buffers hold exactly the live pairs: no static caps, no overflow and
no alignment padding (those exist for the TPU's static shapes). Binning is
selection, not differentiated. Each build adds to three counters (spans.py):
`bins.builds`, `bins.candidate_pairs` (the rectangles' pairs before the
alpha cull) and `bins.pairs` (those kept); both sizes are the ones the build
reads back to the host for its exact buffers.

`build_slots` gives the mapping backward's slot table (JAX `small_slots` /
`big_slots` / `big_gauss`, binning.py:452-573, without their caps): each
Gaussian's indices into `pair_gauss` in ascending order, the order in which
kernel 2's reduce adds its per-slot gradient rows. Tracking never reads it,
so it is built apart from the bins, once per set of bins the mapping
backward uses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans
from .camera import TILE, Camera
from .projection import ProjectedGaussians


class TileBins(NamedTuple):
    pair_gauss: torch.Tensor  # [P] int32 gaussian row, (tile, depth)-sorted
    tile_start: torch.Tensor  # [n_local] int32 segment start into pair_gauss
    tile_count: torch.Tensor  # [n_local] int32 segment length


class SlotTable(NamedTuple):
    gauss_start: torch.Tensor  # [N + 1] int32 segment start into gauss_slot
    gauss_slot: torch.Tensor   # [P] int32 slots (indices into pair_gauss), by gaussian


@torch.no_grad()
def build_slots(pair_gauss: torch.Tensor, n: int) -> SlotTable:
    """The slots of every one of the n Gaussians, each Gaussian's ascending:
    gauss_slot[gauss_start[g]:gauss_start[g + 1]] are the indices where
    pair_gauss == g. Integer ops only (a stable sort and a searchsorted), so
    the table is the same on every build of the same bins."""
    key, slot = torch.sort(pair_gauss, stable=True)
    start = torch.searchsorted(key, torch.arange(n + 1, device=key.device, dtype=key.dtype))
    return SlotTable(gauss_start=start.to(torch.int32), gauss_slot=slot.to(torch.int32))


def gaussian_tile_rect(xy, radius, tiles_x: int, tiles_y: int):
    """Tile rect covered by each Gaussian (CUDA getRect semantics)."""
    r = radius.to(torch.float32)
    x0 = torch.clamp(torch.floor((xy[:, 0] - r) / TILE), 0, tiles_x).to(torch.int64)
    x1 = torch.clamp(torch.floor((xy[:, 0] + r + TILE - 1) / TILE), 0, tiles_x).to(torch.int64)
    y0 = torch.clamp(torch.floor((xy[:, 1] - r) / TILE), 0, tiles_y).to(torch.int64)
    y1 = torch.clamp(torch.floor((xy[:, 1] + r + TILE - 1) / TILE), 0, tiles_y).to(torch.int64)
    return x0, x1, y0, y1


def box_alpha_keep(x_lo, y_lo, w: int, h: int, xy, conic, tau) -> torch.Tensor:
    """True for candidate (gaussian, pixel box) pairs that may contribute:
    the box holds the w x h pixels from (x_lo, y_lo) on.

    With Q(d) = -power = 0.5*a*dx^2 + b*dx*dy + 0.5*c*dy^2 (convex), the
    exact minimum of Q over the box is the center (Q = 0) when it lies
    inside, else the minimum over one of the four edges, each a 1D convex
    quadratic with a closed-form clamped argmin. A pair whose min Q exceeds
    tau = log(255 * op) has alpha < 1/255 at every pixel of the box, which
    every compositor already skips; a small margin keeps pairs within
    floating-point reach of the bound. x_lo/y_lo/tau are per candidate, xy
    [M, 2] and conic [M, 3] are the candidates' Gaussian rows. The CUDA
    kernels apply the same test, op for op, to their warps' 8x4 boxes
    (csrc/composite_common.cuh `box_keep`)."""
    lx = x_lo - xy[:, 0]
    ly = y_lo - xy[:, 1]
    hx = lx + (w - 1.0)
    hy = ly + (h - 1.0)
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]

    def qval(x, y):
        return 0.5 * a * x * x + b * x * y + 0.5 * c * y * y

    def edge_x(ex):  # x = ex fixed, minimize over y in [ly, hy]
        ystar = torch.minimum(torch.maximum(-b * ex / torch.clamp(c, min=1e-12), ly), hy)
        return qval(ex, ystar)

    def edge_y(ey):
        xstar = torch.minimum(torch.maximum(-b * ey / torch.clamp(a, min=1e-12), lx), hx)
        return qval(xstar, ey)

    qmin = torch.minimum(torch.minimum(edge_x(lx), edge_x(hx)),
                         torch.minimum(edge_y(ly), edge_y(hy)))
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    mx = torch.maximum(torch.abs(lx), torch.abs(hx))
    my = torch.maximum(torch.abs(ly), torch.abs(hy))
    margin = 1e-3 + 1e-5 * (0.5 * a * mx * mx + torch.abs(b) * mx * my
                            + 0.5 * c * my * my)
    return qmin <= tau + margin


def alpha_tau(op) -> torch.Tensor:
    """tau = log(255 * op): alpha = op * exp(power) >= 1/255 needs -power <= tau."""
    return torch.log(torch.clamp(255.0 * op, min=1e-12))


def tile_alpha_keep(tx, ty, xy, conic, tau) -> torch.Tensor:
    """`box_alpha_keep` over whole 16x16 tiles (JAX `_tile_alpha_cull`,
    binning.py:101); tx/ty are tile indices."""
    return box_alpha_keep(tx.to(torch.float32) * float(TILE), ty.to(torch.float32) * float(TILE),
                          TILE, TILE, xy, conic, tau)


@torch.no_grad()
def build_bins(proj: ProjectedGaussians, cam: Camera, tile_lo: int = 0,
               n_local: int | None = None) -> TileBins:
    """Bin projected Gaussians into per-tile depth-sorted pair lists, over
    the whole grid or the window of `n_local` tiles from global tile
    `tile_lo` on."""
    if n_local is None:
        n_local = cam.n_tiles - tile_lo
    xy = proj.xy.detach()
    dev = xy.device
    n = xy.shape[0]
    op = proj.opacity.detach()
    # op < 1/255 can never pass the compositors' alpha >= 1/255 test
    radius = torch.where(op >= 1.0 / 255.0, proj.radius, torch.zeros_like(proj.radius))
    live = radius > 0
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(live, proj.depth.detach(), inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)

    x0, x1, y0, y1 = gaussian_tile_rect(xy, radius, cam.tiles_x, cam.tiles_y)
    # only the tile rows the window touches are expanded
    row_lo = tile_lo // cam.tiles_x
    row_hi = min((tile_lo + n_local - 1) // cam.tiles_x + 1, cam.tiles_y)
    y0, y1 = torch.clamp(y0, row_lo, row_hi), torch.clamp(y1, row_lo, row_hi)
    rect_w = torch.clamp(x1 - x0, min=0)
    count = torch.where(live, rect_w * torch.clamp(y1 - y0, min=0), torch.zeros_like(rect_w))
    gid = torch.repeat_interleave(torch.arange(n, device=dev), count)
    first = torch.cumsum(count, 0) - count
    d = torch.arange(gid.shape[0], device=dev) - first[gid]
    w = rect_w[gid]
    dy = torch.div(d, w, rounding_mode="floor")
    tx = x0[gid] + d - dy * w
    ty = y0[gid] + dy

    conic = proj.conic.detach()[gid]
    tau = alpha_tau(op[gid])
    tile = ty * cam.tiles_x + tx - tile_lo
    keep = tile_alpha_keep(tx, ty, xy[gid], conic, tau) & (tile >= 0) & (tile < n_local)
    spans.count("bins.candidate_pairs", gid.shape[0])
    gid, tile = gid[keep], tile[keep]
    spans.count("bins.builds")
    spans.count("bins.pairs", gid.shape[0])

    keys, perm = torch.sort(tile * n + rank[gid])
    bounds = torch.searchsorted(
        keys, torch.arange(n_local + 1, device=dev, dtype=torch.int64) * n)
    return TileBins(
        pair_gauss=gid[perm].to(torch.int32),
        tile_start=bounds[:-1].to(torch.int32),
        tile_count=(bounds[1:] - bounds[:-1]).to(torch.int32),
    )
