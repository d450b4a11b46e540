"""Tile-sharded compositing over the mesh (JAX counterpart:
parallel/tile_sharded.py).

The map stays row-sharded (projection, Adam, prune and growth run on each
rank's own rows); the projected rows of every rank are gathered
(sharded.replicate_proj), and each rank then bins and composites only its
window of ceil(n_tiles / W) tiles: window-local bins (`binning.build_bins`
with `tile_lo`/`n_local`) and the three kernels launched over the window
(`tile_lo + blockIdx.x`). So binning, the walk and both backwards split over
the ranks.

  * Mapping and every image render gather the window slabs into the whole
    tile grid on every rank (`gather_tiles`): SSIM crosses tile borders, so
    the loss needs the image. Every rank computes the same loss from the
    same image, so the backward of the gather is this rank's window of the
    cotangent; kernel 2 then gives the window's per-Gaussian partials over
    all gathered rows, which replicate_proj's backward sums over the ranks.
  * Tracking (`render_tiles_pose_sharded`) runs kernel 1 and kernel 3 over
    the window and sums the window's 12 partial sums over the ranks in one
    all-reduce before the quaternion VJP (JAX `_tps_bwd`); the tile slabs
    are gathered for the loss as in mapping, which keeps every tracking loss
    (L1, Pearson, splatam, the IMU prior) as it is.

Window bins are built once per rebin and reused across iterations, the
sharded counterpart of the bins cache (`build_window_bins`). The port's bins
hold no reverse slot tables, so tracking takes the same build (JAX's
`build_window_bins_pose` differs from `build_window_bins` only there).
"""
from __future__ import annotations

import torch

from .. import spans
from ..ops.binning import TileBins, build_bins
from ..ops.projection import ProjectedGaussians
from ..ops.render import (ActivatedGaussians, RenderSettings, background, composite_packed,
                          from_tiles, pack_pose_rows, project_for_pose, tiles_pose)
from .mesh import Mesh
from .sharded import gather_rows, replicate_proj


def build_window_bins(proj: ProjectedGaussians, cam, mesh: Mesh) -> TileBins:
    """This rank's window bins of the gathered projection `proj`."""
    lo, n_local = mesh.window(cam)
    return build_bins(proj, cam, lo, n_local)


class _GatherTiles(torch.autograd.Function):
    """[n_local, C, 256] window slab -> [n_tiles, C, 256] on every rank;
    backward: this rank's window of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, xw, mesh: Mesh, lo: int, n_tiles: int):
        n_local = xw.shape[0]
        buf = xw.new_zeros((mesh.size * n_local,) + tuple(xw.shape[1:]))
        buf[lo:lo + n_local] = xw
        mesh.all_reduce(buf)
        ctx.span = (lo, n_local, n_tiles)
        return buf[:n_tiles]

    @staticmethod
    def backward(ctx, g):
        lo, n_local, n_tiles = ctx.span
        gw = g.new_zeros((n_local,) + tuple(g.shape[1:]))
        k = max(min(n_tiles - lo, n_local), 0)
        gw[:k] = g[lo:lo + k]
        return gw, None, None, None


def gather_tiles(xw: torch.Tensor, mesh: Mesh, cam) -> torch.Tensor:
    """Every rank's window slab [n_local, C, 256] -> the tile grid
    [n_tiles, C, 256] (the pad past the grid dropped); differentiable. One
    process's window is the grid: `xw` itself."""
    if mesh.size == 1:
        return xw
    lo, _ = mesh.window(cam)
    return _GatherTiles.apply(xw, mesh, lo, cam.n_tiles)


def composite_tiles_sharded(proj: ProjectedGaussians, rs: RenderSettings, mesh: Mesh,
                            nc: int = 6, bins: TileBins | None = None) -> torch.Tensor:
    """The image [nc, H, W] of the gathered projection `proj`, background
    applied: this rank's window through kernel 1 (kernel 2 backward), the
    slabs gathered. `bins` are this rank's window bins (built inline when
    None, inside a `bins` span)."""
    cam = rs.cam
    if bins is None:
        with spans.span("bins"):
            bins = build_window_bins(proj, cam, mesh)
    lo, n_local = mesh.window(cam)
    acc, tfin = composite_packed(proj.packed, bins, cam, nc, lo, n_local)
    out = gather_tiles(acc + tfin * background(rs, acc.device)[:nc][None, :, None], mesh, cam)
    return from_tiles(out, cam)


def render_tiles_pose_sharded(g: ActivatedGaussians, q, T, rs: RenderSettings,
                              bins: TileBins, mesh: Mesh, nc: int = 6,
                              counts: list[int] | None = None) -> torch.Tensor:
    """The tile render [n_tiles, nc, 256] of the sharded map `g` (this
    rank's rows) at (q, T) with the fused pose backward: the rows packed
    with their pose Jacobians on each rank and gathered, kernel 1 and kernel
    3 over this rank's window (`bins`), the window's 12 partial sums summed
    over the ranks in rank order (the same dq, dT on every rank)."""
    packed32 = gather_rows(pack_pose_rows(g, q, T, rs), mesh, counts)
    lo, n_local = mesh.window(rs.cam)
    out_w = tiles_pose(q, T, packed32, bins, rs, nc, lo, n_local, mesh.sum_replicated)
    return gather_tiles(out_w, mesh, rs.cam)


@torch.no_grad()
def render_sharded(g: ActivatedGaussians, camera_pose, rs: RenderSettings, mesh: Mesh) -> dict:
    """`ops.render.render` of the sharded map: the reference's dict with the
    whole image on every rank; `radii` and `visibility_filter` are this
    rank's rows, `bins` its window bins, built inside a `bins` span with
    the projection. In one process it is `ops.render.render`, launch for
    launch."""
    with spans.span("bins"):
        proj = project_for_pose(g, camera_pose, rs)
        full = replicate_proj(proj, mesh)
        bins = build_window_bins(full, rs.cam, mesh)
    img6 = composite_tiles_sharded(full, rs, mesh, 6, bins)
    return {"render": img6[:3], "depth": img6[3:6], "radii": proj.radius,
            "visibility_filter": proj.radius > 0, "proj": proj, "bins": bins}
