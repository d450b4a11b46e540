"""Differentiable render (JAX counterpart: ops/render.py; reference
slam/renderer.py).

One multi-channel composite gives the RGB pass and the [z, 1, z^2]
depth/silhouette pass together. Mirrored quirks of the reference's default
configs (pipeline.transform_means_python, TUM.yml:28 / UTMM.yml:31):

  * the mean transform to the camera frame runs here and the rasterizer
    sees w2c = I (renderer.py:117-118,142-153),
  * rotations are passed UNtransformed (renderer.py:152,171-175),
  * the camera position for SH view directions is the origin.

Both backwards are `torch.autograd.Function`s over the kernels in
`ops/kernels.py`: `composite_packed` (kernel 1 forward, kernel 2 backward)
differentiates the packed rows; `render_tiles_pose` (kernel 1 forward,
kernel 3 backward) differentiates only the pose. Both also walk a tile
window (`tile_lo`, `n_local`) for the tile-sharded render
(parallel/tile_sharded.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans
from . import kernels
from .binning import SlotTable, TileBins, build_bins
from .camera import PIX, TILE, Camera
from .pose import pose_to_w2c, quat_to_rotmat
from .projection import ProjectedGaussians, means_cam_soa, project_gaussians


class RenderSettings(NamedTuple):
    """Rasterization settings (hashable)."""

    cam: Camera
    sh_degree: int = 0
    transform_means_python: bool = True
    force_isotropic: bool = False
    # pipeline.compute_cov3D_python: its only observable effect in the
    # reference is bypassing force_isotropic (renderer.py:160-175)
    compute_cov3d_python: bool = False
    white_background: bool = False


class ActivatedGaussians(NamedTuple):
    """Post-activation Gaussian attributes (models/gaussians.py)."""

    xyz: torch.Tensor        # [N, 3]
    scales: torch.Tensor     # [N, 3] post-exp
    rotations: torch.Tensor  # [N, 4] post-normalize
    opacity: torch.Tensor    # [N] post-sigmoid
    shs: torch.Tensor        # [N, K, 3]
    alive: torch.Tensor      # [N] bool


def isotropic(rs: RenderSettings) -> bool:
    """force_isotropic tiles scale column 0 (renderer.py:167-168), unless
    compute_cov3D_python skips that branch."""
    return rs.force_isotropic and not rs.compute_cov3d_python


def effective_scales(scales, rs: RenderSettings):
    """The scales the projection sees (see `isotropic`)."""
    return scales[:, :1].expand(-1, 3) if isotropic(rs) else scales


def project_for_pose(g: ActivatedGaussians, camera_pose, rs: RenderSettings) -> ProjectedGaussians:
    """Project the map for a 7-vector w2c pose, honoring the transform mode."""
    scales = effective_scales(g.scales, rs)
    dev = g.xyz.device
    if rs.transform_means_python:
        means = means_cam_soa(g.xyz, camera_pose)
        w2c = torch.eye(4, dtype=torch.float32, device=dev)
        campos = torch.zeros(3, dtype=torch.float32, device=dev)
    else:
        means, w2c, campos = g.xyz, pose_to_w2c(camera_pose), None
    return project_gaussians(means, scales, g.rotations, g.opacity, g.shs,
                             g.alive, w2c, rs.cam, rs.sh_degree, campos)


def to_tiles(img, cam: Camera):
    """[C, H, W] (or [H, W]) -> channel-major tiles [n_tiles, C, 256]
    (or [n_tiles, 256]); the grid padding is zero."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[None]
    c = img.shape[0]
    ty, tx = cam.tiles_y, cam.tiles_x
    img = torch.nn.functional.pad(img, (0, tx * TILE - cam.width, 0, ty * TILE - cam.height))
    t = img.reshape(c, ty, TILE, tx, TILE).permute(1, 3, 0, 2, 4).reshape(ty * tx, c, PIX)
    return t[:, 0] if squeeze else t


def from_tiles(t, cam: Camera):
    """Channel-major tiles [n_tiles, C, 256] -> [C, H, W]."""
    ty, tx = cam.tiles_y, cam.tiles_x
    c = t.shape[1]
    img = t.reshape(ty, tx, c, TILE, TILE).permute(2, 0, 3, 1, 4)
    return img.reshape(c, ty * TILE, tx * TILE)[:, :cam.height, :cam.width]


def tile_pixel_valid(cam: Camera, device=None):
    """[n_tiles, 256] bool: True where the tile pixel lies inside the image."""
    t = torch.arange(cam.n_tiles, device=device)[:, None]
    p = torch.arange(PIX, device=device)[None, :]
    gy = (t // cam.tiles_x) * TILE + p // TILE
    gx = (t % cam.tiles_x) * TILE + p % TILE
    return (gy < cam.height) & (gx < cam.width)


def background(rs: RenderSettings, device=None, channels: int = 6):
    """Per-channel background; the reference reuses the RGB bg for the
    depth/silhouette pass (renderer.py:79-83,207-214)."""
    v = 1.0 if rs.white_background else 0.0
    return torch.full((channels,), v, dtype=torch.float32, device=device)


class _CompositePacked(torch.autograd.Function):
    """packed [N, 16] -> (acc, tfin) of a tile window; backward = kernel 2
    (dpacked) through the slot table `slots` (built in the backward when
    None)."""

    @staticmethod
    def forward(ctx, packed, pair_gauss, tile_start, tile_count, cam, nc, tile_lo, n_local,
                slots):
        packed = packed.contiguous()
        acc, tfin = kernels.composite_fwd(packed, pair_gauss, tile_start, tile_count, cam, nc,
                                          tile_lo=tile_lo, n_local=n_local)
        ctx.save_for_backward(packed, pair_gauss, tile_start, tile_count, acc, tfin)
        ctx.cam, ctx.nc, ctx.window, ctx.slots = cam, nc, (tile_lo, n_local), slots
        return acc, tfin

    @staticmethod
    def backward(ctx, dacc, dtfin):
        packed, pair_gauss, tile_start, tile_count, acc, tfin = ctx.saved_tensors
        dacc = torch.zeros_like(acc) if dacc is None else dacc.contiguous()
        dtfin = torch.zeros_like(tfin) if dtfin is None else dtfin.contiguous()
        tile_lo, n_local = ctx.window
        dpacked = kernels.composite_bwd(packed, pair_gauss, tile_start, tile_count,
                                        acc, tfin, dacc, dtfin, ctx.cam, ctx.nc,
                                        tile_lo=tile_lo, n_local=n_local, slots=ctx.slots)
        return dpacked, None, None, None, None, None, None, None, None


def composite_packed(packed, bins: TileBins, cam: Camera, nc: int, tile_lo: int = 0,
                     n_local: int | None = None, slots: SlotTable | None = None):
    """Differentiable composite of packed rows: (acc [T, nc, 256],
    tfin [T, 1, 256]) over the whole grid or a tile window (T = n_local,
    `bins` built for the same window), background not applied. `slots`,
    `binning.build_slots` of the bins, saves the backward building it."""
    return _CompositePacked.apply(packed, bins.pair_gauss, bins.tile_start,
                                  bins.tile_count, cam, nc, tile_lo, n_local, slots)


def render_tiles(g: ActivatedGaussians, camera_pose, rs: RenderSettings,
                 bins: TileBins, nc: int = 6):
    """Channel-major tile render [n_tiles, nc, 256] (a prefix of rgb, z,
    sil, z^2), background applied; differentiable through kernel 2."""
    proj = project_for_pose(g, camera_pose, rs)
    acc, tfin = composite_packed(proj.packed, bins, rs.cam, nc)
    return acc + tfin * background(rs, acc.device)[:nc][None, :, None]


class _TilesPose(torch.autograd.Function):
    """(q, T) -> channel-major tile render of a tile window; backward =
    kernel 3 (dq, dT). The map is frozen during tracking: only the pose gets
    gradients. The caller passes the rows packed at (q, T) with their
    pose-Jacobian columns, `packed32` [N, 32]: forward-mode AD does not run
    inside a Function's forward. `reduce` ([12] -> [12]) sums the window's
    12 partial sums over the windows of the other ranks (the sharded
    tracking path's one all-reduce), or is None."""

    @staticmethod
    def forward(ctx, q, T, packed32, bins, rs, nc, tile_lo, n_local, reduce):
        acc, tfin = kernels.composite_fwd(packed32, bins.pair_gauss, bins.tile_start,
                                          bins.tile_count, rs.cam, nc, tile_lo=tile_lo,
                                          n_local=n_local)
        ctx.save_for_backward(q, packed32, bins.pair_gauss, bins.tile_start,
                              bins.tile_count, acc, tfin)
        ctx.rs, ctx.nc, ctx.window, ctx.reduce = rs, nc, (tile_lo, n_local), reduce
        return acc + tfin * background(rs, acc.device)[:nc][None, :, None]

    @staticmethod
    def backward(ctx, d_out):
        q, packed32, pair_gauss, tile_start, tile_count, acc, tfin = ctx.saved_tensors
        rs, nc = ctx.rs, ctx.nc
        d_out = d_out.contiguous()
        bg = background(rs, d_out.device)[:nc]
        dtfin = torch.sum(d_out * bg[None, :, None], dim=1, keepdim=True)
        tile_lo, n_local = ctx.window
        psum = kernels.composite_pose_bwd(packed32, pair_gauss, tile_start, tile_count,
                                          acc, tfin, d_out, dtfin, rs.cam, nc,
                                          tile_lo=tile_lo, n_local=n_local)
        dq, dT = pose_grads_from_partials(psum, q, ctx.reduce)
        return dq, dT, None, None, None, None, None, None, None


def pose_grads_from_partials(psum, q, reduce=None):
    """Kernel 3's per-tile partials [T, 12] -> (dq, dT): dT = sum d(mean_cam);
    dq = the quaternion -> R VJP of M = sum d(mean_cam) (x) mean_world
    (= dL/dR, since mean_cam = R mean_world + T). `reduce` is applied to the
    [12] sums first (the other windows' share, under a mesh)."""
    s = psum.sum(0)
    if reduce is not None:
        s = reduce(s)
    with torch.enable_grad():
        qq = q.detach().requires_grad_(True)
        (dq,) = torch.autograd.grad(quat_to_rotmat(qq).reshape(9), qq, s[3:12])
    return dq, s[0:3]


@torch.no_grad()
def pack_pose_rows(g: ActivatedGaussians, q, T, rs: RenderSettings):
    """The rows kernels 1 and 3 read in tracking: packed [N, 16] at the pose
    (q, T) with the pose-Jacobian columns 16-31 appended, [N, 32]; kernel 4
    (`kernels.pose_rows`) on the card, `projection.pose_rows_plain` on the
    CPU."""
    if not (rs.transform_means_python and rs.sh_degree == 0):
        raise ValueError("fused pose gradients require transform_means_python "
                         "and sh_degree 0")
    g = ActivatedGaussians(*(t.detach() for t in g))
    return kernels.pose_rows(g, q.detach(), T.detach(), rs.cam, isotropic(rs))


def tiles_pose(q, T, packed32, bins: TileBins, rs: RenderSettings, nc: int,
               tile_lo: int = 0, n_local: int | None = None, reduce=None):
    """The fused-pose render of `pack_pose_rows`'s rows over the whole grid
    or a tile window; see _TilesPose."""
    return _TilesPose.apply(q, T, packed32, bins, rs, nc, tile_lo, n_local, reduce)


def render_tiles_pose(g: ActivatedGaussians, q, T, rs: RenderSettings,
                      bins: TileBins, nc: int = 6):
    """render_tiles with the fused pose backward (tracking): the same
    forward, and d/d(q, T) from kernel 3. Valid where every pose-dependent
    quantity flows through the camera-frame means: transform_means_python
    with sh_degree 0 (the shipped configs)."""
    return tiles_pose(q, T, pack_pose_rows(g, q, T, rs), bins, rs, nc)


def render(g: ActivatedGaussians, camera_pose, rs: RenderSettings, bins: TileBins | None = None):
    """Render the map from a pose: the reference's dict (``render`` [3, H, W],
    ``depth`` [3, H, W] = expected depth, silhouette, E[z^2], ``radii``,
    ``visibility_filter``) plus the projection and the bins used (built
    inside a `bins` span when None)."""
    if bins is None:
        with spans.span("bins"):
            proj = project_for_pose(g, camera_pose, rs)
            bins = build_bins(proj, rs.cam)
    else:
        proj = project_for_pose(g, camera_pose, rs)
    acc, tfin = composite_packed(proj.packed, bins, rs.cam, 6)
    img6 = from_tiles(acc + tfin * background(rs, acc.device)[None, :, None], rs.cam)
    return {
        "render": img6[:3],
        "depth": img6[3:6],
        "radii": proj.radius,
        "visibility_filter": proj.radius > 0,
        "proj": proj,
        "bins": bins,
    }
