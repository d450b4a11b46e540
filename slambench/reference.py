"""The benchmark's plain reference: one SLAM frame's arithmetic in plain
PyTorch, imported by nothing of the program and importing nothing of it.

Frozen copies, as of commit e88f4e05ce172d38c9780fabda9487fc7eec7bc7, of
the math the port implements:

  * pose math (mm3dgs_slam_torch/ops/pose.py: quat_to_rotmat, rotmat_to_quat,
    propagate_const_vel),
  * the EWA projection in transform_means_python mode
    (mm3dgs_slam_torch/ops/projection.py, ops/render.py project_for_pose),
  * the tile binning with its exact alpha cull (mm3dgs_slam_torch/ops/binning.py),
  * the front-to-back composite of the oracle (mm3dgs_slam_torch/ops/oracle.py):
    alpha = min(0.99, op exp(power)); a pixel skips a Gaussian where power > 0
    or alpha < 1/255 and stops where T (1 - alpha) < 1e-4. Here it is one
    vectorised pass per group of tiles, differentiable by autograd,
  * the losses (mm3dgs_slam_torch/ops/losses.py: masked mean, Pearson, SSIM),
  * tracking's Adam on (q, T) (mm3dgs_slam_torch/slam/tracker.py),
  * the mapping iteration: loss, densification stats, prune, map Adam
    (mm3dgs_slam_torch/slam/map_opt.py, models/gaussians.py),
  * bundle adjustment, written from the reference's description
    (slam/mapper.py:749-788, 930-942 of MM3DGS-SLAM): the window's poses a
    gradient leaf stepped by their own Adam, and the covisibility mask of
    the rows the map step moves (ba_mask),
  * frame 0's new Gaussians (mm3dgs_slam_torch/slam/map_ops.py
    new_gaussian_candidates, first frame).

Every function takes a compute dtype: float32 is the reference, bfloat16
the control (the render and the losses in bfloat16, the parameters and the
optimizer state in float32).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
PIX = TILE * TILE
SH_C0 = 0.28209479177387814
# pair-slots (tile x padded pair) per vectorised group of tiles: each slot
# holds 256 pixel values, so a group's tensors are 64 Mi elements at most
GROUP_SLOTS = 1 << 18


class Cam(NamedTuple):
    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def tiles_x(self) -> int:
        return math.ceil(self.width / TILE)

    @property
    def tiles_y(self) -> int:
        return math.ceil(self.height / TILE)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


# -- pose math ---------------------------------------------------------------

def quat_to_rotmat(q):
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def rotmat_to_quat(m):
    """Rotation matrix [3, 3] -> wxyz quaternion, best-conditioned branch."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.reshape(9).unbind(-1)
    t = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                     1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22])
    q_abs = torch.where(t > 0, torch.sqrt(torch.where(t > 0, t, torch.ones_like(t))),
                        torch.zeros_like(t))
    cand = torch.stack([
        torch.stack([q_abs[0] ** 2, m21 - m12, m02 - m20, m10 - m01]),
        torch.stack([m21 - m12, q_abs[1] ** 2, m10 + m01, m02 + m20]),
        torch.stack([m02 - m20, m10 + m01, q_abs[2] ** 2, m12 + m21]),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[3] ** 2]),
    ]) / (2.0 * torch.clamp(q_abs[:, None], min=0.1))
    return cand[int(torch.argmax(q_abs))]


def w2c_to_pose(w2c):
    return torch.cat([rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3]])


def pose_to_w2c(pose):
    top = torch.cat([quat_to_rotmat(pose[:4]), pose[4:, None]], dim=1)
    return torch.cat([top, pose.new_tensor([[0.0, 0.0, 0.0, 1.0]])], dim=0)


def invert_rigid(m):
    """[R t; 0 1] -> [R^T, -R^T t; 0 1]."""
    rt = m[:3, :3].T
    top = torch.cat([rt, -(rt @ m[:3, 3:])], dim=1)
    return torch.cat([top, m[3:]], dim=0)


def seed_pose(prev: list, model, dtype):
    """The motion model's seed for a frame from the poses tracked before it
    ([7] each, the last first): the constant-velocity model (delta =
    w2c[-1] inv(w2c[-2]), seed = delta w2c[-1]) where two are there, else
    the last pose. Returned as its w2c [4, 4]."""
    ws = [pose_to_w2c(torch.as_tensor(p).to(dtype)) for p in prev]
    if model == "const_velocity" and len(ws) >= 2:
        return ws[0] @ invert_rigid(ws[1]) @ ws[0]
    if model in (None, "", "none", "const_velocity"):
        return ws[0]
    raise ValueError(f"the reference has no motion model {model!r}")


# -- projection ----------------------------------------------------------------

class Gaussians(NamedTuple):
    """Activated Gaussians: xyz [N, 3], scales [N, 3], rotations [N, 4]
    (unit wxyz), opacity [N], rgb [N, 3] (the degree-0 colour after the +0.5
    offset and the clamp at 0)."""

    xyz: torch.Tensor
    scales: torch.Tensor
    rotations: torch.Tensor
    opacity: torch.Tensor
    rgb: torch.Tensor


class Projected(NamedTuple):
    xy: torch.Tensor      # [N, 2]
    conic: torch.Tensor   # [N, 3]
    opacity: torch.Tensor  # [N]
    feat: torch.Tensor    # [N, 6]: r, g, b, z, 1, z^2
    depth: torch.Tensor   # [N]
    radius: torch.Tensor  # [N] int64, 0 where culled


def activate(xyz, features_dc, scaling, rotation, opacity_logit) -> Gaussians:
    """A map's leaves (pre-activation) -> Gaussians, sh degree 0."""
    rot = rotation / torch.clamp(torch.linalg.norm(rotation, dim=-1, keepdim=True), min=1e-12)
    rgb = torch.clamp(SH_C0 * features_dc.reshape(-1, 3) + 0.5, min=0.0)
    return Gaussians(xyz, torch.exp(scaling), rot, torch.sigmoid(opacity_logit.reshape(-1)), rgb)


def project(g: Gaussians, pose, cam: Cam, force_isotropic: bool = False) -> Projected:
    """The map seen from the w2c pose [7]: means moved to the camera frame,
    rotations left as they are, the w2c of the projection the identity."""
    R = quat_to_rotmat(pose[:4])
    m = g.xyz @ R.T + pose[4:]
    tx, ty, tz = m[:, 0], m[:, 1], m[:, 2]
    W, H = cam.width, cam.height
    p00, p02 = 2 * cam.fx / W, -(W - 2 * cam.cx) / W
    p11, p12 = 2 * cam.fy / H, -(H - 2 * cam.cy) / H
    p_w = 1.0 / (tz + 1e-7)
    px = (((tx * p00 + tz * p02) * p_w + 1.0) * W - 1.0) * 0.5
    py = (((ty * p11 + tz * p12) * p_w + 1.0) * H - 1.0) * 0.5

    s = g.scales[:, :1].expand(-1, 3) if force_isotropic else g.scales
    q = g.rotations / torch.clamp(torch.sqrt(torch.sum(g.rotations ** 2, -1, keepdim=True)),
                                  min=1e-12)
    Rg = quat_to_rotmat(q)                       # [N, 3, 3]
    cov = Rg @ torch.diag_embed(s * s) @ Rg.transpose(1, 2)
    in_front = tz > 0.2
    limx, limy = 1.3 * W / (2.0 * cam.fx), 1.3 * H / (2.0 * cam.fy)
    tz_s = torch.where(in_front, tz, torch.ones_like(tz))
    cx_ = torch.clamp(tx / tz_s, -limx, limx) * tz_s
    cy_ = torch.clamp(ty / tz_s, -limy, limy) * tz_s
    J = torch.stack([
        torch.stack([cam.fx / tz_s, torch.zeros_like(tz), -cam.fx * cx_ / (tz_s * tz_s)], -1),
        torch.stack([torch.zeros_like(tz), cam.fy / tz_s, -cam.fy * cy_ / (tz_s * tz_s)], -1),
    ], dim=1)
    c2 = J @ cov @ J.transpose(1, 2)
    c00, c01, c11 = c2[:, 0, 0] + 0.3, c2[:, 0, 1], c2[:, 1, 1] + 0.3
    det = c00 * c11 - c01 * c01
    det_ok = det != 0.0
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_s, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    radius = torch.where(in_front & det_ok, radius, torch.zeros_like(radius)).to(torch.int64)
    conic = torch.stack([c11 / det_s, -c01 / det_s, c00 / det_s], -1)
    feat = torch.cat([g.rgb, tz[:, None], torch.ones_like(tz)[:, None], (tz * tz)[:, None]], 1)
    return Projected(torch.stack([px, py], -1), conic, g.opacity, feat, tz, radius)


# -- binning -----------------------------------------------------------------

class Bins(NamedTuple):
    pair_gauss: torch.Tensor  # [P] int64, sorted by (tile, depth rank)
    tile_start: torch.Tensor  # [T]
    tile_count: torch.Tensor  # [T]


def _box_keep(x_lo, y_lo, w, h, xy, conic, tau):
    lx, ly = x_lo - xy[:, 0], y_lo - xy[:, 1]
    hx, hy = lx + (w - 1.0), ly + (h - 1.0)
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]

    def qv(x, y):
        return 0.5 * a * x * x + b * x * y + 0.5 * c * y * y

    def ex(e):
        return qv(e, torch.minimum(torch.maximum(-b * e / torch.clamp(c, min=1e-12), ly), hy))

    def ey(e):
        return qv(torch.minimum(torch.maximum(-b * e / torch.clamp(a, min=1e-12), lx), hx), e)

    qmin = torch.minimum(torch.minimum(ex(lx), ex(hx)), torch.minimum(ey(ly), ey(hy)))
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    mx = torch.maximum(lx.abs(), hx.abs())
    my = torch.maximum(ly.abs(), hy.abs())
    margin = 1e-3 + 1e-5 * (0.5 * a * mx * mx + b.abs() * mx * my + 0.5 * c * my * my)
    return qmin <= tau + margin


@torch.no_grad()
def build_bins(p: Projected, cam: Cam) -> Bins:
    """Depth-sorted pair lists of the tiles each Gaussian's 3-sigma rect
    covers, less the pairs whose alpha is under 1/255 on the whole tile."""
    xy = p.xy.detach().float()
    conic = p.conic.detach().float()
    op = p.opacity.detach().float()
    n = xy.shape[0]
    dev = xy.device
    radius = torch.where(op >= 1.0 / 255.0, p.radius, torch.zeros_like(p.radius))
    live = radius > 0
    order = torch.argsort(torch.where(live, p.depth.detach().float(),
                                      torch.full_like(op, float("inf"))), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    r = radius.float()
    x0 = torch.clamp(torch.floor((xy[:, 0] - r) / TILE), 0, cam.tiles_x).long()
    x1 = torch.clamp(torch.floor((xy[:, 0] + r + TILE - 1) / TILE), 0, cam.tiles_x).long()
    y0 = torch.clamp(torch.floor((xy[:, 1] - r) / TILE), 0, cam.tiles_y).long()
    y1 = torch.clamp(torch.floor((xy[:, 1] + r + TILE - 1) / TILE), 0, cam.tiles_y).long()
    w = torch.clamp(x1 - x0, min=0)
    count = torch.where(live, w * torch.clamp(y1 - y0, min=0), torch.zeros_like(w))
    gid = torch.repeat_interleave(torch.arange(n, device=dev), count)
    d = torch.arange(gid.shape[0], device=dev) - (torch.cumsum(count, 0) - count)[gid]
    dy = torch.div(d, w[gid], rounding_mode="floor")
    tx, ty = x0[gid] + d - dy * w[gid], y0[gid] + dy
    tau = torch.log(torch.clamp(255.0 * op[gid], min=1e-12))
    keep = _box_keep(tx.float() * TILE, ty.float() * TILE, TILE, TILE, xy[gid], conic[gid], tau)
    gid, tile = gid[keep], (ty * cam.tiles_x + tx)[keep]
    keys, perm = torch.sort(tile * n + rank[gid])
    bounds = torch.searchsorted(keys, torch.arange(cam.n_tiles + 1, device=dev) * n)
    return Bins(gid[perm], bounds[:-1], bounds[1:] - bounds[:-1])


# -- composite ---------------------------------------------------------------

class Groups(NamedTuple):
    """The bins' tiles in groups of like pair counts, each padded to its
    longest: per group (tile ids [t], gauss ids [t, K], valid [t, K])."""

    groups: list
    inverse: torch.Tensor  # [T]: position of each tile in the groups' order


@torch.no_grad()
def group_tiles(bins: Bins, cam: Cam) -> Groups:
    counts = bins.tile_count
    order = torch.argsort(counts, descending=True, stable=True)
    cnt = counts[order].tolist()
    groups, i, T = [], 0, len(cnt)
    starts = bins.tile_start[order]
    while i < T:
        k = max(cnt[i], 1)
        j = min(T, i + max(GROUP_SLOTS // k, 1))
        tiles = order[i:j]
        ar = torch.arange(k, device=counts.device)
        valid = ar[None, :] < counts[tiles][:, None]
        n_pairs = bins.pair_gauss.numel()
        idx = torch.clamp(starts[i:j][:, None] + ar[None, :], max=max(n_pairs - 1, 0))
        gid = bins.pair_gauss[idx] if n_pairs else torch.zeros_like(idx)
        groups.append((tiles, torch.where(valid, gid, torch.zeros_like(gid)), valid))
        i = j
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    return Groups(groups, inverse)


def _pixels(tiles, cam: Cam, dtype):
    p = torch.arange(PIX, device=tiles.device)
    gx = (tiles % cam.tiles_x)[:, None] * TILE + (p % TILE)[None, :]
    gy = (tiles // cam.tiles_x)[:, None] * TILE + (p // TILE)[None, :]
    return gx.to(dtype)[:, None, :], gy.to(dtype)[:, None, :]   # [t, 1, 256]


def _walk(xy, conic, op, gid, valid, px, py):
    """Per (tile, pair, pixel): alpha where the pixel composites the pair,
    whether it uses it, the inclusive transmittance and whether the pixel
    tests it. The offsets from the centre are taken in xy's dtype (float32),
    the rest in conic's."""
    gx, gy = xy[gid, 0][..., None], xy[gid, 1][..., None]
    a, b, c = (conic[gid, k][..., None] for k in range(3))
    dx, dy = (gx - px).to(conic.dtype), (gy - py).to(conic.dtype)
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(op[gid][..., None] * torch.exp(power), max=0.99)
    contribute = valid[..., None] & (power <= 0) & (alpha >= 1.0 / 255.0)
    alpha = torch.where(contribute, alpha, torch.zeros_like(alpha))
    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    use = contribute & (t_incl >= 1e-4)
    return alpha, use, t_incl, contribute


def _composite_group(xy, conic, op, feat, gid, valid, px, py):
    alpha, use, t_incl, _ = _walk(xy, conic, op, gid, valid, px, py)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    w = torch.where(use, alpha * t_excl, torch.zeros_like(alpha))      # [t, K, 256]
    acc = torch.einsum("tkp,tkc->tcp", w, feat[gid])                   # [t, C, 256]
    tfin = torch.prod(torch.where(use, 1.0 - alpha, torch.ones_like(alpha)), dim=1)
    return acc, tfin


def composite(p: Projected, groups: Groups, cam: Cam, nc: int, dtype):
    """Tile layout (acc [T, nc, 256], tfin [T, 256]) of the projected rows
    over the bins' pairs, black background: the pixel offsets in float32
    (float64 for a float64 `dtype`), the per-pixel arithmetic in `dtype`."""
    xy = p.xy.to(param_dtype(dtype))
    conic, op = p.conic.to(dtype), p.opacity.to(dtype)
    feat = p.feat[:, :nc].to(dtype)
    accs, tfins = [], []
    for tiles, gid, valid in groups.groups:
        px, py = _pixels(tiles, cam, xy.dtype)
        if torch.is_grad_enabled():
            acc, tfin = checkpoint(_composite_group, xy, conic, op, feat, gid, valid, px, py,
                                   use_reentrant=False)
        else:
            acc, tfin = _composite_group(xy, conic, op, feat, gid, valid, px, py)
        accs.append(acc)
        tfins.append(tfin)
    acc = torch.cat(accs)[groups.inverse]
    tfin = torch.cat(tfins)[groups.inverse]
    return acc, tfin


@torch.no_grad()
def walk_counts(xy, conic, op, bins: Bins, cam: Cam) -> dict:
    """What a launch over these rows and bins has to do, from its inputs:
    pixel-pairs used, pixel-pairs a pixel stops on, (tile, pair)s some pixel
    uses, Gaussians in some pair, pairs, tiles."""
    xy, conic, op = xy.float(), conic.float(), op.float()
    groups = group_tiles(bins, cam)
    used = stops = pairs_used = 0
    for tiles, gid, valid in groups.groups:
        px, py = _pixels(tiles, cam, torch.float32)
        _, use, t_incl, contribute = _walk(xy, conic, op, gid, valid, px, py)
        t_prev = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
        used += int(use.sum())
        stops += int((contribute & (t_incl < 1e-4) & (t_prev >= 1e-4)).sum())
        pairs_used += int(use.any(dim=2).sum())
    n_seen = int(torch.unique(bins.pair_gauss).numel())
    return dict(used=used, stops=stops, pairs_used=pairs_used, n_seen=n_seen,
                n_pairs=int(bins.pair_gauss.numel()), n_tiles=cam.n_tiles)


def to_tiles(img, cam: Cam):
    """[C, H, W] or [H, W] -> [T, C, 256] or [T, 256], zero padded."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[None]
    c, ty, tx = img.shape[0], cam.tiles_y, cam.tiles_x
    img = torch.nn.functional.pad(img, (0, tx * TILE - cam.width, 0, ty * TILE - cam.height))
    t = img.reshape(c, ty, TILE, tx, TILE).permute(1, 3, 0, 2, 4).reshape(ty * tx, c, PIX)
    return t[:, 0] if squeeze else t


def from_tiles(t, cam: Cam):
    c = t.shape[1]
    img = t.reshape(cam.tiles_y, cam.tiles_x, c, TILE, TILE).permute(2, 0, 3, 1, 4)
    return img.reshape(c, cam.tiles_y * TILE, cam.tiles_x * TILE)[:, :cam.height, :cam.width]


def pixel_valid(cam: Cam, device):
    t = torch.arange(cam.n_tiles, device=device)[:, None]
    p = torch.arange(PIX, device=device)[None, :]
    return (((t // cam.tiles_x) * TILE + p // TILE) < cam.height) & \
        (((t % cam.tiles_x) * TILE + p % TILE) < cam.width)


def render_image(g: Gaussians, pose, cam: Cam, dtype, nc: int = 6):
    """[nc, H, W] of a whole render at pose (black background)."""
    p = project(g, pose, cam)
    acc, _ = composite(p, group_tiles(build_bins(p, cam), cam), cam, nc, dtype)
    return from_tiles(acc, cam)


# -- losses ------------------------------------------------------------------

def masked_mean(x, mask):
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1e-12)


def pearson_corrcoef(x, y, mask):
    x, y = x.reshape(-1), y.reshape(-1)
    w = mask.reshape(-1).to(x.dtype)
    n = torch.clamp(torch.sum(w), min=1e-12)
    dx = (x - torch.sum(x * w) / n) * w
    dy = (y - torch.sum(y * w) / n) * w
    return torch.sum(dx * dy) / torch.sqrt(torch.clamp(torch.sum(dx * dx) * torch.sum(dy * dy),
                                                       min=1e-24))


def pearson_loss(render, estimate, mask, invert_estimate: bool):
    if invert_estimate:
        return torch.minimum(1.0 - pearson_corrcoef(-estimate, render, mask),
                             1.0 - pearson_corrcoef(1.0 / (estimate + 200.0), render, mask))
    return 1.0 - pearson_corrcoef(estimate, render, mask)


def ssim(img1, img2, window_size: int = 11):
    """11x11 Gaussian-window SSIM (sigma 1.5), zero padded, as two banded
    matrix products per filter."""
    dt, dev = img1.dtype, img1.device
    xs = torch.arange(window_size, dtype=dt, device=dev)
    gw = torch.exp(-((xs - window_size // 2) ** 2) / (2.0 * 1.5 ** 2))
    gw = gw / torch.sum(gw)
    half = window_size // 2

    def banded(n):
        i = torch.arange(n, device=dev)[:, None]
        j = torch.arange(n, device=dev)[None, :]
        d = i - j + half
        return torch.where((d >= 0) & (d <= 2 * half), gw[torch.clamp(d, 0, 2 * half)],
                           torch.zeros((), dtype=dt, device=dev))

    bw, bh = banded(img1.shape[2]), banded(img1.shape[1])

    def conv(x):
        return torch.matmul(bh.T, torch.matmul(x, bw))

    mu1, mu2 = conv(img1), conv(img2)
    s1 = conv(img1 * img1) - mu1 ** 2
    s2 = conv(img2 * img2) - mu2 ** 2
    s12 = conv(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                      / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2)))


# -- tracking ----------------------------------------------------------------

class TrackSpec(NamedTuple):
    iters: int
    rebin_every: int
    position_lr: float
    rotation_lr: float
    use_depth_loss: bool       # tracking.use_depth_estimate_loss with GT depth
    pearson_weight: float
    force_isotropic: bool


def _track_loss(g: Gaussians, q, T, groups, gt_c, gt_d, valid, cam: Cam, ts: TrackSpec,
                dtype):
    p = project(g, torch.cat([q, T]), cam, ts.force_isotropic)
    acc, _ = composite(p, groups, cam, 5, dtype)
    image, depth, sil = acc[:, :3], acc[:, 3], acc[:, 4]
    presence = (sil > 0.99) & valid
    loss = masked_mean(torch.abs(image - gt_c), presence[:, None])
    if ts.use_depth_loss:
        loss = loss + ts.pearson_weight * pearson_loss(
            depth, gt_d, presence & (gt_d > 0), invert_estimate=True)
    return loss


def param_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def track(g: Gaussians, seed_pose, gt_color, gt_depth, cam: Cam, ts: TrackSpec, dtype,
          n_record: int = 4) -> dict:
    """Adam on the pose [7] from `seed_pose` for ts.iters steps against the
    frozen map `g`, as the tracker does (L1 over the pixels whose silhouette
    passes 0.99, optionally the Pearson depth term; bins rebuilt every
    ts.rebin_every steps at the pose then). Returns the last pose, and the
    poses and losses of the first `n_record` iterations (the pose before
    each iteration's step)."""
    pdt = param_dtype(dtype)
    gt_c = to_tiles(gt_color, cam).to(dtype)
    gt_d = to_tiles(gt_depth, cam).to(dtype)
    valid = pixel_valid(cam, gt_color.device)
    q, T = seed_pose[:4].to(pdt).clone(), seed_pose[4:].to(pdt).clone()
    mq, vq, mT, vT = (torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(T),
                      torch.zeros_like(T))
    groups, poses, losses = None, [], []
    for i in range(ts.iters):
        if i % max(ts.rebin_every, 1) == 0:
            with torch.no_grad():
                p = project(g, torch.cat([q, T]), cam, ts.force_isotropic)
                groups = group_tiles(build_bins(p, cam), cam)
        qv, Tv = q.detach().requires_grad_(True), T.detach().requires_grad_(True)
        loss = _track_loss(g, qv, Tv, groups, gt_c, gt_d, valid, cam, ts, dtype)
        gq, gT = torch.autograd.grad(loss.to(pdt), (qv, Tv))
        if i < n_record:
            poses.append(torch.cat([q, T]).detach().cpu())
            losses.append(float(loss.detach()))
        with torch.no_grad():
            step = i + 1
            bc1, bc2 = 1.0 - 0.9 ** step, (1.0 - 0.999 ** step) ** 0.5
            mq = 0.9 * mq + 0.1 * gq
            vq = 0.999 * vq + 0.001 * gq * gq
            q = q - ts.rotation_lr * (mq / bc1) / (torch.sqrt(vq) / bc2 + 1e-8)
            mT = 0.9 * mT + 0.1 * gT
            vT = 0.999 * vT + 0.001 * gT * gT
            T = T - ts.position_lr * (mT / bc1) / (torch.sqrt(vT) / bc2 + 1e-8)
    return dict(pose=torch.cat([q, T]).detach().cpu(), poses=poses, losses=losses)


@torch.no_grad()
def track_loss_at(g: Gaussians, pose, gt_color, gt_depth, cam: Cam, ts: TrackSpec, dtype):
    """Tracking's loss at `pose` [7], with bins built there."""
    pose = pose.to(device=g.xyz.device, dtype=param_dtype(dtype))
    groups = group_tiles(build_bins(project(g, pose, cam, ts.force_isotropic), cam), cam)
    return float(_track_loss(g, pose[:4], pose[4:], groups, to_tiles(gt_color, cam).to(dtype),
                             to_tiles(gt_depth, cam).to(dtype), pixel_valid(cam, g.xyz.device),
                             cam, ts, dtype))


# -- mapping -----------------------------------------------------------------

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "rgb")


class MapSpec(NamedTuple):
    lambda_dssim: float
    use_depth_loss: bool       # mapping.use_depth_estimate_loss with GT depth
    pearson_weight: float
    min_opacity: float
    size_threshold: float | None
    pruning_interval: int
    densify_from_iter: int
    densify_until_iter: int
    rebin_every: int
    lrs: dict                  # leaf -> learning rate
    force_isotropic: bool
    do_BA: bool = False        # bundle adjustment: the window's poses move too
    cam_q_lr: float = 0.0      # its Adam's learning rates, for q and for T
    cam_t_lr: float = 0.0


def is_prune(i: int, ms: MapSpec) -> bool:
    return (i >= ms.densify_from_iter and i % ms.pruning_interval == 0
            and i <= ms.densify_until_iter)


def ba_mask(leaves: dict, kf_poses, n_added: int, cam: Cam, force_isotropic: bool, dtype):
    """[N] bool: the rows that bundle adjustment's map step moves: those with
    a projected radius > 0 from at least 2 of the window's poses [K, 7], and
    the last `n_added` rows, appended this frame (mapper.py:931-936)."""
    with torch.no_grad():
        g = activate(*(leaves[f].to(dtype) for f in ("xyz", "features_dc", "scaling",
                                                    "rotation", "opacity")))
        seen = sum((project(g, pose.to(dtype), cam, force_isotropic).radius > 0).long()
                   for pose in kf_poses)
        mask = seen >= 2
        mask[mask.shape[0] - n_added:] = True
        return mask


def _pose_adam_step(poses, m, v, step: int, grad, ms: MapSpec):
    """Bundle adjustment's Adam over the window's poses [K, 7] with the
    iteration's gradient [K, 7] (zero but in the slot rendered): one step
    counter for the frame; every slot's moments decay and every slot moves
    by its momentum; q at cam_q_lr, T at cam_t_lr; eps 1e-15; the bias
    corrections in float32."""
    f32, dev = torch.float32, poses.device
    t = torch.tensor(float(step), dtype=f32, device=dev)
    bc1 = 1.0 - torch.tensor(0.9, dtype=f32, device=dev) ** t
    bc2 = 1.0 - torch.tensor(0.999, dtype=f32, device=dev) ** t
    m = 0.9 * m + 0.1 * grad
    v = 0.999 * v + 0.001 * grad * grad
    lr = torch.cat([torch.full((4,), ms.cam_q_lr, dtype=f32, device=dev),
                    torch.full((3,), ms.cam_t_lr, dtype=f32, device=dev)])
    return poses - lr * (m / bc1) / (torch.sqrt(v) / torch.sqrt(bc2) + 1e-15), m, v


def map_iterations(leaves: dict, mu: dict, nu: dict, step: int, max_radii, extent: float,
                   kf_colors, kf_depths, kf_poses, schedule, n_iter: int, cam: Cam,
                   ms: MapSpec, dtype, row_mask=None):
    """The mapping loop's first `n_iter` iterations from a map's leaves, its
    Adam moments and step, and the densification radii: returns each
    iteration's loss, the gradients of the first Adam step (by leaf), the
    leaves before it and after the last iteration, and the rows left after
    each prune. Bins follow the loop's segments: rebuilt at prunes, at a
    change of keyframe and every ms.rebin_every iterations.

    Under bundle adjustment (ms.do_BA) the window's poses [K, 7] are a leaf
    too: the bins are rebuilt every iteration at the moved pose, the poses'
    Adam steps after every iteration, prunes included, with that
    iteration's gradient (taken on the map before the prune), and the map
    step zeroes the gradients of the rows outside `row_mask` [N] (their
    moments still decay, and they still move by momentum). It also returns
    the window's poses after each iteration."""
    f32 = torch.float32
    nc = 4 if ms.use_depth_loss else 3
    valid = pixel_valid(cam, kf_colors.device)
    losses, first_grad, before, rows = [], None, None, []
    groups, seg_start = None, 0
    poses = kf_poses.to(f32).clone()
    pose_m, pose_v, window_poses = torch.zeros_like(poses), torch.zeros_like(poses), []
    for i in range(n_iter):
        k = int(schedule[i])
        prune = is_prune(i, ms)
        if (ms.do_BA or i == 0 or prune or is_prune(i - 1, ms) or int(schedule[i - 1]) != k
                or i - seg_start >= max(ms.rebin_every, 1)):
            with torch.no_grad():
                p = project(activate(*(leaves[f] for f in ("xyz", "features_dc", "scaling",
                                                         "rotation", "opacity"))),
                            poses[k], cam, ms.force_isotropic)
                groups = group_tiles(build_bins(p, cam), cam)
            seg_start = i
        wrt = {f: leaves[f].detach().requires_grad_(True) for f in LEAVES}
        screen = torch.zeros((wrt["xyz"].shape[0], 2), dtype=f32, device=kf_colors.device,
                             requires_grad=True)
        extra = [screen]
        if ms.do_BA:
            window = poses.detach().requires_grad_(True)
            extra.append(window)
            pose = window[k]
        else:
            pose = kf_poses[k]
        g = activate(wrt["xyz"], wrt["features_dc"], wrt["scaling"], wrt["rotation"],
                     wrt["opacity"])
        p = project(g, pose, cam, ms.force_isotropic)
        p = p._replace(xy=p.xy + screen)
        acc, _ = composite(p, groups, cam, nc, dtype)
        image = from_tiles(acc[:, :3], cam)
        gt = kf_colors[k].to(dtype)
        loss = (1 - ms.lambda_dssim) * torch.mean(torch.abs(image - gt)) \
            + ms.lambda_dssim * (1.0 - ssim(image, gt))
        if ms.use_depth_loss:
            gt_d = to_tiles(kf_depths[k], cam).to(dtype)
            loss = loss + ms.pearson_weight * pearson_loss(
                acc[:, 3], gt_d, (gt_d > 0) & valid, invert_estimate=False)
        params = [wrt[f] for f in LEAVES]
        grads = torch.autograd.grad(loss.float(), params + extra, allow_unused=True)
        grads = [torch.zeros_like(t) if gr is None else gr.to(f32)
                 for t, gr in zip(params + extra, grads)]
        losses.append(float(loss.detach()))
        radius = p.radius
        visible = radius > 0
        if i <= ms.densify_until_iter:
            max_radii = torch.where(visible, torch.maximum(max_radii, radius.to(f32)), max_radii)
        with torch.no_grad():
            if ms.do_BA:
                poses, pose_m, pose_v = _pose_adam_step(poses, pose_m, pose_v, i + 1,
                                                        grads[-1], ms)
                window_poses.append(poses.cpu())
            if prune:
                keep = ~(torch.sigmoid(leaves["opacity"][:, 0]) < ms.min_opacity)
                keep &= ~(torch.max(torch.exp(leaves["scaling"]), dim=1).values > 0.1 * extent)
                if ms.size_threshold is not None:
                    keep &= ~(max_radii > ms.size_threshold)
                idx = torch.nonzero(keep).reshape(-1)
                leaves = {f: t[idx] for f, t in leaves.items()}
                mu = {f: t[idx] for f, t in mu.items()}
                nu = {f: t[idx] for f, t in nu.items()}
                max_radii = max_radii[idx]
                if row_mask is not None:
                    row_mask = row_mask[idx]
                rows.append(int(idx.numel()))
                continue
            if first_grad is None:
                first_grad = dict(zip(LEAVES, grads))
                before = {f: t.clone() for f, t in leaves.items()}
            step += 1
            bc1, bc2 = 1.0 - 0.9 ** step, (1.0 - 0.999 ** step) ** 0.5
            for f, gr in zip(LEAVES, grads):
                if row_mask is not None:
                    gr = torch.where(row_mask.reshape((-1,) + (1,) * (gr.dim() - 1)), gr,
                                     torch.zeros_like(gr))
                mu[f] = 0.9 * mu[f] + 0.1 * gr
                nu[f] = 0.999 * nu[f] + 0.001 * gr * gr
                leaves[f] = leaves[f] - ms.lrs[f] * (mu[f] / bc1) / (torch.sqrt(nu[f]) / bc2
                                                                     + 1e-15)
    out = dict(losses=losses, first_grad=first_grad, before=before, after=leaves, rows=rows)
    if ms.do_BA:
        out["poses"] = window_poses
    return out


# -- frame 0's new Gaussians ---------------------------------------------------

def first_frame_gaussians(color, depth, w2c, cam: Cam, dtype):
    """One Gaussian per pixel with depth > 0: (xyz [M, 3], features_dc
    [M, 3], log scale [M]) of the masked pixels, and the mask [H * W]."""
    H, W = depth.shape
    d = depth.to(dtype)
    yg, xg = torch.meshgrid(torch.arange(H, dtype=dtype, device=d.device),
                            torch.arange(W, dtype=dtype, device=d.device), indexing="ij")
    pts = torch.stack([(xg - cam.cx) / cam.fx * d, (yg - cam.cy) / cam.fy * d, d],
                      -1).reshape(-1, 3)
    c2w = torch.linalg.inv(w2c.to(torch.float64)).to(dtype)
    pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    cols = color.to(dtype).permute(1, 2, 0).reshape(-1, 3)
    s = d.reshape(-1) / ((cam.fx + cam.fy) / 2.0)
    log_scale = torch.log(torch.sqrt(torch.clamp(s * s, min=1e-20)))
    mask = d.reshape(-1) > 0
    return pts[mask], ((cols - 0.5) / SH_C0)[mask], log_scale[mask], mask
