"""The row-sharded map and the all-gather of its projections (JAX
counterpart: parallel/sharded.py).

Each rank holds an exactly-sized `GaussianMap` and `AdamState` of its own
rows (the port's map has no capacity, so JAX's per-shard `n_alive` vector
becomes each rank's row count, gathered with `Mesh.row_counts` where a
global count is needed). Projection and Adam run on a rank's own rows; the
projected rows of every rank are gathered (`replicate_proj`, the one
all-gather of the forward path), and its backward sums the per-Gaussian
gradient partials that every rank's tile window produced and hands each
rank its own rows. The rows of the gathered map are the ranks' rows in rank
order, as JAX's `to_numpy_dict` lists a sharded map's.
"""
from __future__ import annotations

import torch

from ..models.gaussians import AdamState, GaussianMap, MapOptHyper, adam_update
from ..ops.losses import l1_loss, ssim
from ..ops.projection import ProjectedGaussians
from ..ops.render import RenderSettings, project_for_pose
from .mesh import Mesh


def shard_rows(n: int, n_shards: int) -> list[tuple[int, int]]:
    """(first row, rows) of each of n_shards contiguous near-equal blocks of
    an n-row map, the first n % n_shards blocks one row longer."""
    base, extra = divmod(n, n_shards)
    spans, lo = [], 0
    for s in range(n_shards):
        k = base + (s < extra)
        spans.append((lo, k))
        lo += k
    return spans


def shard_map_state(m: GaussianMap, adam: AdamState, mesh: Mesh):
    """This rank's block of a map (and its Adam moments) that every rank
    holds whole, e.g. a loaded checkpoint: contiguous blocks in rank order,
    as JAX `shard_counts` splits a compacted map."""
    lo, k = shard_rows(m.n, mesh.size)[mesh.rank]
    take = lambda g: GaussianMap(*(t[lo:lo + k].contiguous() for t in g))  # noqa: E731
    return take(m), AdamState(take(adam.mu), take(adam.nu), adam.step)


class _GatherRows(torch.autograd.Function):
    """[n_rank, ...] rows of this rank -> [sum n, ...] rows of every rank in
    rank order; backward: the sum of every rank's cotangent, this rank's
    rows of it."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, counts):
        off, n = sum(counts[:mesh.rank]), counts[mesh.rank]
        if x.shape[0] != n:
            raise ValueError(f"rank {mesh.rank} holds {x.shape[0]} rows, counts say {n}")
        full = x.new_zeros((sum(counts),) + tuple(x.shape[1:]))
        full[off:off + n] = x
        mesh.all_reduce(full)
        ctx.mesh, ctx.span = mesh, (off, n)
        return full

    @staticmethod
    def backward(ctx, g):
        off, n = ctx.span
        g = ctx.mesh.all_reduce(g.contiguous().clone())
        return g[off:off + n], None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, counts: list[int] | None = None):
    """Differentiable all-gather of per-row data; `counts` (every rank's row
    count, `mesh.row_counts`) saves a collective where the caller knows them.
    One process gathers nothing: `x` itself."""
    if mesh.size == 1:
        return x
    if counts is None:
        counts = mesh.row_counts(x.shape[0])
    return _GatherRows.apply(x, mesh, list(counts))


def replicate_proj(proj: ProjectedGaussians, mesh: Mesh,
                   counts: list[int] | None = None) -> ProjectedGaussians:
    """The projection of every rank's rows on every rank: the boundary
    between Gaussian-parallel and tile-parallel work (one all-gather of the
    packed rows and the radius; differentiable in `packed`); `proj` itself
    in one process."""
    if mesh.size == 1:
        return proj
    full = gather_rows(torch.cat([proj.packed, proj.radius.to(torch.float32)[:, None]], 1),
                       mesh, counts)
    packed = full[:, :16]
    return ProjectedGaussians(xy=packed[:, 0:2], depth=packed[:, 9], conic=packed[:, 2:5],
                              radius=full[:, 16].detach().to(torch.int32),
                              opacity=packed[:, 5], feat=packed[:, 6:12], packed=packed)


def sharded_render_loss(m: GaussianMap, pose, gt_color, rs: RenderSettings, mesh: Mesh,
                        lambda_dssim: float = 0.2):
    """(1 - lambda) L1 + lambda (1 - SSIM) of the sharded map's render: each
    rank projects its rows, the projections are gathered, each rank bins and
    composites its tile window, and the tile slabs are gathered into the
    image (JAX `sharded_render_loss`, with its tile-parallel composite)."""
    from .tile_sharded import composite_tiles_sharded

    proj = replicate_proj(project_for_pose(m.activated(), pose, rs), mesh)
    image = composite_tiles_sharded(proj, rs, mesh, nc=3)
    return (1 - lambda_dssim) * l1_loss(image, gt_color) + lambda_dssim * (
        1.0 - ssim(image, gt_color))


def make_sharded_train_step(rs: RenderSettings, hyper: MapOptHyper, mesh: Mesh):
    """One render -> loss -> grad -> Adam step of the sharded map: returns
    step(m, adam, pose, gt_color) -> (m, adam, loss), the Adam step on each
    rank's own rows (JAX `make_sharded_train_step`)."""

    def step(m: GaussianMap, adam: AdamState, pose, gt_color):
        leaves = [t.detach().requires_grad_(True) for t in m]
        loss = sharded_render_loss(GaussianMap(*leaves), pose, gt_color, rs, mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        with torch.no_grad():
            m2, adam2 = adam_update(m, GaussianMap(*grads), adam, hyper)
        return m2, adam2, loss.detach()

    return step
