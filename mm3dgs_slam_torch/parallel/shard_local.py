"""Shard-local map surgery: prune and growth with no row crossing ranks
(JAX counterpart: parallel/shard_local.py).

  * `prune_compact_sharded`: each rank compacts its own rows, survivors in
    order, and its per-row extras (the densification stats, BA's mask) with
    them. The port's map holds exactly its rows, so this is `prune_compact`
    on each rank's block.
  * `append_gaussians_sharded`: the replicated candidate rows (one per
    pixel of the current frame, the same on every rank) are dealt out by
    JAX's exact water-fill quota, least-loaded ranks first, and each rank
    appends the contiguous range of masked ranks that its quota gives it.
    The port has no capacity to bind, so the water-fill runs with unbounded
    blocks: each rank takes the rows that the JAX shard of the same index
    takes wherever that shard's capacity does not bind.

JAX's `grow_capacity_sharded` has no counterpart: it pads every shard's
block of a fixed-capacity buffer, and the port's exactly-sized map grows by
appending.

As in the JAX package, the same set of Gaussians survives or appears as on
one device, in a rank-interleaved order.
"""
from __future__ import annotations

import torch

from ..models.gaussians import AdamState, GaussianMap, NewGaussians, append_gaussians, prune_compact
from .mesh import Mesh


def prune_compact_sharded(m: GaussianMap, adam: AdamState, keep: torch.Tensor, mesh: Mesh,
                          extras: tuple = ()):
    """Drop this rank's rows where `keep` [n_rank] is False, survivors in
    order, and permute the per-row `extras` (None passes through) the same
    way. Returns (map, adam, extras)."""
    del mesh  # nothing crosses ranks
    m2, adam2, idx = prune_compact(m, adam, keep)
    return m2, adam2, tuple(None if x is None else x[idx] for x in extras)


def waterfill_quota(counts: list[int], want: int) -> list[int]:
    """Per-rank append quotas for `want` rows over ranks holding `counts`
    rows, as JAX `_waterfill_quota` deals them: the `want` smallest
    interleaved slot keys j * S + s over the free slots j >= counts[s],
    least-loaded first, with blocks too large to bind."""
    n = len(counts)
    if want <= 0:
        return [0] * n
    block = max(counts) + want + 1
    free = [block - c for c in counts]

    def taken(theta):
        return [min(max((theta - s + n - 1) // n - counts[s], 0), free[s]) for s in range(n)]

    lo, hi = 0, block * n + 1
    while lo + 1 < hi:   # hi: the smallest theta with sum(taken) >= want
        mid = (lo + hi) // 2
        if sum(taken(mid)) >= want:
            hi = mid
        else:
            lo = mid
    return taken(hi)


def append_gaussians_sharded(m: GaussianMap, adam: AdamState, new: NewGaussians,
                             mesh: Mesh):
    """Append this rank's share of the masked candidates with zeroed Adam
    moments. Returns (map, adam, rows appended over all ranks, added_mask
    [n_rank]: the rows this call appended here)."""
    counts = mesh.row_counts(m.n)
    mask = new.mask
    n_masked = int(mask.sum())
    quota = waterfill_quota(counts, n_masked)
    off = sum(quota[:mesh.rank])
    rank_of = torch.cumsum(mask.to(torch.int64), 0) - 1
    mine = mask & (rank_of >= off) & (rank_of < off + quota[mesh.rank])
    m2, adam2, n_added = append_gaussians(m, adam, new._replace(mask=mine))
    added = torch.zeros(m2.n, dtype=torch.bool, device=m2.xyz.device)
    added[m.n:] = True
    return m2, adam2, sum(quota), added
