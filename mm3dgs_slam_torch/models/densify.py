"""Gradient-driven densification: clone and split (JAX counterpart:
models/densify.py; reference gaussian_model.py:490-592).

The reference accumulates the screen-space gradient statistics every mapping
iteration but never calls its densification (mapper.py:914-928), and neither
does the SLAM loop here; these functions complete the API:

  * clone: small Gaussians with a large mean screen gradient are appended
    again,
  * split: large ones are replaced by n_split samples drawn inside their own
    ellipsoid, their scales shrunk by 1/(0.8 n_split).

The map holds exactly its rows, so nothing is dropped for want of capacity.
"""
from __future__ import annotations

import torch

from ..ops.projection import _rotmat_rows
from .gaussians import PARAM_FIELDS, AdamState, GaussianMap, NewGaussians, append_gaussians, prune_compact


def densify_stats_grads(grad_accum, denom):
    """Mean screen-space gradient magnitude (gaussian_model.py:567-569); 0
    where a row was never seen."""
    g = grad_accum / torch.clamp(denom, min=1e-12)
    return torch.where(torch.isnan(g) | (denom <= 0), torch.zeros_like(g), g)


def _rows_as_new(m: GaussianMap, mask, **overrides) -> NewGaussians:
    fields = {f: getattr(m, f) for f in PARAM_FIELDS}
    fields.update(overrides)
    return NewGaussians(**fields, mask=mask)


def densify_and_clone(m: GaussianMap, adam: AdamState, grads, grad_threshold: float,
                      scene_extent: float, percent_dense: float):
    """Append a copy of each small high-gradient Gaussian
    (gaussian_model.py:538-565). Returns (map, adam, n_added)."""
    sel = ((grads >= grad_threshold)
           & (torch.max(torch.exp(m.scaling), dim=1).values <= percent_dense * scene_extent))
    return append_gaussians(m, adam, _rows_as_new(m, sel))


def densify_and_split(m: GaussianMap, adam: AdamState, grads, grad_threshold: float,
                      scene_extent: float, percent_dense: float, generator=None,
                      n_split: int = 2, noise=None):
    """Replace each large high-gradient Gaussian by n_split samples
    (gaussian_model.py:490-536): sample i sits at xyz + R (scales * noise[i]),
    noise [n_split, >= N, 3] standard normals (the first N rows are used),
    drawn from `generator` unless given. Returns (map, adam, n_added)."""
    scales = torch.exp(m.scaling)
    sel = (grads >= grad_threshold) & (torch.max(scales, dim=1).values
                                        > percent_dense * scene_extent)
    if noise is None:
        noise = torch.randn((n_split, m.n, 3), generator=generator, device=m.xyz.device)
    R = torch.stack(_rotmat_rows(m.rotation), -1).reshape(-1, 3, 3)
    new_scaling = torch.log(scales / (0.8 * n_split))
    m2, adam2, total = m, adam, 0
    for i in range(n_split):
        new_xyz = m.xyz + torch.einsum("nij,nj->ni", R, scales * noise[i, :m.n])
        m2, adam2, added = append_gaussians(
            m2, adam2, _rows_as_new(m, sel, xyz=new_xyz, scaling=new_scaling))
        total += added
    # remove the originals that were split
    keep = torch.cat([~sel, torch.ones(m2.n - m.n, dtype=torch.bool, device=sel.device)])
    m2, adam2, _ = prune_compact(m2, adam2, keep)
    return m2, adam2, total


def densify(m: GaussianMap, adam: AdamState, grad_accum, denom, max_grad: float,
            extent: float, percent_dense: float, generator=None, noise=None):
    """clone, then split (gaussian_model.py:567-572). Split selects from the
    pre-clone mean gradients; the cloned rows count as 0. `noise` [2, >= N +
    n cloned, 3] stands in for the split's normals. Returns (map, adam,
    n_added)."""
    grads = densify_stats_grads(grad_accum, denom)
    m, adam, n1 = densify_and_clone(m, adam, grads, max_grad, extent, percent_dense)
    grads2 = torch.cat([grads, torch.zeros(m.n - grads.shape[0], device=grads.device)])
    m, adam, n2 = densify_and_split(m, adam, grads2, max_grad, extent, percent_dense,
                                    generator, noise=noise)
    return m, adam, n1 + n2
