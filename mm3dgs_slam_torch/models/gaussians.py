"""The Gaussian map and its optimizer state (JAX counterpart:
models/gaussians.py; reference slam/gaussian_model.py:31-598).

The map holds exactly its live rows: every leaf is [N, ...], in the order of
the JAX package's alive prefix. Growth appends rows, pruning keeps the
survivors in order. Adam is written out as code with torch semantics (one
shared step count, eps 1e-15) rather than `torch.optim.Adam`, so that the
reference's optimizer-state surgery stays exact: appended rows get zeroed
moments while the step persists (gaussian_model.py:419-488), pruning gathers
moments with the parameters (gaussian_model.py:380-417), and a mapping
iteration can skip the step (map_opt.py's prune iterations).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.render import ActivatedGaussians

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "rgb")


class GaussianMap(NamedTuple):
    """Parameter leaves, pre-activation (gaussian_model.py:53-61)."""

    xyz: torch.Tensor            # [N, 3]
    features_dc: torch.Tensor    # [N, 1, 3]
    features_rest: torch.Tensor  # [N, R, 3]  (R = (deg+1)^2 - 1, >= 1)
    scaling: torch.Tensor        # [N, 3] log-scale
    rotation: torch.Tensor       # [N, 4] unnormalized wxyz
    opacity: torch.Tensor        # [N, 1] logit
    rgb: torch.Tensor            # [N, 3] extra channel, saved to the PLY

    @property
    def n(self) -> int:
        return self.xyz.shape[0]

    def activated(self) -> ActivatedGaussians:
        """Apply activations (gaussian_model.py:32-47)."""
        rot = self.rotation / torch.clamp(
            torch.linalg.norm(self.rotation, dim=-1, keepdim=True), min=1e-12)
        return ActivatedGaussians(
            xyz=self.xyz,
            scales=torch.exp(self.scaling),
            rotations=rot,
            opacity=torch.sigmoid(self.opacity[:, 0]),
            shs=torch.cat([self.features_dc, self.features_rest], dim=1),
            alive=torch.ones(self.n, dtype=torch.bool, device=self.xyz.device),
        )


class AdamState(NamedTuple):
    mu: GaussianMap   # first moments
    nu: GaussianMap   # second moments
    step: int         # shared across leaves


class MapOptHyper(NamedTuple):
    """Per-group learning rates (gaussian_model.py:143-195)."""

    lr_xyz: float
    lr_features_dc: float
    lr_features_rest: float
    lr_scaling: float
    lr_rotation: float
    lr_opacity: float
    lr_rgb: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15

    @staticmethod
    def from_cfg(mapping_cfg: dict) -> "MapOptHyper":
        return MapOptHyper(
            lr_xyz=mapping_cfg["position_lr_init"] * mapping_cfg["spatial_lr_scale"],
            lr_features_dc=mapping_cfg["feature_lr"],
            lr_features_rest=mapping_cfg["feature_lr"] / 20.0,
            lr_scaling=mapping_cfg["scaling_lr"],
            lr_rotation=mapping_cfg["rotation_lr"],
            lr_opacity=mapping_cfg["opacity_lr"],
            lr_rgb=mapping_cfg["rgb_lr"],
        )


class NewGaussians(NamedTuple):
    """Candidate rows to append, one per source pixel, and which to add."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    rgb: torch.Tensor
    mask: torch.Tensor  # [M] bool


def empty_map(sh_degree: int = 0, device=None) -> GaussianMap:
    rest = max((sh_degree + 1) ** 2 - 1, 1)
    z = lambda *s: torch.zeros((0,) + s, dtype=torch.float32, device=device)  # noqa: E731
    return GaussianMap(z(3), z(1, 3), z(rest, 3), z(3), z(4), z(1), z(3))


def from_numpy_params(d: dict, device=None) -> GaussianMap:
    """The JAX `GaussianMap` leaves as numpy arrays (xyz, features_dc,
    features_rest, scaling, rotation, opacity, rgb, n_alive) -> this map,
    holding the alive prefix [0, n_alive)."""
    n = int(np.asarray(d["n_alive"]))
    return GaussianMap(*(
        torch.tensor(np.asarray(d[f])[:n], dtype=torch.float32, device=device)
        for f in PARAM_FIELDS))


def zeros_like_map(m: GaussianMap) -> GaussianMap:
    return GaussianMap(*(torch.zeros_like(t) for t in m))


def init_adam(m: GaussianMap) -> AdamState:
    return AdamState(mu=zeros_like_map(m), nu=zeros_like_map(m), step=0)


def adam_update(m: GaussianMap, grads: GaussianMap, state: AdamState,
                hyper: MapOptHyper, row_mask=None) -> tuple[GaussianMap, AdamState]:
    """One torch-semantics Adam step over every parameter leaf. `row_mask`
    [N] bool zeroes the gradients of the rows where it is False (bundle
    adjustment's masking, mapper.py:931-936); their moments still decay and
    they still move by momentum, as in the reference."""
    step = state.step + 1
    bc1 = 1.0 - hyper.b1 ** step
    bc2_sqrt = (1.0 - hyper.b2 ** step) ** 0.5
    new_p, new_mu, new_nu = [], [], []
    for f in PARAM_FIELDS:
        g = getattr(grads, f)
        if row_mask is not None:
            g = g * row_mask.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
        mu = hyper.b1 * getattr(state.mu, f) + (1 - hyper.b1) * g
        nu = hyper.b2 * getattr(state.nu, f) + (1 - hyper.b2) * g * g
        lr = getattr(hyper, "lr_" + f)
        new_p.append(getattr(m, f) - lr * (mu / bc1) / (torch.sqrt(nu) / bc2_sqrt + hyper.eps))
        new_mu.append(mu)
        new_nu.append(nu)
    return GaussianMap(*new_p), AdamState(GaussianMap(*new_mu), GaussianMap(*new_nu), step)


def append_gaussians(m: GaussianMap, state: AdamState, new: NewGaussians,
                     max_new: int = -1) -> tuple[GaussianMap, AdamState, int]:
    """Append the masked candidate rows (densification_postfix,
    gaussian_model.py:453-488) with zeroed Adam moments; the step persists.
    `max_new` > 0 keeps only the first max_new candidates (pixel order).
    Returns (map, adam, n_added)."""
    idx = torch.nonzero(new.mask).reshape(-1)
    if max_new > 0:
        idx = idx[:max_new]
    rows = [getattr(new, f)[idx] for f in PARAM_FIELDS]
    cat = lambda a, b: GaussianMap(*(torch.cat([x, y], 0) for x, y in zip(a, b)))  # noqa: E731
    zeros = GaussianMap(*(torch.zeros_like(r) for r in rows))
    return (cat(m, GaussianMap(*rows)),
            AdamState(cat(state.mu, zeros), cat(state.nu, zeros), state.step),
            int(idx.shape[0]))


def prune_compact(m: GaussianMap, state: AdamState, keep: torch.Tensor):
    """Drop rows where ``keep`` is False, survivors in order (prune_points,
    gaussian_model.py:402-417). Returns (map, adam, kept row indices)."""
    idx = torch.nonzero(keep).reshape(-1)
    take = lambda g: GaussianMap(*(t[idx] for t in g))  # noqa: E731
    return take(m), AdamState(take(state.mu), take(state.nu), state.step), idx


def reset_opacity(m: GaussianMap, state: AdamState, ceiling: float = 0.01):
    """Clamp opacities to at most `ceiling` and zero the opacity moments
    (gaussian_model.py:259-264 + :365-378)."""
    op = torch.clamp(torch.sigmoid(m.opacity), max=ceiling)
    m2 = m._replace(opacity=torch.log(op / (1 - op)))
    mu = state.mu._replace(opacity=torch.zeros_like(state.mu.opacity))
    nu = state.nu._replace(opacity=torch.zeros_like(state.nu.opacity))
    return m2, AdamState(mu, nu, state.step)


def prune_mask_reference(m: GaussianMap, extent: float, min_opacity: float,
                         max_radii2d=None, max_screen_size=None):
    """Rows to REMOVE (gaussian_model.py:574-588): opacity below threshold,
    or world size > 0.1 * extent, or screen size > max_screen_size."""
    prune = torch.sigmoid(m.opacity[:, 0]) < min_opacity
    prune = prune | (torch.max(torch.exp(m.scaling), dim=1).values > 0.1 * extent)
    if max_screen_size is not None and max_radii2d is not None:
        prune = prune | (max_radii2d > max_screen_size)
    return prune


def to_numpy_dict(m: GaussianMap) -> dict:
    return {f: getattr(m, f).detach().cpu().numpy() for f in PARAM_FIELDS}
