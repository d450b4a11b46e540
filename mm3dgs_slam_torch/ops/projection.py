"""EWA projection of 3D Gaussians to screen space (JAX counterpart:
ops/projection.py; the math of the reference CUDA rasterizer behind
slam/renderer.py:85-224):

  * frustum cull at camera-frame z <= 0.2,
  * 2D covariance J W Sigma W^T J^T with the 1.3*tanfov frustum clamp,
  * +0.3 low-pass on the 2D covariance diagonal,
  * radius = ceil(3 * sqrt(lambda_max)), conic = inverse 2D covariance,
  * SH -> RGB with +0.5 offset and clamp at 0,
  * the feature channels [r, g, b, z, 1, z^2] composited in one pass.

Every intermediate is a flat [N] column (structure-of-arrays), as in the
reference package, so the fused pose-Jacobian rows below differentiate the
same code the projection runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from .camera import Camera, projection_matrix
from .sh import eval_sh

_IDENTITY9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians, one row per map row.

    `packed` is the kernels' [N, 16] row: 0-1 xy, 2-4 conic, 5 opacity,
    6-11 features [r, g, b, z, 1, z^2], 12-15 zero; the named fields are
    slices of it, so gradients through either view reach the same inputs."""

    xy: torch.Tensor        # [N, 2] pixel coordinates of the center
    depth: torch.Tensor     # [N] camera-frame z
    conic: torch.Tensor     # [N, 3] inverse 2D covariance (xx, xy, yy)
    radius: torch.Tensor    # [N] int32 screen extent (3 sigma), 0 = culled
    opacity: torch.Tensor   # [N] post-sigmoid opacity
    feat: torch.Tensor      # [N, 6] composited features
    packed: torch.Tensor    # [N, 16]


def _rotmat_rows(q: torch.Tensor) -> list[torch.Tensor]:
    """Quaternions [N, 4] -> the 9 rotation entries as [N] columns."""
    q = q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=1e-12)
    r, x, y, z = q.unbind(-1)
    return [
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ]


def _cov3d_components(scales: torch.Tensor, rotations: torch.Tensor):
    """Upper triangle of Sigma = R diag(s^2) R^T as six [N] columns."""
    R = _rotmat_rows(rotations)
    s0, s1, s2 = scales[:, 0] ** 2, scales[:, 1] ** 2, scales[:, 2] ** 2

    def entry(i, j):
        return (R[3 * i] * R[3 * j] * s0 + R[3 * i + 1] * R[3 * j + 1] * s1
                + R[3 * i + 2] * R[3 * j + 2] * s2)

    return entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2), entry(2, 2)


def _conic_soa(t_x, t_y, tz, cov3d, R, cam: Camera):
    """Camera-frame centers + cov3D upper triangle -> EWA conic columns.

    R is 9 w2c rotation entries (row-major). Returns
    (conic_a, conic_b, conic_c, det_ok, radius_f, in_front)."""
    s00, s01, s02, s11, s12, s22 = cov3d
    in_front = tz > 0.2
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))
    tx = torch.clamp(t_x / tz_safe, -limx, limx) * tz_safe
    ty = torch.clamp(t_y / tz_safe, -limy, limy) * tz_safe

    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    J00 = cam.fx * inv_z
    J02 = -cam.fx * tx * inv_z2
    J11 = cam.fy * inv_z
    J12 = -cam.fy * ty * inv_z2
    JW0 = [J00 * R[0] + J02 * R[6], J00 * R[1] + J02 * R[7], J00 * R[2] + J02 * R[8]]
    JW1 = [J11 * R[3] + J12 * R[6], J11 * R[4] + J12 * R[7], J11 * R[5] + J12 * R[8]]

    def quad(a, b):
        return (a[0] * b[0] * s00 + a[1] * b[1] * s11 + a[2] * b[2] * s22
                + (a[0] * b[1] + a[1] * b[0]) * s01
                + (a[0] * b[2] + a[2] * b[0]) * s02
                + (a[1] * b[2] + a[2] * b[1]) * s12)

    c00 = quad(JW0, JW0) + 0.3
    c01 = quad(JW0, JW1)
    c11 = quad(JW1, JW1) + 0.3
    det = c00 * c11 - c01 * c01
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))
    return c11 * inv_det, -c01 * inv_det, c00 * inv_det, det_ok, radius_f, in_front


def conic_pose_jacobian_rows(means_cam, scales, rotations, means_world,
                             cam: Camera) -> torch.Tensor:
    """Per-gaussian pose-Jacobian extension rows [N, 16] for the fused pose
    backward (kernel 3): 0-8 = d(conic_a, b, c)/d(mcam_x, y, z), conic-major
    (jc[3*i + k] = d conic_i / d mcam_k); 9-11 = the world-frame mean;
    12-15 zero. Valid in transform_means_python mode (w2c = I inside the
    projection). Forward-mode AD through the same `_conic_soa` the
    projection runs, so the fused and the general gradients share it: the
    three tangent directions are stacked into one [3N] pass (the JAX
    package's three `jax.jvp` calls cost nothing under jit; in eager
    PyTorch each op is a launch)."""
    means_cam = means_cam.detach()
    n = means_cam.shape[0]
    cov3d = tuple(c.detach().repeat(3) for c in _cov3d_components(scales, rotations))
    basis = torch.eye(3, dtype=means_cam.dtype, device=means_cam.device)
    with fwAD.dual_level():
        m = fwAD.make_dual(means_cam.repeat(3, 1), basis.repeat_interleave(n, dim=0))
        conic = _conic_soa(m[:, 0], m[:, 1], m[:, 2], cov3d, _IDENTITY9, cam)[:3]
        # d[i][k] = d conic_i / d mcam_k, [N]
        d = [fwAD.unpack_dual(c).tangent.reshape(3, n) for c in conic]
    jc = torch.stack([d[i][k] for i in range(3) for k in range(3)], dim=-1)
    pad = means_cam.new_zeros((n, 4))
    return torch.cat([jc, means_world.detach(), pad], dim=-1)


def project_gaussians(means3d, scales, rotations, opacities, shs, alive,
                      w2c, cam: Camera, sh_degree: int = 0,
                      campos=None) -> ProjectedGaussians:
    """Project every map row to screen space.

    means3d [N, 3] (world frame, or camera frame with w2c = I in the
    transform-means-upstream mode), scales [N, 3] post-exp, rotations
    [N, 4] wxyz, opacities [N] post-sigmoid, shs [N, K, 3], alive [N] bool,
    w2c 4x4. `campos` defaults to the camera center derived from w2c."""
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    R = [w2c[i, j] for i in range(3) for j in range(3)]
    t_w2c = w2c[:3, 3]
    t_x = mx * R[0] + my * R[1] + mz * R[2] + t_w2c[0]
    t_y = mx * R[3] + my * R[4] + mz * R[5] + t_w2c[1]
    tz = mx * R[6] + my * R[7] + mz * R[8] + t_w2c[2]

    P = projection_matrix(cam, means3d.device)
    ph_x = t_x * P[0, 0] + t_y * P[0, 1] + tz * P[0, 2] + P[0, 3]
    ph_y = t_x * P[1, 0] + t_y * P[1, 1] + tz * P[1, 2] + P[1, 3]
    p_w = 1.0 / (tz + 1e-7)
    px = ((ph_x * p_w + 1.0) * cam.width - 1.0) * 0.5   # ndc2Pix
    py = ((ph_y * p_w + 1.0) * cam.height - 1.0) * 0.5

    cov3d = _cov3d_components(scales, rotations)
    conic_a, conic_b, conic_c, det_ok, radius_f, in_front = _conic_soa(
        t_x, t_y, tz, cov3d, R, cam)
    valid = alive & in_front & det_ok
    radius = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)

    sh = shs.transpose(-1, -2)  # [N, 3, K]
    if sh_degree > 0:
        if campos is None:
            campos = -w2c[:3, :3].T @ t_w2c
        dirs = means3d - campos[None, :]
        dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        rgb = eval_sh(sh_degree, sh, dirs)
    else:
        rgb = eval_sh(0, sh, None)
    rgb = torch.clamp(rgb + 0.5, min=0.0)

    zero = torch.zeros_like(tz)
    packed = torch.stack(
        [px, py, conic_a, conic_b, conic_c, opacities,
         rgb[:, 0], rgb[:, 1], rgb[:, 2], tz, torch.ones_like(tz), tz * tz,
         zero, zero, zero, zero], dim=-1)
    return ProjectedGaussians(
        xy=packed[:, 0:2], depth=tz, conic=packed[:, 2:5], radius=radius,
        opacity=packed[:, 5], feat=packed[:, 6:12], packed=packed)
