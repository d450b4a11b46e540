"""Quaternion / SE(3) pose math (JAX counterpart: ops/pose.py).

A camera pose is a 7-vector ``[qw qx qy qz tx ty tz]`` for the
world-to-camera transform (reference utils/pose_utils.py:352-383).
Quaternions are normalized inside `quat_to_rotmat`, so gradients flow
through un-normalized pose parameters as in the reference. The IMU motion
model (`propagate_imu`) is not ported yet.
"""
from __future__ import annotations

import torch


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (utils/pose_utils.py:219-237)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) [..., 4] -> rotation matrix [..., 3, 3];
    normalizes first (utils/pose_utils.py:240-271)."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    r, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.sqrt(safe), torch.zeros_like(x))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> wxyz quaternion [..., 4]: branchless
    best-conditioned-candidate selection (utils/pose_utils.py:286-349)."""
    batch = m.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.reshape(batch + (9,)).unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    cand = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    onehot = torch.nn.functional.one_hot(q_abs.argmax(-1), 4).to(cand.dtype)
    return torch.sum(cand * onehot[..., None], dim=-2)


def pose_to_w2c(pose7: torch.Tensor) -> torch.Tensor:
    """[qw qx qy qz tx ty tz] -> 4x4 w2c (utils/pose_utils.py:352-368)."""
    top = torch.cat([quat_to_rotmat(pose7[:4]), pose7[4:, None]], dim=1)
    bottom = pose7.new_tensor([[0.0, 0.0, 0.0, 1.0]])
    return torch.cat([top, bottom], dim=0)


def w2c_to_pose(w2c: torch.Tensor) -> torch.Tensor:
    """4x4 transform -> 7-vector (utils/pose_utils.py:371-383)."""
    return torch.cat([rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3]])


def propagate_const_vel(pose_m1: torch.Tensor, pose_m2: torch.Tensor) -> torch.Tensor:
    """Constant-velocity motion model (utils/pose_utils.py:203-216):
    delta = w2c[-1] @ inv(w2c[-2]); seed = delta @ w2c[-1]."""
    pre = pose_to_w2c(pose_m1)
    delta = pre @ torch.linalg.inv(pose_to_w2c(pose_m2))
    return w2c_to_pose(delta @ pre)
