"""Quaternion / SE(3) pose math (JAX counterpart: ops/pose.py).

A camera pose is a 7-vector ``[qw qx qy qz tx ty tz]`` for the
world-to-camera transform (reference utils/pose_utils.py:352-383).
Quaternions are normalized inside `quat_to_rotmat`, so gradients flow
through un-normalized pose parameters as in the reference. The motion
models (`propagate_const_vel`, `propagate_imu`) run on the host, on CPU
tensors, in the JAX package's float32 operation order.
"""
from __future__ import annotations

import torch

# Gravity in the camera optical frame (utils/pose_utils.py:40).
GRAVITY = torch.tensor([0.0, -9.80665, 0.0], dtype=torch.float32)


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


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform [R t; 0 1]: [R^T, -R^T t; 0 1]."""
    Rt = T[:3, :3].T
    top = torch.cat([Rt, (-Rt @ T[:3, 3])[:, None]], dim=1)
    return torch.cat([top, T.new_tensor([[0.0, 0.0, 0.0, 1.0]])], dim=0)


# Shoemake axis-spec tuples (firstaxis, parity, repetition, frame): the
# Graphics Gems IV encoding of the 24 Euler conventions
# (utils/pose_utils.py:24-40).
_AXES2TUPLE = {
    "sxyz": (0, 0, 0, 0), "sxyx": (0, 0, 1, 0), "sxzy": (0, 1, 0, 0),
    "sxzx": (0, 1, 1, 0), "syzx": (1, 0, 0, 0), "syzy": (1, 0, 1, 0),
    "syxz": (1, 1, 0, 0), "syxy": (1, 1, 1, 0), "szxy": (2, 0, 0, 0),
    "szxz": (2, 0, 1, 0), "szyx": (2, 1, 0, 0), "szyz": (2, 1, 1, 0),
    "rzyx": (0, 0, 0, 1), "rxyx": (0, 0, 1, 1), "ryzx": (0, 1, 0, 1),
    "rxzx": (0, 1, 1, 1), "rxzy": (1, 0, 0, 1), "ryzy": (1, 0, 1, 1),
    "rzxy": (1, 1, 0, 1), "ryxy": (1, 1, 1, 1), "ryxz": (2, 0, 0, 1),
    "rzxz": (2, 0, 1, 1), "rxyz": (2, 1, 0, 1), "rzyz": (2, 1, 1, 1),
}
_NEXT_AXIS = (1, 2, 0, 1)


def _angle(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def _rotation4(entries: dict) -> torch.Tensor:
    """4x4 float32 transform: identity, with the given (row, col) entries."""
    one, zero = torch.ones((), dtype=torch.float32), torch.zeros((), dtype=torch.float32)
    rows = [[entries.get((r, c), one if r == c else zero) for c in range(4)]
            for r in range(4)]
    return torch.stack([torch.stack(row) for row in rows])


def euler_matrix(ai, aj, ak, axes: str = "sxyz") -> torch.Tensor:
    """Euler angles -> homogeneous rotation matrix, all 24 conventions
    (utils/pose_utils.py:43-99, the classic Shoemake euler_matrix; the
    pipeline itself only calls 'sxyz')."""
    firstaxis, parity, repetition, frame = _AXES2TUPLE[axes.lower()]
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]
    ai, aj, ak = _angle(ai), _angle(aj), _angle(ak)
    if frame:
        ai, ak = ak, ai
    if parity:
        ai, aj, ak = -ai, -aj, -ak
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    if repetition:
        e = {(i, i): cj, (i, j): sj * si, (i, k): sj * ci,
             (j, i): sj * sk, (j, j): -cj * ss + cc, (j, k): -cj * cs - sc,
             (k, i): -sj * ck, (k, j): cj * sc + cs, (k, k): cj * cc - ss}
    else:
        e = {(i, i): cj * ck, (i, j): sj * sc - cs, (i, k): sj * cc + ss,
             (j, i): cj * sk, (j, j): sj * ss + cc, (j, k): sj * cs - sc,
             (k, i): -sj, (k, j): cj * si, (k, k): cj * ci}
    return _rotation4(e)


def euler_sxyz_matrix(ai, aj, ak) -> torch.Tensor:
    """The 'sxyz' branch of `euler_matrix` ((i, j, k) = (0, 1, 2), no
    repetition), the convention the IMU model integrates with
    (utils/pose_utils.py:137,190)."""
    return euler_matrix(ai, aj, ak, "sxyz")


def propagate_imu(pose_m1: torch.Tensor, pose_m2: torch.Tensor, imu_ang_vel: torch.Tensor,
                  imu_lin_accel: torch.Tensor, c2i: torch.Tensor, dt_cam: float,
                  dt_imu: float) -> torch.Tensor:
    """IMU dead-reckoning motion model (utils/pose_utils.py:148-200).

    The velocity comes from finite-differencing the last two tracked IMU
    poses over `dt_cam`; each gravity-compensated sample [K, 3] (ang_vel =
    imu.txt value columns 13:16, lin_accel = 25:28) then right-composes an
    sxyz SE(3) delta onto the IMU pose, the velocity held constant. `c2i` is
    the 4x4 camera-optical -> IMU extrinsic. Only the K rows to integrate are
    passed. Float32 on the CPU, in the JAX package's operation order."""
    f32 = torch.float32
    w2c_m1, w2c_m2 = pose_to_w2c(pose_m1.to(f32)), pose_to_w2c(pose_m2.to(f32))
    c2i = torch.as_tensor(c2i, dtype=f32)
    i2c = torch.linalg.inv(c2i)
    i2w = invert_se3(w2c_m1) @ i2c
    i2w_m2 = invert_se3(w2c_m2) @ i2c
    lin_vel = (invert_se3(i2w_m2) @ i2w)[:3, 3] / torch.tensor(dt_cam, dtype=f32)
    dt = torch.tensor(dt_imu, dtype=f32)
    for omega, accel in zip(torch.as_tensor(imu_ang_vel, dtype=f32),
                            torch.as_tensor(imu_lin_accel, dtype=f32)):
        accel = accel - i2w[:3, :3].T @ GRAVITY
        dp = lin_vel * dt + 0.5 * accel * dt * dt
        dtheta = omega * dt
        delta = euler_sxyz_matrix(dtheta[0], dtheta[1], dtheta[2])
        delta = torch.cat([torch.cat([delta[:3, :3], dp[:, None]], dim=1), delta[3:]], dim=0)
        i2w = i2w @ delta
    return w2c_to_pose(torch.linalg.inv(i2w @ c2i))
