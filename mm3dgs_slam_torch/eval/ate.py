"""Trajectory alignment and ATE-RMSE, host-side numpy (JAX counterpart:
eval/ate.py; reference utils/eval_utils.py:139-293). Poses are 7-vectors
``[qw qx qy qz tx ty tz]``; the quaternion math runs in float32 torch on
the CPU, as the reference package runs it in float32."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import pose as P


def align_umeyama(model: np.ndarray, data: np.ndarray, known_scale=False):
    """(s, R, t) with model ~= s * R @ data + t. Inputs [n, 3]."""
    mu_m, mu_d = model.mean(0), data.mean(0)
    model_zc, data_zc = model - mu_m, data - mu_d
    n = model.shape[0]
    C = (model_zc.T @ data_zc) / n
    sigma2 = (data_zc ** 2).sum() / n
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt.T) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0 if known_scale else np.trace(np.diag(D) @ S) / sigma2
    return s, R, (mu_m - s * R @ mu_d)[:, None]


def align_horn(model: np.ndarray, data: np.ndarray):
    """Horn's closed-form rigid alignment of model onto data. Inputs
    [3, n]; returns (rot, trans, per-point translational error)."""
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)
    U, _, Vh = np.linalg.svd((model_zc @ data_zc.T).T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = np.sqrt(((rot @ model + trans - data) ** 2).sum(0))
    return rot, trans, err


def _rotate_quats(R: np.ndarray, quats: np.ndarray) -> np.ndarray:
    Rq = P.quat_to_rotmat(torch.as_tensor(quats, dtype=torch.float32)).numpy()
    out = np.einsum("ij,njk->nik", R.astype(np.float32), Rq)
    return P.rotmat_to_quat(torch.as_tensor(out)).numpy()


def evaluate_ate_rmse(est_poses, gt_poses, method: str = "umeyama"):
    """Align est to gt and return (aligned_poses, ate_rmse): translation
    columns are aligned ("umeyama": sim(3), "horn": SE(3); any other method
    leaves them unaligned) and the RMSE of their residuals reported."""
    est_poses = np.asarray(est_poses, dtype=np.float64)
    gt_poses = np.asarray(gt_poses, dtype=np.float64)
    if len(est_poses) != len(gt_poses):
        raise ValueError("est and gt trajectories differ in length")
    est_traj, gt_traj = est_poses[:, 4:], gt_poses[:, 4:]
    aligned = est_poses.copy()
    if method.lower() == "horn":
        rot, trans, ate = align_horn(est_traj.T, gt_traj.T)
        aligned[:, :4] = _rotate_quats(rot, est_poses[:, :4])
        aligned[:, 4:] = (rot @ est_traj.T + trans).T
    elif method.lower() == "umeyama":
        s, rot, trans = align_umeyama(gt_traj, est_traj)
        aligned[:, :4] = _rotate_quats(rot, est_poses[:, :4])
        aligned[:, 4:] = (s * (rot @ est_traj.T) + trans).T
        ate = np.linalg.norm(aligned[:, 4:] - gt_traj, axis=1)
    else:
        ate = np.linalg.norm(est_traj - gt_traj, axis=1)
    return aligned, float(np.sqrt(np.dot(ate, ate) / len(ate)))


def camera_centers(pose_list: np.ndarray) -> np.ndarray:
    """w2c 7-vector list -> c2w 7-vector list (SLAM.py:322-331)."""
    out = np.zeros_like(pose_list)
    for i, p in enumerate(pose_list):
        w2c = P.pose_to_w2c(torch.as_tensor(p, dtype=torch.float32)).numpy()
        out[i] = P.w2c_to_pose(torch.as_tensor(np.linalg.inv(w2c))).numpy()
    return out
