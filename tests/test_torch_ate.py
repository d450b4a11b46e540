"""The port's trajectory evaluation (eval/ate.py, scripts/eval_traj.py)
against the JAX package's: horn, umeyama and the unaligned fallback on 10
poses whose estimate is the ground truth turned 90 degrees about z and
shifted by 0.3, and on a noisy estimate."""
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.eval import ate as jate
from mm3dgs_slam_torch.eval import ate as tate
from mm3dgs_slam_torch.scripts.eval_traj import trajectory_ates

torch.set_num_threads(1)


def _poses(noise: float):
    """(est, gt) [10, 7] w2c vectors [qw qx qy qz tx ty tz]."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(10, 4))
    gt = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                         rng.uniform(-1, 1, (10, 3))], 1)
    rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    est = gt.copy()
    est[:, 4:] = gt[:, 4:] @ rz.T + 0.3 + noise * rng.normal(size=(10, 3))
    return est.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("noise", [0.0, 0.01])
@pytest.mark.parametrize("method", ["horn", "umeyama", "none"])
def test_evaluate_ate_rmse_matches_jax(method, noise):
    est, gt = _poses(noise)
    t_al, t_ate = tate.evaluate_ate_rmse(est, gt, method)
    j_al, j_ate = jate.evaluate_ate_rmse(est, gt, method)
    assert abs(t_ate - j_ate) <= 1e-9
    np.testing.assert_allclose(t_al[:, 4:], j_al[:, 4:], atol=1e-9, rtol=0)
    np.testing.assert_allclose(t_al[:, :4], j_al[:, :4], atol=1e-6, rtol=0)
    if method == "none":
        assert t_ate > 1.0
    elif noise == 0.0:
        assert t_ate < 1e-6     # a rigid motion of the ground truth aligns away


def test_align_horn_matches_jax():
    est, gt = _poses(0.01)
    got = tate.align_horn(est[:, 4:].T.astype(np.float64), gt[:, 4:].T.astype(np.float64))
    want = jate.align_horn(est[:, 4:].T.astype(np.float64), gt[:, 4:].T.astype(np.float64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-12, rtol=0)


def test_eval_traj_ates_match_jax():
    """eval_traj's two ATEs (w2c vectors, camera centres) against the JAX
    script's computation; the w2c one is what results.npz stores."""
    est, gt = _poses(0.01)
    got = trajectory_ates(est, gt)
    _, want_w2c = jate.evaluate_ate_rmse(est, gt, "umeyama")
    _, want_c2w = jate.evaluate_ate_rmse(jate.camera_centers(est), jate.camera_centers(gt),
                                         "umeyama")
    assert abs(got["ate_w2c"] - want_w2c) <= 1e-9
    assert abs(got["ate_c2w"] - want_c2w) <= 1e-6
    np.testing.assert_allclose(got["gt_centers"], jate.camera_centers(gt), atol=1e-6)
