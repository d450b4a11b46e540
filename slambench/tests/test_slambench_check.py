"""The check that decides `correct`, on the CPU at a tiny size: sound runs
pass every limit, the control (the reference at bfloat16 in the program's
place) fails one, and so does each fault a cell can have, planted in the
program under the harness. On the card, at the cells' own sizes, the same
readings come from `python3 -m slambench.control` (README.md).

    python -m pytest slambench/tests -q
"""
from __future__ import annotations

import pytest
import torch

from slambench import check
from slambench.tests.conftest import tiny_run_of, tiny_spec

CELLS = ("synthetic_tum.orbit", "utmm.imu")


def _judge(workload, numbers):
    spec = tiny_spec(workload)
    return check.judge(numbers, spec["limits"], check.numbers_for(spec["config"]["config"]))


def test_sound_run_passes_and_control_fails(tiny_run):
    ok, _ = _judge("synthetic_tum.orbit", tiny_run["readings"]["program"])
    assert ok and tiny_run["correct"]
    ok, rows = _judge("synthetic_tum.orbit", tiny_run["readings"]["control"])
    assert not ok, rows


@pytest.mark.parametrize("workload", CELLS[1:])
def test_other_cells_sound_and_control(workload):
    r = tiny_run_of(workload, 3100000019, control=True)
    assert _judge(workload, r["readings"]["program"])[0]
    assert not _judge(workload, r["readings"]["control"])[0]


def _unchanged_pose(orig):
    def track_frame(g, pose_init, *args):
        return pose_init.detach().clone(), torch.zeros(())
    return track_frame


def _altered_track_loss(orig):
    def tracking_loss_tiles(*args, **kw):
        return orig(*args, **kw) * 1.01
    return tracking_loss_tiles


def _altered_map_step(orig):
    def adam_update(m, grads, state, hyper, row_mask=None):
        m2, state2 = orig(m, grads, state, hyper, row_mask=row_mask)
        return m2._replace(xyz=m2.xyz + 1e-4), state2
    return adam_update


def _unchanged_map(orig):
    def adam_update(m, grads, state, hyper, row_mask=None):
        return m, state
    return adam_update


def _half_image_l1(orig):
    def l1_loss(pred, gt, mask=None):
        h = pred.shape[-2] // 2
        return orig(pred[..., :h, :], gt[..., :h, :], mask)
    return l1_loss


def _half_tiles_mean(orig):
    def masked_mean(x, mask):
        n = x.shape[0] // 2
        return orig(x[:n], mask[:n] if mask is not None else None)
    return masked_mean


def _zero_velocity_seed(orig):
    def propagate_const_vel(pose_m1, pose_m2):
        return pose_m1.clone()
    return propagate_const_vel


FAULTS = {
    "tracking returns its seed unchanged": ("mm3dgs_slam_torch.slam.slam", "track_frame",
                                            _unchanged_pose),
    "tracking's loss altered by 1% where it is produced": (
        "mm3dgs_slam_torch.slam.tracker", "tracking_loss_tiles", _altered_track_loss),
    "the map step's centres altered by 0.1 mm where they are produced": (
        "mm3dgs_slam_torch.slam.map_opt", "adam_update", _altered_map_step),
    "the map step returns its state unchanged": ("mm3dgs_slam_torch.slam.map_opt",
                                                 "adam_update", _unchanged_map),
    "half the image left out of the mapping loss": ("mm3dgs_slam_torch.slam.map_opt",
                                                    "l1_loss", _half_image_l1),
    "half the tiles left out of the tracking loss": ("mm3dgs_slam_torch.slam.tracker",
                                                     "masked_mean", _half_tiles_mean),
    "the motion model's seed left at the last pose": (
        "mm3dgs_slam_torch.slam.slam", "propagate_const_vel", _zero_velocity_seed),
}
SEED_CHECKING_FRAME_3 = 3100000019   # the seed's checked frame has two poses before it


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_under_the_harness_is_not_correct(fault, monkeypatch):
    import importlib

    mod_name, attr, make = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    seed = SEED_CHECKING_FRAME_3 if attr == "propagate_const_vel" else 4000000007
    r = tiny_run_of("synthetic_tum.orbit", seed)
    assert r["correct"] is False, r["checks"]
