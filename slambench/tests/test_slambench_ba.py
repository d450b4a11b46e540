"""The check under bundle adjustment, on the CPU at the orbit's tiny size with
mapping.do_BA set: sound runs stay within the orbit's limits on the numbers
every cell compares, and the bfloat16 control and each fault planted in
the program's bundle adjustment read at least ten times the sound runs'
largest reading on one of the two BA numbers (ba_mask_gap,
map_pose_step_gap). No cell runs BA yet, so these numbers have no limits
of their own here: a BA cell's come from `python3 -m slambench.control`
on the card (README.md).

    python -m pytest slambench/tests/test_slambench_ba.py -q
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slambench import check, harness
from slambench import scene as sc
from slambench.tests.conftest import tiny_spec

SEED_FRAME_1 = 4000000007    # these seeds check frame 1 and frame 3
SEED_FRAME_3 = 3100000019
SOUND = (SEED_FRAME_1, SEED_FRAME_3, 4000000037)
CHECK_FRAME = {SEED_FRAME_1: 1, SEED_FRAME_3: 3, "near": 3}
NEAR_DEPTH = 0.17            # m: the near rows' depth in frame 0
_runs: dict = {}


def _ba_spec() -> dict:
    spec = tiny_spec("synthetic_tum.orbit")
    spec["config"]["config"]["mapping"]["do_BA"] = True
    return spec


def _near_rows(monkeypatch):
    """Frame 0 sees a near patch (its top-left 12x16 pixels at NEAR_DEPTH),
    so the map gets rows that frame 0's pose culls (in front of a camera
    means beyond 0.2 m) and frame 3's tracked pose, some 5 cm further back,
    sees: rows seen from one window pose alone. The orbit's map is otherwise
    seen whole from every window pose, and its BA mask is every row."""
    init = sc.SyntheticSequence.__init__

    def __init__(self, *args, **kw):
        init(self, *args, **kw)
        self.clean[0][1][:12, :16] = NEAR_DEPTH   # frames[0] holds the same array
    monkeypatch.setattr(sc.SyntheticSequence, "__init__", __init__)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(seed: int, control: bool = False) -> dict:
    return harness.run_cell(_ba_spec(), seed, 0.01, False, "cpu", control=control)


def _sound(key) -> dict:
    """The sound run of `key` (a seed, or "near": SEED_FRAME_3 with the near
    rows), once per session; the first seed's with the control."""
    if key not in _runs:
        if key == "near":
            with pytest.MonkeyPatch.context() as mp:
                _near_rows(mp)
                _runs[key] = _run(SEED_FRAME_3)
        else:
            _runs[key] = _run(key, control=key == SOUND[0])
    return _runs[key]


def _sound_max(name: str) -> float:
    return max(_sound(k)["readings"]["program"][name] for k in SOUND + ("near",))


@pytest.mark.parametrize("key", SOUND + ("near",))
def test_sound_ba_run_within_the_orbits_limits(key):
    r = _sound(key)
    if key in CHECK_FRAME:
        assert r["check_frame"] == CHECK_FRAME[key]
    orbit = tiny_spec("synthetic_tum.orbit")
    shared = check.numbers_for(orbit["config"]["config"])
    ok, rows = check.judge(r["readings"]["program"], orbit["limits"], shared)
    assert ok, rows
    names = check.numbers_for(_ba_spec()["config"]["config"])
    assert set(names) - set(shared) == set(check.BA_NUMBERS)
    for name in check.BA_NUMBERS:
        assert np.isfinite(r["readings"]["program"][name]), name
    # a mask the reference agrees with, also where it leaves rows out
    assert r["readings"]["program"]["ba_mask_gap"] == 0.0


def _reads_10x(numbers: dict) -> dict:
    """The BA numbers with their ratio to the sound runs' largest reading."""
    return {k: (numbers[k], _sound_max(k)) for k in check.BA_NUMBERS}


def _separates(numbers: dict) -> bool:
    return any(v > 0 and v >= 10 * lower for v, lower in _reads_10x(numbers).values())


def test_bfloat16_control_reads_10x_the_sound_runs():
    control = _sound(SOUND[0])["readings"]["control"]
    assert _separates(control), _reads_10x(control)


def _pose_adam_skips_prunes(monkeypatch):
    import mm3dgs_slam_torch.slam.map_opt as map_opt

    it = {}
    grad_and_stats, pose_adam = map_opt._grad_and_stats, map_opt.pose_adam

    def _grad_and_stats(st, bins, pose, i, *args, **kw):
        it["i"] = i
        return grad_and_stats(st, bins, pose, i, *args, **kw)

    def _pose_adam(pa, k, g_pose, ms):
        return pa if map_opt.is_prune_iter(it["i"], ms) else pose_adam(pa, k, g_pose, ms)
    monkeypatch.setattr(map_opt, "_grad_and_stats", _grad_and_stats)
    monkeypatch.setattr(map_opt, "pose_adam", _pose_adam)


def _pose_lrs_swapped(monkeypatch):
    import mm3dgs_slam_torch.slam.map_opt as map_opt

    pose_adam = map_opt.pose_adam

    def _pose_adam(pa, k, g_pose, ms):
        return pose_adam(pa, k, g_pose, ms._replace(cam_q_lr=ms.cam_t_lr, cam_t_lr=ms.cam_q_lr))
    monkeypatch.setattr(map_opt, "pose_adam", _pose_adam)


def _pose_no_bias_correction(monkeypatch):
    import mm3dgs_slam_torch.slam.map_opt as map_opt

    def _pose_adam(pa, k, g_pose, ms):
        gp = torch.zeros_like(pa.poses)
        gp[k] = g_pose
        m = 0.9 * pa.m + 0.1 * gp
        v = 0.999 * pa.v + 0.001 * gp * gp
        lr = torch.tensor([ms.cam_q_lr] * 4 + [ms.cam_t_lr] * 3, device=pa.poses.device)
        return map_opt.PoseAdam(pa.poses - lr * m / (torch.sqrt(v) + 1e-15), m, v, pa.step + 1)
    monkeypatch.setattr(map_opt, "pose_adam", _pose_adam)


def _mask_min_kf_1(monkeypatch):
    import mm3dgs_slam_torch.slam.mapper as mapper

    _near_rows(monkeypatch)
    mask = mapper.covisible_gaussian_mask

    def covisible_gaussian_mask(g, poses, rs, min_kf=2):
        return mask(g, poses, rs, 1)
    monkeypatch.setattr(mapper, "covisible_gaussian_mask", covisible_gaussian_mask)


FAULTS = {
    "the pose Adam skipped on the prune iteration": (_pose_adam_skips_prunes, SEED_FRAME_1),
    "q's and T's learning rates swapped": (_pose_lrs_swapped, SEED_FRAME_1),
    "the pose step's bias corrections left out": (_pose_no_bias_correction, SEED_FRAME_1),
    "the BA mask from one window pose (min_kf 1)": (_mask_min_kf_1, SEED_FRAME_3),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_ba_fault_reads_10x_the_sound_runs(fault, monkeypatch):
    plant, seed = FAULTS[fault]
    plant(monkeypatch)
    numbers = _run(seed)["readings"]["program"]
    monkeypatch.undo()
    assert _separates(numbers), _reads_10x(numbers)
