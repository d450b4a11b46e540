"""The port's own state carried across two frames
(mm3dgs_slam_torch/slam/state.py): configs/synthetic.yml with bundle
adjustment on its JAX scene, cut as tests/test_torch_lockstep.py cuts it (4
frames at 2 tracking / 4 mapping iterations, keyframes added at frames 2
and 3). A run that exports after frame 1, saves and loads the state
without pickle and goes on in a new SLAM gives the bits of the run that
never stopped: results.npz, the PLY and the state after frame 3
(get_runtime_stats off: its wall-time averages are not state)."""
import os
from pathlib import Path

import numpy as np
import torch

from test_torch_lockstep import (CARRY_AFTER, assert_states_equal, cut_cfgs, finish, fresh,
                                 port_slam, through_npz)

torch.set_num_threads(1)


def test_carried_run_is_the_uncarried_run(tmp_path):
    from mm3dgs_slam_torch.models.ply_io import load_ply
    from mm3dgs_slam_torch.slam.state import export_state, restore_state

    _, cfg = cut_cfgs(tmp_path)
    cfg["debug"]["get_runtime_stats"] = False
    whole = port_slam(fresh(cfg, "whole"))
    for i in range(CARRY_AFTER + 1):
        whole._step(i)
    state = through_npz(export_state(whole))
    # the carry holds poses that are views of their frame's row
    assert (state["mapper.keyframes.pose_is_row"].any()
            or state["mapper.niqe_window.other.pose_is_row"].any())
    for i in range(CARRY_AFTER + 1, 4):
        whole._step(i)
    carried = port_slam(fresh(cfg, "carried"))
    restore_state(carried, state)
    assert_states_equal(export_state(carried), state)
    for i in range(CARRY_AFTER + 1, 4):
        carried._step(i)
    assert_states_equal(export_state(carried), export_state(whole))
    for s in (whole, carried):
        finish(s, 4)
    a = np.load(os.path.join(whole.output, "results.npz"), allow_pickle=True)
    b = np.load(os.path.join(carried.output, "results.npz"), allow_pickle=True)
    assert set(a.files) == set(b.files)
    for k in a.files:
        if k == "keyframes":
            assert len(a[k]) == len(b[k])
            for ka, kb in zip(a[k], b[k]):
                assert ka.keys() == kb.keys()
                for f in ka:
                    assert np.array_equal(np.asarray(ka[f]), np.asarray(kb[f])), f
        else:
            assert np.array_equal(a[k], b[k], equal_nan=True), k
    ply = lambda s: os.path.join(s.output, "point_cloud", "iteration_4",  # noqa: E731
                                 "point_cloud.ply")
    assert Path(ply(whole)).read_bytes() == Path(ply(carried)).read_bytes()
    assert load_ply(ply(whole))["xyz"].shape[0] == whole.gaussians.n > 0
