"""`tpu.max_new_per_frame` in the port as in the JAX package, which reads
the key and never applies it: configs/synthetic.yml at 48x64, 2 frames,
2 / 4 iterations, both packages on one scene (the JAX run's), with the key
at 50, below frame 0's candidate count. Each frame's decisions are recorded
by tests/lockstep.py."""
import numpy as np
import torch

from test_torch_lockstep import jax_slam, steps
from test_torch_synthetic import POSE_ATOL, synthetic_cfgs

torch.set_num_threads(1)


def test_max_new_per_frame_is_ignored_as_in_jax(tmp_path):
    from test_torch_variants_e2e import jax_scene

    from mm3dgs_slam_torch.slam.slam import SLAM

    jcfg, tcfg = synthetic_cfgs(tmp_path, False, early_stop_idx=2, tracking=2, mapping=4)
    for c in (jcfg, tcfg):
        c["desired_height"], c["desired_width"] = 48, 64
        c["tpu"]["max_new_per_frame"] = 50
    jslam = jax_slam(jcfg)
    tslam = SLAM(tcfg, device="cpu", scene=jax_scene(jslam))
    jrec, trec = steps(jslam, range(2)), steps(tslam, range(2))
    for s in (jslam, tslam):
        s._frames.close()
    assert jrec[0]["candidates"] > 50
    assert [r["appended"] for r in trec] == [r["appended"] for r in jrec]
    assert [r["candidates"] for r in trec] == [r["candidates"] for r in jrec]
    assert tslam.gaussians.n == int(jslam.gaussians.n_alive)
    np.testing.assert_allclose(tslam.estimate_pose_list, jslam.estimate_pose_list,
                               atol=POSE_ATOL, rtol=0)
