"""The port's splatam method end to end against the JAX package on the CPU,
on tests/test_e2e_variants.py's tiny() config (4 frames at 48x64, 6/10
iterations) with the JAX binning caps raised so that its bins hold every
pair, as the port's exactly sized bins do (test_torch_ba.py runs bundle
adjustment the same way)."""
import os

import numpy as np
import torch

from test_e2e import make_cfg
from test_e2e_variants import tiny
from test_torch_slam import RESULT_KEYS

torch.set_num_threads(1)


def _cfg(root, method="vigs", do_BA=False):
    cfg = tiny(make_cfg(root, method=method))
    cfg["mapping"]["do_BA"] = do_BA
    # every pair fits: 12 is all of 48x64's tiles, a pair_cap breach sets the
    # overflow flag that variant_pair checks, and the longest tile segment of
    # these runs holds ~400 pairs (each cap costs the JAX plain path its size)
    cfg["tpu"].update(pair_cap=1 << 15, max_per_tile=768, max_tiles_per_gaussian=12)
    return cfg


def jax_scene(jslam) -> dict:
    """The JAX run's synthetic scene as the port's `scene` argument (the two
    generators draw different scenes from one seed)."""
    from mm3dgs_slam_tpu.ops.sh import sh_to_rgb

    sc = jslam.dataset.scene
    scene = dict(xyz=sc.xyz, scales=sc.scales, rotations=sc.rotations, opacity=sc.opacity,
                 rgb=sh_to_rgb(sc.shs[:, 0, :]))
    return {k: np.asarray(v) for k, v in scene.items()}


def variant_pair(root, video=False, **kw):
    """Both packages on one synthetic scene; (port SLAM, JAX SLAM, port
    results, JAX results, JAX config)."""
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM
    from mm3dgs_slam_torch.slam.slam import SLAM

    jcfg, tcfg = _cfg(root / "jax", **kw), _cfg(root / "torch", **kw)
    tcfg["debug"]["create_video"] = video
    jslam = JSLAM(jcfg)
    tslam = SLAM(tcfg, device="cpu", scene=jax_scene(jslam))
    jslam.run()
    tslam.run()
    assert tslam.failed is None
    jr = np.load(os.path.join(jcfg["outputdir"], "results.npz"), allow_pickle=True)
    tr = np.load(os.path.join(tcfg["outputdir"], "results.npz"), allow_pickle=True)
    assert set(tr.files) == set(jr.files) == RESULT_KEYS
    assert len(jr["binning_overflow_frames"]) == 0
    assert [kf.idx for kf in tslam.mapper.keyframes] == [kf.idx for kf in jslam.mapper.keyframes]
    np.testing.assert_allclose(tr["pose_gt"], jr["pose_gt"], atol=1e-6)
    np.testing.assert_allclose(tr["pose_est"], jr["pose_est"], atol=1e-5, rtol=0)
    assert tslam.gaussians.n == int(jslam.gaussians.n_alive)
    np.testing.assert_allclose(tr["psnr_list"], jr["psnr_list"], atol=0.05)
    assert np.isnan(tr["lpips_list"]).all() and np.isnan(jr["lpips_list"]).all()
    assert np.isfinite(tr["lpips_proxy_list"]).all()
    np.testing.assert_allclose(tr["lpips_proxy_list"], jr["lpips_proxy_list"], rtol=0.05)
    return tslam, jslam, tr, jr, jcfg


def test_whole_slice_splatam_matches_jax(tmp_path):
    """splatam tracking (kernel 3 at nc 6), mapping (kernel 2 at nc 4),
    keyframes every kf_every frames and the depth-overlap window."""
    tslam, _, tr, _, _ = variant_pair(tmp_path, method="splatam")
    assert [kf.idx for kf in tslam.mapper.keyframes] == [0, 1, 2, 3]
    assert np.abs(np.diff(tr["pose_est"], axis=0)).max() > 1e-3
