"""The port's bundle adjustment end to end against the JAX package on the
CPU, on tests/test_e2e_variants.py's tiny() config as in
test_torch_variants_e2e.py, with the port's debug video on; then the port
resuming from the checkpoint the JAX package wrote."""
import os

import cv2
import numpy as np
import pytest
import torch

from test_torch_variants_e2e import jax_scene, variant_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ba_pair(tmp_path_factory):
    return variant_pair(tmp_path_factory.mktemp("ba"), video=True, do_BA=True)


def test_whole_slice_ba_matches_jax(ba_pair):
    """Bundle adjustment: the window's poses move with the map and are
    written back to the keyframes and the frame's estimate."""
    tslam, jslam, tr, _, _ = ba_pair
    for tk, jk in zip(tslam.mapper.keyframes, jslam.mapper.keyframes):
        np.testing.assert_allclose(tk.pose, jk.pose, atol=1e-5, rtol=0)
    # frame 0's keyframe was in the window of frames 1-3: BA moved it
    assert np.abs(tslam.mapper.keyframes[0].pose - tr["pose_gt"][0]).max() > 1e-6


def test_debug_video_has_a_frame_per_tracked_frame(ba_pair):
    tslam, _, _, _, _ = ba_pair
    path = os.path.join(tslam.output, "debug_video.mp4")
    cap = cv2.VideoCapture(path)
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    # frames 1..n-1, each the 2x3 panel (rgb, render, error / three depths)
    assert shapes == [(2 * 48, 3 * 64, 3)] * (tslam.n_img - 1)


def test_port_resumes_from_a_jax_checkpoint(ba_pair):
    """The JAX package's last checkpoint (PLY and results.npz) read by the
    port: the map, the poses and the keyframes as saved, the covisibility
    graph as the JAX package rebuilds it, and the same evaluation."""
    from mm3dgs_slam_tpu.models.ply_io import load_ply as jload_ply
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM
    from mm3dgs_slam_torch.slam.slam import SLAM

    _, jslam0, _, jr, jcfg = ba_pair
    cfg = dict(jcfg, iteration=4)
    tslam = SLAM(cfg, device="cpu", scene=jax_scene(jslam0))
    jslam = JSLAM(cfg)
    ply = jload_ply(os.path.join(jcfg["outputdir"], "point_cloud", "iteration_4",
                                 "point_cloud.ply"))
    assert tslam.gaussians.n == ply["xyz"].shape[0] == int(jslam.gaussians.n_alive) > 0
    np.testing.assert_array_equal(tslam.gaussians.xyz.numpy(), ply["xyz"])
    np.testing.assert_array_equal(tslam.estimate_pose_list[:4], jr["pose_est"])
    assert [k.idx for k in tslam.mapper.keyframes] == [k["idx"] for k in jr["keyframes"]]
    for tk, saved in zip(tslam.mapper.keyframes, jr["keyframes"]):
        np.testing.assert_array_equal(tk.pose, saved["est_pose"])
    assert dict(tslam.mapper.covisibility_graph) == dict(jslam.mapper.covisibility_graph)
    psnrs, ssims, lpipss, proxies = tslam.evaluate_images(4)
    np.testing.assert_allclose(psnrs, jr["psnr_list"], atol=0.05)
    assert np.isfinite(ssims).all() and np.isfinite(proxies).all()
