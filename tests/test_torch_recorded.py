"""Whole-slice pair runs of the recorded-dataset path: the JAX package and
the port on one written sequence of each new layout, then the port's eval
CLIs on the port's output.

  * TUM (configs/TUM.yml's settings at a tenth of 640x480, 48x64):
    monocular with TinyDPT (assets/tiny_dpt_synthetic.npz), crop_edge 8, the
    tum_heuristic depth anchor, the depth-estimate loss in mapping, NIQE
    keyframes, and debug.save_keyframes on;
  * Replica (configs/replica.yml's settings, written at 80x112 and read at
    40x56: a partial tile column and row, as 600x340 has), GT depth, JPEG
    frames.

Each at 3 / 4 tracking / mapping iterations on 3 frames, pose_est held at
atol 1e-5 as the other pair runs are. The JAX package's binning caps are
raised so that its bins hold every pair of a map seeded one Gaussian per
pixel, as the port's exactly sized bins do."""
import os

import cv2
import numpy as np
import pytest
import torch
import yaml

from test_torch_slam import RESULT_KEYS

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_FRAMES = 3


def recorded_cfg(layout: str, root: str, out: str) -> dict:
    """configs/TUM.yml or configs/replica.yml cut to a test size."""
    name = {"tum": "TUM.yml", "replica": "replica.yml"}[layout]
    with open(os.path.join(ROOT, "configs", name)) as f:
        cfg = yaml.safe_load(f)
    cam = cfg["cam"]
    if layout == "tum":
        scale, (h, w) = 0.1, (48, 64)
        cam.update(image_height=h, image_width=w)
        cfg.update(dpt_model="tiny_dpt",
                   dpt_weights=os.path.join(ROOT, "assets", "tiny_dpt_synthetic.npz"))
        cfg["debug"]["save_keyframes"] = True
    else:
        scale, (h, w) = 112 / 1200, (40, 56)
        cam.update(image_height=2 * h, image_width=2 * w)
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= scale
    cfg.update(inputdir=root, scene="seq", outputdir=out, desired_height=h, desired_width=w,
               save_iterations=[], eval_every=1,
               synthetic={"n_gaussians": 300, "seed": 0, "orbit_radius": 0.12})
    cfg["tracking"]["iters"] = 3
    cfg["mapping"].update(iters=4, niqe_window_size=2, kf_every=1, pruning_interval=3)
    cfg["tpu"].update(pair_cap=1 << 14, max_per_tile=512, max_tiles_per_gaussian=16,
                      rebin_every=1, map_rebin_every=1, use_pallas="never")
    return cfg


def _pair(tmp, layout):
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM
    from mm3dgs_slam_torch.data.synthetic_recorded import (write_synthetic_replica,
                                                           write_synthetic_tum)
    from mm3dgs_slam_torch.slam.slam import SLAM

    root = str(tmp / "data")
    writer = write_synthetic_tum if layout == "tum" else write_synthetic_replica
    writer(os.path.join(root, "seq"), recorded_cfg(layout, root, None), N_FRAMES)
    jslam = JSLAM(recorded_cfg(layout, root, str(tmp / "jax")))
    tslam = SLAM(recorded_cfg(layout, root, str(tmp / "torch")), device="cpu")
    jslam.run()
    tslam.run()
    jr = np.load(tmp / "jax" / "results.npz", allow_pickle=True)
    tr = np.load(tmp / "torch" / "results.npz", allow_pickle=True)
    return tslam, jslam, tr, jr


@pytest.fixture(scope="module")
def tum_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tum")
    return (tmp, *_pair(tmp, "tum"))


@pytest.fixture(scope="module")
def replica_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replica")
    return (tmp, *_pair(tmp, "replica"))


def _check_pair(tslam, jslam, tr, jr):
    assert tslam.failed is None
    # the frame loop read through the prefetcher, which run() closed
    assert tslam._frames.dataset is tslam.dataset and not tslam._frames.enabled
    assert set(tr.files) == set(jr.files) == RESULT_KEYS
    assert len(jr["binning_overflow_frames"]) == 0
    assert tr["pose_est"].shape == (N_FRAMES, 7)
    np.testing.assert_allclose(tr["pose_gt"], jr["pose_gt"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(tr["pose_est"], jr["pose_est"], atol=1e-5, rtol=0)
    assert [kf.idx for kf in tslam.mapper.keyframes] == [kf.idx for kf in jslam.mapper.keyframes]
    np.testing.assert_allclose(tr["psnr_list"], jr["psnr_list"], atol=0.05)
    assert abs(float(tr["ate_rmse"]) - float(jr["ate_rmse"])) < 1e-5
    # the tracker moved the frames away from their seeds
    assert np.abs(np.diff(tr["pose_est"], axis=0)).max() > 1e-3


def test_whole_slice_tum_matches_jax(tum_pair):
    """Monocular TUM: TinyDPT's estimate anchored by tum_heuristic on frame
    0, then by the LS fit against the map's render; the keyframes' scaled
    estimates held at rtol 1e-4, atol 1e-5 of the JAX package's."""
    _, tslam, jslam, tr, jr = tum_pair
    _check_pair(tslam, jslam, tr, jr)
    assert tslam.cfg["depth_fit"] is None and tslam.cfg["cam"]["crop_edge"] == 8
    for tk, jk in zip(tr["keyframes"], jr["keyframes"]):
        np.testing.assert_allclose(tk["est_depth"], jk["est_depth"], rtol=1e-4, atol=1e-5)


def test_save_keyframes_pngs_match_jax(tum_pair):
    """debug.save_keyframes: one PNG per keyframe in <outputdir>/keyframes,
    the same names and pixels as the JAX package's (imageio there, cv2
    here), each clip(gt_color, 0, 1) * 255 of its keyframe."""
    tmp, tslam, _, tr, _ = tum_pair
    names = sorted(os.listdir(tmp / "torch" / "keyframes"))
    assert names == sorted(os.listdir(tmp / "jax" / "keyframes"))
    assert names == [f"{kf.idx:05d}.png" for kf in tslam.mapper.keyframes]
    for name, kf in zip(names, tr["keyframes"]):
        got = cv2.imread(str(tmp / "torch" / "keyframes" / name))[:, :, ::-1]
        want = cv2.imread(str(tmp / "jax" / "keyframes" / name))[:, :, ::-1]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, (np.clip(kf["gt_color"], 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0))


def test_whole_slice_replica_matches_jax(replica_pair):
    """Replica at 40x56 (3 x 3 tiles, the last column 8 pixels wide, as at
    600x340): JPEG frames, GT depth."""
    _, tslam, jslam, tr, jr = replica_pair
    assert tslam.rs.cam.width % 16 == 8 and tslam.rs.cam.tiles_x == 4
    _check_pair(tslam, jslam, tr, jr)


def _write_cfg(tmp, cfg) -> str:
    path = str(tmp / "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_eval_cli_on_the_replica_run(replica_pair, capsys):
    """eval_traj's ATE equals results.npz's; eval_image re-renders the run
    from its saved map and poses (--device cpu) and reproduces its PSNR and
    SSIM."""
    from mm3dgs_slam_torch.scripts import eval_image, eval_traj

    tmp, _, _, tr, _ = replica_pair
    path = _write_cfg(tmp, recorded_cfg("replica", str(tmp / "data"), str(tmp / "torch")))
    t = eval_traj.main(["--config", path])
    assert abs(t["ate_w2c"] - float(tr["ate_rmse"])) <= 1e-9
    assert np.isfinite(t["ate_c2w"])
    assert os.path.isfile(tmp / "torch" / "trajectory_plot.png")
    psnrs, ssims, lpipss, proxies = eval_image.main(
        ["--config", path, "--iteration", str(N_FRAMES), "--device", "cpu"])
    np.testing.assert_allclose(psnrs, tr["psnr_list"], atol=1e-4)
    np.testing.assert_allclose(ssims, tr["ssim_list"], atol=1e-5)
    np.testing.assert_allclose(proxies, tr["lpips_proxy_list"], rtol=1e-4)
    out = capsys.readouterr().out
    assert "ATE RMSE (w2c pose vectors)" in out and "PSNR :" in out


def test_ceiling_psnr_of_the_written_layouts(tmp_path):
    """The data's own PSNR ceiling (synthetic_recorded.ceiling_psnr: each
    loaded frame against the oracle's render of the writing scene at the
    loader's camera and GT pose). TUM's frames are lossless PNGs at the
    native size, so they lose only the 8-bit rounding: every pixel within
    half a level, at least 20 log10(2 x 255) = 54.15 dB. Replica's are JPEGs
    read at half their written size, and lose more than that."""
    from mm3dgs_slam_torch.config import normalize_config
    from mm3dgs_slam_torch.data.synthetic_recorded import (ceiling_psnr, write_synthetic_replica,
                                                           write_synthetic_tum)

    ceil = {}
    for layout, writer in (("tum", write_synthetic_tum), ("replica", write_synthetic_replica)):
        root = str(tmp_path / layout)
        cfg = normalize_config(recorded_cfg(layout, root, None))
        writer(os.path.join(root, "seq"), cfg, N_FRAMES)
        ceil[layout] = ceiling_psnr(cfg)
        assert len(ceil[layout]) == N_FRAMES and np.isfinite(ceil[layout]).all()
    assert min(ceil["tum"]) >= 20 * np.log10(2 * 255)
    assert max(ceil["replica"]) < min(ceil["tum"])
