"""The port's bench, its golden scenes and the per-frame wall decomposition
held against the JAX package on the CPU.

  * the shipped JAX scenes (mm3dgs_slam_torch/assets/jax_scene_<config>.npz)
    bit-equal to what the JAX package's `_make_scene` draws for
    configs/synthetic_tum.yml, configs/synthetic_hard.yml and
    configs/synthetic.yml, and frame 0 of
    both oracles on them at the image tolerance; run this file as a script
    to write the assets again (`python tests/test_torch_bench.py`),
  * `mm3dgs_slam_torch.bench`'s scene, GT, one tracking call and one mapping
    call against the JAX bench's (`__graft_entry__._build_scene`,
    `track_frame`, `optimize_map` with bench.py's settings) on the same
    random draws, at 64x80,
  * `debug.frame_decomp` through the port's run_golden (--scene, --decomp,
    --frames) against the JAX package's on a 2-frame 48x64 run.

The JAX side runs its XLA compositor at `highest` precision (tests/conftest.py);
the port runs the plain versions of its kernels."""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mm3dgs_slam_tpu.data.synthetic import _make_scene
from mm3dgs_slam_tpu.ops.camera import Camera as JCamera

from mm3dgs_slam_torch import bench
from mm3dgs_slam_torch.data.synthetic import jax_scene_path, load_scene

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SCENE_KEYS = ("xyz", "scales", "rotations", "opacity", "shs")
GOLDEN_CONFIGS = ("synthetic_tum", "synthetic_hard", "synthetic")


def _config_camera(cfg):
    c = cfg["cam"]
    h, w = cfg["desired_height"], cfg["desired_width"]
    rh, rw = h / c["image_height"], w / c["image_width"]
    return JCamera(height=h, width=w, fx=c["fx"] * rw, fy=c["fy"] * rh,
                   cx=c["cx"] * rw, cy=c["cy"] * rh)


def export_jax_scene(name: str) -> dict:
    """The JAX package's scene of configs/<name>.yml (its SyntheticDataset's
    `_make_scene` call) as float32 numpy arrays."""
    cfg = yaml.safe_load((ROOT / "configs" / f"{name}.yml").read_text())
    syn = cfg["synthetic"]
    g = _make_scene(jax.random.PRNGKey(int(syn.get("seed", 0))), int(syn["n_gaussians"]),
                    _config_camera(cfg), textured=bool(syn.get("textured", False)),
                    occluders=int(syn.get("occluders", 0)))
    return {k: np.asarray(getattr(g, k), np.float32) for k in SCENE_KEYS}


@pytest.mark.parametrize("name", GOLDEN_CONFIGS)
def test_jax_scene_asset_matches_jax(name):
    """The asset holds JAX's arrays bit for bit, and frame 0 (the identity
    pose) of both oracles agrees on it, over a 64x96 window at the image
    centre (the oracles' cost grows with the image; the window sees ~600 of
    the 20,000 Gaussians)."""
    from mm3dgs_slam_tpu.ops.oracle import composite_oracle as joracle
    from mm3dgs_slam_tpu.ops.render import ActivatedGaussians as JAG
    from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS
    from mm3dgs_slam_tpu.ops.render import project_for_pose as jproject

    from mm3dgs_slam_torch.data.synthetic import scene_gaussians
    from mm3dgs_slam_torch.ops.camera import Camera
    from mm3dgs_slam_torch.ops.oracle import composite_oracle
    from mm3dgs_slam_torch.ops.render import RenderSettings, project_for_pose

    want, got = export_jax_scene(name), load_scene(jax_scene_path(name))
    assert set(got) == set(SCENE_KEYS)
    for k in SCENE_KEYS:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k

    full = _config_camera(yaml.safe_load((ROOT / "configs" / f"{name}.yml").read_text()))
    h, w = 64, 96
    ox, oy = (full.width - w) // 2, (full.height - h) // 2
    win = dict(height=h, width=w, fx=full.fx, fy=full.fy, cx=full.cx - ox, cy=full.cy - oy)
    pose = np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)
    jg = JAG(**{k: jnp.asarray(v) for k, v in want.items()},
             alive=jnp.ones(want["xyz"].shape[0], bool))
    jimg = np.asarray(joracle(jproject(jg, jnp.asarray(pose), JRS(cam=JCamera(**win))),
                              JCamera(**win), jnp.zeros(6)))
    cam = Camera(**win)
    timg = composite_oracle(project_for_pose(scene_gaussians(got), torch.as_tensor(pose),
                                             RenderSettings(cam=cam)), cam,
                            torch.zeros(6)).numpy()
    assert (jimg[4] > 0.5).mean() > 0.9  # the window is covered
    np.testing.assert_allclose(timg, jimg, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------- the bench
N, HW = 2048, (64, 80)


def _jax_bench_settings(cam):
    from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS

    # bench.py's caps (use_pallas off on the CPU); every pair fits
    return JRS(cam=cam, pair_cap=1 << 20, max_per_tile=1024, chunk=32,
               max_tiles_per_gaussian=16, use_pallas=False, bin_d1=4, bin_big_frac=12,
               bin_d2_live=8, grad_bf16=False)


@pytest.fixture(scope="module")
def bench_pair():
    """JAX's bench scene and GT at 64x80 and the port's on the same draws."""
    from __graft_entry__ import _build_scene
    from mm3dgs_slam_tpu.ops.render import render as jrender

    jm, jcam = _build_scene(N, cam_hw=HW)
    ks = jax.random.split(jax.random.PRNGKey(0), 6)   # _build_scene's draws
    h, w = HW
    draws = dict(z=jax.random.uniform(ks[0], (N,), minval=1.5, maxval=5.0),
                 px=jax.random.uniform(ks[1], (N,), minval=0.0, maxval=float(w)),
                 py=jax.random.uniform(ks[2], (N,), minval=0.0, maxval=float(h)),
                 rgb=jax.random.uniform(ks[3], (N, 3)))
    draws = {k: np.asarray(v) for k, v in draws.items()}
    m, cam = bench.build_scene(N, HW, arrays=draws, device="cpu")
    jrs = _jax_bench_settings(jcam)
    out = jrender(jm.activated(), jnp.asarray(bench.IDENTITY, jnp.float32), jrs)
    assert not bool(out["bins"].overflow)
    jgt = (np.asarray(jnp.clip(out["render"], 0, 1)),
           np.asarray(out["depth"][0] / jnp.maximum(out["depth"][1], 1e-6)))
    return jm, jrs, jgt, m, cam


def test_bench_scene_and_gt_match_jax(bench_pair):
    from mm3dgs_slam_tpu.models.gaussians import _PARAM_FIELDS

    jm, _, jgt, m, cam = bench_pair
    assert (cam.height, cam.width, cam.fx, cam.cx) == (64, 80, 70.0, 39.5)
    for f in _PARAM_FIELDS:
        np.testing.assert_allclose(getattr(m, f).numpy(), np.asarray(getattr(jm, f)),
                                   atol=1e-6, rtol=1e-6, err_msg=f)
    _, _, gt_color, gt_depth = bench.make_inputs(m, cam)
    np.testing.assert_allclose(gt_color.numpy(), jgt[0], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(gt_depth.numpy(), jgt[1], atol=2e-4, rtol=1e-4)
    # the draws are numpy's by default, and seeded
    a, b = bench.build_scene(64, HW, device="cpu"), bench.build_scene(64, HW, device="cpu")
    assert torch.equal(a[0].xyz, b[0].xyz)


def _port_inputs(m, cam, jgt):
    """The port's bench inputs with JAX's GT, so both sides see one target."""
    rs, base, _, _ = bench.make_inputs(m, cam)
    return rs, base, torch.as_tensor(jgt[0]), torch.as_tensor(jgt[1])


def test_bench_track_once_matches_jax(bench_pair):
    from mm3dgs_slam_tpu.slam.tracker import TrackSettings as JTS
    from mm3dgs_slam_tpu.slam.tracker import track_frame as jtrack_frame

    jm, jrs, jgt, m, cam = bench_pair
    iters = 5
    seed = np.array(bench.IDENTITY, np.float32)
    seed[4] += 1e-3   # rep 0's jitter
    jpose, jloss, jovf = jtrack_frame(
        jm.activated(), jnp.asarray(seed), jnp.asarray(jgt[0]), jnp.asarray(jgt[1]),
        jnp.zeros_like(jgt[1]),
        JTS(rs=jrs, iters=iters, method="vigs", use_gt_depth=True, position_lr=0.001,
            rotation_lr=0.003, rebin_every=10))
    assert not bool(jovf)
    pose, loss = bench.track_once(m, _port_inputs(m, cam, jgt), 0, iters)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), rtol=5e-4, atol=5e-4 * 1e-3)
    # Adam moves each pose entry by about its lr per step
    assert np.abs(pose.numpy() - seed).max() <= iters * 0.003 + 1e-6
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


def test_bench_map_once_matches_jax(bench_pair):
    """8 iterations over K = 8 keyframes on the grouped schedule (a prune
    at iteration 0, then one iteration per keyframe, a rebin each), as rep
    49 runs them: its keyframe poses 5 mm from the GT's. (Rep 0's 0.1 mm
    leaves the render within ~1e-4 of the GT, so the gradients are float
    noise that Adam turns into full steps of either sign in the two
    packages.)"""
    from mm3dgs_slam_tpu.models import gaussians as JG
    from mm3dgs_slam_tpu.slam.map_opt import MapCarry, MapOptSettings, optimize_map

    jm, jrs, jgt, m, cam = bench_pair
    iters, k, rep = 8, bench.K, 49
    cap = jm.capacity
    poses = jnp.tile(jnp.asarray(bench.IDENTITY, jnp.float32)[None], (k, 1))
    poses = poses.at[:, 4].add(1e-4 * (rep + 1))   # bench.py's carry(rep + 1)
    carry = MapCarry(m=jm, adam=JG.init_adam(jm), max_radii=jnp.zeros(cap),
                     grad_accum=jnp.zeros(cap), denom=jnp.zeros(cap),
                     ba_mask=jnp.ones(cap, bool), kf_poses=poses, pose_m=jnp.zeros((k, 7)),
                     pose_v=jnp.zeros((k, 7)), pose_step=jnp.asarray(0, jnp.int32),
                     last_loss=jnp.asarray(0.0, jnp.float32))
    hyper = JG.MapOptHyper(*bench.HYPER)
    jms = MapOptSettings(rs=jrs, iters=iters, method="vigs", use_gt_depth=True,
                         lambda_dssim=0.2, hyper=hyper, rebin_every=25)
    schedule = jnp.sort(jnp.arange(iters, dtype=jnp.int32) % k)
    colors = jnp.tile(jnp.asarray(jgt[0])[None], (k, 1, 1, 1))
    depths = jnp.tile(jnp.asarray(jgt[1])[None], (k, 1, 1))
    jout, jovf = optimize_map(carry, colors, depths, jnp.zeros_like(depths), schedule,
                              jnp.asarray(bench.EXTENT, jnp.float32), jms)
    assert not bool(jovf)
    st = bench.map_once(m, _port_inputs(m, cam, jgt), rep, iters, k)
    n = int(jout.m.n_alive)
    assert st.m.n == n == N   # logit-0 pixel-scale surfels: the prune keeps all
    np.testing.assert_allclose(float(st.last_loss), float(jout.last_loss), rtol=1e-4)
    steps = iters - 1   # iteration 0 prunes, and its Adam step is a no-op
    for f in JG._PARAM_FIELDS:
        a, b = getattr(st.m, f).numpy(), np.asarray(getattr(jout.m, f))[:n]
        err = np.abs(a - b)
        assert (err <= 2 * steps * getattr(hyper, "lr_" + f) + 1e-6).all(), f
        if f != "rotation":   # isotropic surfels: rotation gradients are float noise
            assert (err <= 1e-5 + 1e-3 * np.abs(b)).all(), f
    np.testing.assert_array_equal(st.denom.numpy(), np.asarray(jout.denom)[:n])


def test_bench_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() != 0
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and err.out == ""


# ----------------------------------------------- run_golden and frame_decomp
def _decomp_cfg(root):
    from test_e2e import make_cfg

    cfg = make_cfg(root)
    cfg.update(desired_height=48, desired_width=64)
    cfg["tracking"]["iters"] = 3
    cfg["mapping"]["iters"] = 4
    cfg["tpu"].update(pair_cap=1 << 15, max_per_tile=768, max_tiles_per_gaussian=12)
    return cfg


def test_frame_decomp_through_run_golden_matches_jax(tmp_path):
    """run_golden --scene --decomp --frames 2 --device cpu against the JAX
    package's SLAM on the same config and scene: the same phases, the same
    results.npz keys, each frame's row within its wall time, and the poses."""
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM

    from mm3dgs_slam_torch.scripts import run_golden

    jcfg = _decomp_cfg(tmp_path / "jax")
    jcfg["synthetic"]["n_frames"] = 2
    jcfg["debug"]["frame_decomp"] = True
    jslam = JSLAM(jcfg)
    sc = jslam.dataset.scene
    np.savez(tmp_path / "scene.npz", **{k: np.asarray(getattr(sc, k)) for k in SCENE_KEYS})
    jslam.run()

    tcfg = _decomp_cfg(tmp_path / "torch")
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(tcfg))
    seen = []
    real_run = run_golden.run
    run_golden.run = lambda *a, **k: seen.append(real_run(*a, **k)) or seen[-1]
    try:
        rc = run_golden.main(["--config", str(tmp_path / "cfg.yml"), "--decomp",
                              "--frames", "2", "--scene", str(tmp_path / "scene.npz"),
                              "--device", "cpu"])
    finally:
        run_golden.run = real_run
    assert rc == 0
    (tslam,) = seen
    jr = np.load(os.path.join(jcfg["outputdir"], "results.npz"), allow_pickle=True)
    tr = np.load(os.path.join(tcfg["outputdir"], "results.npz"), allow_pickle=True)
    assert set(tr.files) == set(jr.files)
    assert {"frame_decomp", "frame_decomp_phases", "frame_decomp_rows"} <= set(tr.files)
    assert set(tr["frame_decomp_phases"]) == set(jr["frame_decomp_phases"])
    assert set(tr["frame_decomp"].item()) == set(jr["frame_decomp"].item())
    rows = tr["frame_decomp_rows"]
    assert rows.shape == (2, len(tr["frame_decomp_phases"])) == jr["frame_decomp_rows"].shape
    assert (rows >= 0).all() and (rows.sum(1) <= np.asarray(tslam.frame_seconds)).all()
    totals = tr["frame_decomp"].item()
    for j, name in enumerate(tr["frame_decomp_phases"]):
        assert rows[:, j].sum() == pytest.approx(totals[name], rel=1e-9, abs=1e-12)
    np.testing.assert_allclose(tr["pose_est"], jr["pose_est"], atol=1e-5, rtol=0)


def test_profiler_dir_writes_a_trace(tmp_path):
    from mm3dgs_slam_torch.slam.slam import SLAM

    cfg = _decomp_cfg(tmp_path)
    cfg["synthetic"]["n_frames"] = 1
    cfg["debug"]["jax_profiler_dir"] = str(tmp_path / "trace")
    slam = SLAM(cfg, device="cpu")
    slam.run()
    assert slam.failed is None
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"traceEvents"' in trace and '"_CompositePacked"' in trace


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name in GOLDEN_CONFIGS:
        np.savez(jax_scene_path(name), **export_jax_scene(name))
        print("wrote", jax_scene_path(name))
