"""The port's user tools held against the JAX package's on the CPU:
diff_results (the same lines and exit codes on the same run directories),
the PLY codec (native and numpy paths, the same bytes as JAX), capture and
restore across the two packages, TinyDPT's init, gradient and fit,
fit_niqe_model, the visualizer's controller and views, and the
train_tiny_dpt script."""
import importlib.util
import io
import re
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mm3dgs_slam_tpu.models import gaussians as JG
from mm3dgs_slam_tpu.models import ply_io as jply

from mm3dgs_slam_torch.eval.depth_est import TinyDPT
from mm3dgs_slam_torch.models import gaussians as TG
from mm3dgs_slam_torch.models import ply_io
from mm3dgs_slam_torch.scripts import diff_results, fit_niqe_model, visualizer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_e2e import make_cfg  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _run_jax_script(name, argv):
    """(exit code, stdout) of scripts/<name>.py run as __main__."""
    old, out, code = sys.argv, io.StringIO(), 0
    sys.argv = [name] + [str(a) for a in argv]
    try:
        with redirect_stdout(out):
            runpy.run_path(str(ROOT / "scripts" / f"{name}.py"), run_name="__main__")
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.argv = old
    return code, out.getvalue()


def _port_main(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        code = main([str(a) for a in argv])
    return code, out.getvalue()


def _map_arrays(n, rng, rest=1):
    return dict(xyz=rng.normal(size=(n, 3)), features_dc=rng.normal(size=(n, 1, 3)),
                features_rest=rng.normal(size=(n, rest, 3)), opacity=rng.normal(size=(n, 1)),
                scaling=rng.normal(size=(n, 3)) - 3, rotation=rng.normal(size=(n, 4)),
                rgb=rng.uniform(size=(n, 3)))


def _f32(d):
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


# ------------------------------------------------------------- diff_results
def _write_run(d: Path, poses, psnr, ssim, ate, ply):
    d.mkdir(parents=True)
    gt = poses.copy()
    np.savez(d / "results", pose_est=poses, pose_gt=gt, ate_rmse=ate, psnr_list=psnr,
             ssim_list=ssim, lpips_list=[float("nan")] * len(psnr))
    ply_io.save_ply(str(d / "point_cloud" / "iteration_4" / "point_cloud.ply"), **ply)


def test_diff_results_lines_and_exit_codes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 5)
    poses = np.stack([np.ones(5), 0.01 * t, 0 * t, 0 * t, 0.1 * t, 0.05 * t, 0.02 * t], 1)
    poses = poses.astype(np.float32)
    ply = _f32(_map_arrays(300, rng))
    _write_run(tmp_path / "a", poses, [30.0, 31.0], [0.95, 0.96], 0.004, ply)
    # b: within every tolerance; c: PSNR 3% off, another trajectory, a map
    # with 10% fewer Gaussians
    _write_run(tmp_path / "b", poses + rng.normal(0, 1e-4, poses.shape).astype(np.float32),
               [30.1, 31.05], [0.951, 0.96], 0.0045, ply)
    bent = poses.copy()
    bent[:, 4] += 0.05 * t ** 2
    _write_run(tmp_path / "c", bent, [29.0, 30.0], [0.95, 0.96], 0.02,
               {k: v[:270] for k, v in ply.items()})
    for other, want in (("b", 0), ("c", 1)):
        argv = [tmp_path / "a", tmp_path / other, "--rel-tol", 0.01]
        jcode, jout = _run_jax_script("diff_results", argv)
        tcode, tout = _port_main(diff_results.main, argv)
        assert jcode == tcode == want, (jout, tout)
        assert tout.splitlines() == jout.splitlines()
        assert "SKIP mean lpips" in tout and "[map PLY]" in tout


# ------------------------------------------------------------------ the PLY
@pytest.mark.parametrize("rest", [1, 3])
def test_ply_bytes_native_numpy_and_jax_agree(tmp_path, rest):
    """5,000 rows (the codec's threaded size), degree 0 and degree 1 SH."""
    arrays = _f32(_map_arrays(5000, np.random.default_rng(rest), rest))
    assert ply_io.native_loaded()   # the committed library needs an AVX-512 CPU
    ply_io.save_ply(str(tmp_path / "native.ply"), **arrays)
    real = ply_io._NATIVE
    ply_io._NATIVE = False          # the numpy path
    try:
        ply_io.save_ply(str(tmp_path / "numpy.ply"), **arrays)
    finally:
        ply_io._NATIVE = real
    jply.save_ply(str(tmp_path / "jax.ply"), **arrays)
    b = (tmp_path / "native.ply").read_bytes()
    assert b == (tmp_path / "numpy.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = ply_io.load_ply(str(tmp_path / "native.ply"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)


def test_native_codec_refused_when_it_cannot_run(tmp_path, monkeypatch):
    """A library that does not load leaves the numpy path."""
    monkeypatch.setattr(ply_io, "NATIVE_LIB", tmp_path / "missing.so")
    monkeypatch.setattr(ply_io, "_NATIVE", None)
    assert not ply_io.native_loaded()
    bad = tmp_path / "bad.so"
    bad.write_bytes(b"not a library")
    monkeypatch.setattr(ply_io, "NATIVE_LIB", bad)
    monkeypatch.setattr(ply_io, "_NATIVE", None)
    assert not ply_io.native_loaded()
    arrays = _f32(_map_arrays(10, np.random.default_rng(0)))
    ply_io.save_ply(str(tmp_path / "x.ply"), **arrays)
    np.testing.assert_array_equal(ply_io.load_ply(str(tmp_path / "x.ply"))["xyz"],
                                  arrays["xyz"])


# -------------------------------------------------------- capture / restore
def _jax_map(n, cap, rng):
    m = JG.empty_map(cap)
    a = _f32(_map_arrays(n, rng))
    idx = np.arange(n)
    m = m._replace(**{f: getattr(m, f).at[idx].set(a[f]) for f in JG._PARAM_FIELDS},
                   n_alive=jnp.asarray(n, jnp.int32))
    mu = m._replace(**{f: getattr(m, f) * 0.1 for f in JG._PARAM_FIELDS})
    nu = m._replace(**{f: getattr(m, f) ** 2 for f in JG._PARAM_FIELDS})
    return m, JG.AdamState(mu=mu, nu=nu, step=jnp.asarray(7, jnp.int32))


def test_capture_restore_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    jm, jadam = _jax_map(300, 512, rng)        # a capacity-padded JAX map
    JG.capture(jm, jadam, str(tmp_path / "jax.npz"))
    m, adam = TG.restore(tmp_path / "jax.npz")
    assert m.n == 300 and adam.step == 7
    for f in TG.PARAM_FIELDS:
        for ours, theirs in ((m, jm), (adam.mu, jadam.mu), (adam.nu, jadam.nu)):
            np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                          np.asarray(getattr(theirs, f))[:300])
    # and back: the port's capture restores in JAX, and round-trips itself
    TG.capture(m, adam, tmp_path / "port.npz")
    jm2, jadam2 = JG.restore(str(tmp_path / "port.npz"))
    m3, adam3 = TG.restore(tmp_path / "port.npz")
    assert int(jm2.n_alive) == 300 and int(jadam2.step) == 7 and adam3.step == 7
    with np.load(tmp_path / "port.npz") as z, np.load(tmp_path / "jax.npz") as zj:
        assert set(z.files) == set(zj.files)
    for f in TG.PARAM_FIELDS:
        for ours, theirs, again in ((m, jm2, m3), (adam.mu, jadam2.mu, adam3.mu),
                                    (adam.nu, jadam2.nu, adam3.nu)):
            np.testing.assert_array_equal(np.asarray(getattr(theirs, f)),
                                          getattr(ours, f).numpy())
            assert torch.equal(getattr(again, f), getattr(ours, f))


# ------------------------------------------------------------------ TinyDPT
def _dpt_data(n=2, h=32, w=40):
    rng = np.random.default_rng(5)
    imgs = rng.uniform(size=(n, 3, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    invs = np.stack([1.0 / (1.5 + 0.05 * (xx + k * yy)) for k in range(n)]).astype(np.float32)
    return imgs, invs


def test_tiny_dpt_init_and_first_gradient_match_jax():
    from mm3dgs_slam_tpu.eval.depth_est import TinyDPT as JDPT

    jp, tp = JDPT.init_params(np.random.default_rng(0)), TinyDPT.init_params(
        np.random.default_rng(0))
    assert list(jp) == list(tp)
    for k in jp:
        assert tp[k].dtype == np.float32 and np.array_equal(tp[k], jp[k]), k
    imgs, invs = _dpt_data()

    def jloss(p):
        x = JDPT.forward(p, imgs[0]).reshape(-1)
        y = jnp.asarray(invs[0]).reshape(-1)
        xs = (x - x.mean()) / jnp.sqrt(jnp.var(x) + 1e-6)
        ys = (y - y.mean()) / jnp.sqrt(jnp.var(y) + 1e-6)
        return jnp.mean((xs - ys) ** 2)

    jl, jg = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in jp.items()})
    params = {k: torch.tensor(v, requires_grad=True) for k, v in tp.items()}
    loss = TinyDPT.ssi_loss(TinyDPT.forward(params, torch.as_tensor(imgs[0])),
                            torch.as_tensor(invs[0]))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    # rtol 1e-4 with the JAX suite's gradient atol 5e-5 (tests/test_rasterizer.py):
    # a bias gradient sums every pixel's term, which the standardization
    # nearly cancels (head_b's is 0.5% of the largest gradient entry)
    for k in jp:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=5e-5, err_msg=k)


def _losses(text):
    return {int(m[0]): float(m[1]) for m in re.findall(r"step (\d+): ssi_loss=([0-9.]+)", text)}


def test_tiny_dpt_fit_matches_jax():
    """5 steps in the same image order: the step losses within 1e-3
    relative. Adam turns near-zero gradients into full steps of either
    sign, so the parameters are held only to the step bound (5 lr)."""
    from mm3dgs_slam_tpu.eval.depth_est import TinyDPT as JDPT

    imgs, invs = _dpt_data()
    out_j, out_t = io.StringIO(), io.StringIO()
    with redirect_stdout(out_j):
        jp = JDPT.fit(imgs, invs, steps=5, lr=3e-3, seed=0, verbose=True)
    with redirect_stdout(out_t):
        tp = TinyDPT.fit(imgs, invs, steps=5, lr=3e-3, seed=0, verbose=True)
    lj, lt = _losses(out_j.getvalue()), _losses(out_t.getvalue())
    assert set(lj) == set(lt) == {0, 4}
    for k in lj:
        assert lt[k] == pytest.approx(lj[k], rel=1e-3)
    assert lt[4] < lt[0]   # it learns
    init = TinyDPT.init_params(np.random.default_rng(0))
    for k in jp:
        assert np.abs(tp[k] - jp[k]).max() <= 2 * 5 * 3e-3, k
        assert not np.array_equal(tp[k], init[k]) or k.endswith("_b"), k


# ----------------------------------------------------------- fit_niqe_model
def test_fit_niqe_model_synthetic_matches_jax(tmp_path):
    jcode, _ = _run_jax_script("fit_niqe_model", ["--synthetic", 2, "--out", tmp_path / "j.npz"])
    tcode, _ = _port_main(fit_niqe_model.main, ["--synthetic", 2, "--out", tmp_path / "t.npz"])
    assert jcode == tcode == 0
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert set(j.files) == set(t.files) == {"mu", "cov", "patch_size"}
        assert int(t["patch_size"]) == int(j["patch_size"]) == 96
        np.testing.assert_allclose(t["mu"], j["mu"], rtol=1e-10)
        np.testing.assert_allclose(t["cov"], j["cov"], rtol=1e-10, atol=1e-14)


def test_fit_niqe_model_reads_images_as_jax_does(tmp_path):
    """A colour PNG read by cv2 (BGR) and by imageio (RGB) gives one luma."""
    import cv2
    import imageio.v2 as imageio

    img = (fit_niqe_model.synth_pristine(np.random.default_rng(3), 200, 240)[..., None]
           * np.array([1.0, 0.8, 0.6])).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img[..., ::-1])
    ref = np.asarray(imageio.imread(tmp_path / "a.png"), np.float64)
    ref = 0.299 * ref[..., 0] + 0.587 * ref[..., 1] + 0.114 * ref[..., 2]
    np.testing.assert_array_equal(fit_niqe_model.read_gray(str(tmp_path / "a.png")), ref)


# --------------------------------------------------------------- visualizer
def _jax_visualizer():
    spec = importlib.util.spec_from_file_location("jax_visualizer",
                                                  ROOT / "scripts" / "visualizer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_free_view_controller_matches_jax():
    jv = _jax_visualizer()
    pose = [0.98, 0.1, -0.12, 0.05, 0.3, -0.2, 1.1]
    a, b = jv.FreeViewController(pose, 0.07, 0.03), visualizer.FreeViewController(pose, 0.07, 0.03)
    keys = ["w", "left", "a", "up", ",", "d", "x", "down", "f", ".", "right", "s", "r",
            "home", "up", "w", "w"]
    for k in keys:
        assert a.handle_key(k) == b.handle_key(k)
        np.testing.assert_array_equal(a.pose, b.pose)


def test_visualizer_view_matches_jax_render(tmp_path):
    from mm3dgs_slam_tpu.ops.camera import Camera as JCamera
    from mm3dgs_slam_tpu.ops.render import RenderSettings as JRS
    from mm3dgs_slam_tpu.ops.render import render as jrender

    import cv2

    cfg = make_cfg(tmp_path)
    cfg.update(desired_height=48, desired_width=64)
    out = Path(cfg["outputdir"])
    rng = np.random.default_rng(1)
    n = 400
    z = rng.uniform(1.5, 4.0, n)
    a = _map_arrays(n, rng)
    a["xyz"] = np.stack([rng.uniform(-1, 1, n) * z * 0.5, rng.uniform(-1, 1, n) * z * 0.4, z], 1)
    a["scaling"] = np.log(np.full((n, 3), 0.05)) + rng.normal(0, 0.2, (n, 3))
    a = _f32(a)
    ply_io.save_ply(str(out / "point_cloud" / "iteration_2" / "point_cloud.ply"), **a)
    poses = np.array([[1, 0, 0, 0, 0, 0, 0], [0.999, 0.02, 0.01, 0, 0.05, 0, 0.02]], np.float32)
    np.savez(out / "results", pose_est=poses, pose_gt=poses)
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))

    m, pose_est = visualizer.load_map_and_poses(cfg, 2, "cpu")
    rgb, dep = visualizer.render_view(m.activated(), pose_est[1], visualizer.render_settings(cfg))
    c = cfg["cam"]
    jrs = JRS(cam=JCamera(height=48, width=64, fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"]),
              pair_cap=1 << 16, max_per_tile=512, chunk=16, max_tiles_per_gaussian=64)
    jm, _ = _jax_visualizer().load_map_and_poses(cfg, 2)
    jout = jrender(jm.activated(), jnp.asarray(pose_est[1]), jrs)
    assert not bool(jout["bins"].overflow)
    jrgb = np.clip(np.asarray(jout["render"]), 0, 1).transpose(1, 2, 0)
    assert jrgb.std() > 0.05   # the view shows the map
    np.testing.assert_allclose(rgb, jrgb, atol=2e-5, rtol=1e-4)

    # the offline CLI: --frames 3 views along the trajectory, then --online
    code, text = _port_main(visualizer.main, ["--config", tmp_path / "cfg.yml", "--iteration",
                                              2, "--frames", 3, "--device", "cpu"])
    assert code == 0 and "Wrote 3 views" in text
    views = sorted((out / "visualizer").glob("view_*.png"))
    assert len(views) == 3
    png = cv2.imread(str(views[2]))[:, :, ::-1]
    assert png.shape == (48, 128, 3)
    np.testing.assert_allclose(png[:, :64] / 255.0, rgb, atol=1 / 255 + 1e-6)
    code, text = _port_main(visualizer.main, ["--config", tmp_path / "cfg.yml", "--iteration",
                                              2, "--online", "--device", "cpu"])
    assert code == 0 and "Wrote 2 views" in text


# ----------------------------------------------------------- train_tiny_dpt
def test_train_tiny_dpt_script_writes_loadable_weights(tmp_path):
    from mm3dgs_slam_torch.scripts import train_tiny_dpt

    cfg = make_cfg(tmp_path)
    cfg["synthetic"]["n_frames"] = 2
    cfg.update(desired_height=30, desired_width=37)   # padded to 32x40
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    code, text = _port_main(train_tiny_dpt.main, ["--config", tmp_path / "cfg.yml", "--out",
                                                  tmp_path / "w.npz", "--steps", 3,
                                                  "--device", "cpu"])
    assert code == 0 and "2 frames at 32x40" in text and "step 2: ssi_loss=" in text
    with np.load(tmp_path / "w.npz") as z:
        assert set(z.files) == set(TinyDPT.init_params(np.random.default_rng(0)))
    est = TinyDPT(str(tmp_path / "w.npz")).estimate_depth(
        np.random.default_rng(0).uniform(size=(3, 30, 37)))
    assert est.shape == (30, 37) and torch.isfinite(est).all() and (est > 0).all()


# ----------------------------------------------------------- imu_preintegrate
def _imu_samples(tmp_path, fmt):
    """A written IMU file: 60 samples at ~100 Hz with jittered stamps (the
    fixed-dt quirk ignores them), all three accelerations nonzero (the
    x-only quirk drops y and z) and turning about every axis."""
    rng = np.random.default_rng(21)
    n = 60
    ts = 1.6e9 + np.cumsum(0.01 + rng.uniform(-2e-3, 2e-3, n))
    accel = rng.normal(0.0, 0.8, (n, 3)) + [0.4, 9.81, -0.3]
    gyro = rng.normal(0.0, 0.3, (n, 3))
    if fmt == "utmm":
        rows = rng.normal(size=(n, 36))
        rows[:, 0], rows[:, 4:7], rows[:, 7:10] = ts, gyro, accel
        path = tmp_path / "imu.txt"
        np.savetxt(path, rows)
    else:
        path = tmp_path / "imu.csv"
        np.savetxt(path, np.column_stack([ts, accel, gyro]), delimiter=",")
    return path


@pytest.mark.parametrize("fmt", ["utmm", "plain"])
def test_imu_preintegrate_writes_the_jax_scripts_rows(tmp_path, fmt):
    from mm3dgs_slam_torch.scripts import imu_preintegrate

    imu = _imu_samples(tmp_path, fmt)
    csvs = {}
    for who in ("jax", "port"):
        argv = ["--imu", imu, "--out", tmp_path / f"{who}_rel.csv",
                "--world-out", tmp_path / f"{who}_world.csv", "--dt", 0.01]
        if who == "jax":
            code, out = _run_jax_script("imu_preintegrate", argv)
        else:
            code, out = _port_main(imu_preintegrate.main, argv)
        assert code == 0 and "60 relative transforms" in out
        csvs[who] = [(tmp_path / f"{who}_{k}.csv").read_text().splitlines()
                     for k in ("rel", "world")]
    for jlines, tlines in zip(csvs["jax"], csvs["port"]):
        assert tlines[0] == jlines[0] == ",".join(imu_preintegrate.HEADER)
        assert [r.split(",")[0] for r in tlines] == [r.split(",")[0] for r in jlines]
        j = np.array([[float(v) for v in r.split(",")[1:]] for r in jlines[1:]])
        t = np.array([[float(v) for v in r.split(",")[1:]] for r in tlines[1:]])
        np.testing.assert_allclose(t, j, atol=1e-12, rtol=0)
    # the same trajectory from the functions: right-composed, x-only, fixed dt
    spec = importlib.util.spec_from_file_location("jax_imu_preintegrate",
                                                  ROOT / "scripts" / "imu_preintegrate.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    ts, accel, gyro = imu_preintegrate.load_samples(str(imu), "auto")
    jts, jaccel, jgyro = jmod.load_samples(str(imu), "auto")
    np.testing.assert_array_equal(accel, jaccel)
    np.testing.assert_array_equal(gyro, jgyro)
    rel, world = imu_preintegrate.preintegrate(ts, accel, gyro, 0.01)
    jrel, jworld = jmod.preintegrate(jts, jaccel, jgyro, 0.01)
    np.testing.assert_allclose(world, jworld, atol=1e-12, rtol=0)
    np.testing.assert_allclose(rel, jrel, atol=1e-12, rtol=0)
    flat, _ = imu_preintegrate.preintegrate(ts, accel * [1, 0, 0], gyro, 0.01)
    np.testing.assert_array_equal(flat, rel)   # y and z acceleration ignored
