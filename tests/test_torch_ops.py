"""mm3dgs_slam_torch math leaves, losses, map state and I/O held against the
JAX package on the CPU (same numpy inputs through both), plus the port's
structural rules: no JAX import, CUDA by default, no CPU fallback."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.models import gaussians as JG
from mm3dgs_slam_tpu.ops import depth as jdepth
from mm3dgs_slam_tpu.ops import losses as jlosses
from mm3dgs_slam_tpu.ops import pose as jpose
from mm3dgs_slam_tpu.ops import sh as jsh
from mm3dgs_slam_tpu.ops.camera import Camera as JCamera
from mm3dgs_slam_tpu.ops.camera import projection_matrix as jprojection_matrix

from mm3dgs_slam_torch.models import gaussians as TG
from mm3dgs_slam_torch.ops import depth as tdepth
from mm3dgs_slam_torch.ops import losses as tlosses
from mm3dgs_slam_torch.ops import pose as tpose
from mm3dgs_slam_torch.ops import sh as tsh
from mm3dgs_slam_torch.ops.camera import Camera as TCamera
from mm3dgs_slam_torch.ops.camera import projection_matrix as tprojection_matrix

torch.set_num_threads(1)
RNG = np.random.default_rng(0)
PKG = Path(__file__).resolve().parents[1] / "mm3dgs_slam_torch"


def close(a, b, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_port_imports_no_jax():
    """Every module of the port is free of jax and mm3dgs_slam_tpu imports."""
    bad = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "mm3dgs_slam_tpu"):
                    bad.append(f"{path.relative_to(PKG)}: {name}")
    assert not bad, bad


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    from mm3dgs_slam_torch.config import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_camera_and_projection_matrix():
    args = (48, 64, 61.0, 59.0, 31.2, 23.7)
    jc, tc = JCamera(*args), TCamera(*args)
    assert (jc.tiles_x, jc.tiles_y, jc.n_tiles) == (tc.tiles_x, tc.tiles_y, tc.n_tiles)
    close(tprojection_matrix(tc), jprojection_matrix(jc))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    k = (deg + 1) ** 2
    sh = RNG.normal(size=(50, 3, k)).astype(np.float32)
    d = RNG.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(tsh.eval_sh(deg, t(sh), t(d)), jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))


def test_quaternion_and_pose_ops():
    q1 = RNG.normal(size=(20, 4)).astype(np.float32)
    q2 = RNG.normal(size=(20, 4)).astype(np.float32)
    close(tpose.quat_multiply(t(q1), t(q2)), jpose.quat_multiply(q1, q2))
    R = np.asarray(jpose.quat_to_rotmat(jnp.asarray(q1)))
    close(tpose.quat_to_rotmat(t(q1)), R)
    close(tpose.rotmat_to_quat(t(R)), jpose.rotmat_to_quat(jnp.asarray(R)), atol=1e-5)
    for _ in range(5):
        p = np.concatenate([RNG.normal(size=4), RNG.normal(size=3)]).astype(np.float32)
        p2 = (p + 0.05 * RNG.normal(size=7)).astype(np.float32)
        w2c = np.asarray(jpose.pose_to_w2c(jnp.asarray(p)))
        close(tpose.pose_to_w2c(t(p)), w2c)
        close(tpose.w2c_to_pose(t(w2c)), jpose.w2c_to_pose(jnp.asarray(w2c)), atol=1e-5)
        close(tpose.propagate_const_vel(t(p), t(p2)),
              jpose.propagate_const_vel(jnp.asarray(p), jnp.asarray(p2)), atol=2e-5)


def test_losses_match():
    a = RNG.uniform(size=(3, 40, 52)).astype(np.float32)
    b = RNG.uniform(size=(3, 40, 52)).astype(np.float32)
    m = RNG.uniform(size=(40, 52)) > 0.3
    d = RNG.uniform(1, 4, size=(40, 52)).astype(np.float32)
    e = RNG.uniform(0.2, 1, size=(40, 52)).astype(np.float32)
    ja, jb, jd, je = map(jnp.asarray, (a, b, d, e))
    close(tlosses.l1_loss(t(a), t(b)), jlosses.l1_loss(ja, jb))
    close(tlosses.l1_loss(t(a), t(b), torch.as_tensor(m)), jlosses.l1_loss(ja, jb, jnp.asarray(m)))
    close(tlosses.masked_sum(t(a), torch.as_tensor(m)), jlosses.masked_sum(ja, jnp.asarray(m)), rtol=1e-5)
    close(tlosses.ssim(t(a), t(b)), jlosses.ssim(ja, jb), atol=1e-6)
    close(tlosses.psnr(t(a), t(b)), jlosses.psnr(ja, jb), atol=1e-5)
    for inv in (True, False):
        close(tlosses.pearson_loss(t(d), t(e), torch.as_tensor(m), inv),
              jlosses.pearson_loss(jd, je, jnp.asarray(m), inv), atol=1e-6)


def test_depth_helpers_match():
    x = RNG.uniform(size=(31, 17)).astype(np.float32)
    assert float(tdepth.torch_style_median(t(x))) == float(jdepth.torch_style_median(jnp.asarray(x)))
    depth = RNG.uniform(0.5, 3.0, size=(24, 32)).astype(np.float32)
    p = np.array([0.99, 0.05, -0.02, 0.01, 0.1, -0.05, 0.2], np.float32)
    w2c = np.asarray(jpose.pose_to_w2c(jnp.asarray(p)))
    jp = jdepth.backproject_all_pixels(jnp.asarray(depth), jnp.asarray(w2c), 30.0, 31.0, 15.5, 11.5)
    tp = tdepth.backproject_all_pixels(t(depth), t(w2c), 30.0, 31.0, 15.5, 11.5)
    close(tp, jp, atol=2e-5)
    valid = RNG.uniform(size=(24 * 32,)) > 0.2
    w2c2 = np.asarray(jpose.pose_to_w2c(jnp.asarray(p * np.float32(0.9))))
    close(tdepth.project_points_fraction_inside(tp, torch.as_tensor(valid), t(w2c2), 30.0, 31.0,
                                                15.5, 11.5, 24, 32, 2),
          jdepth.project_points_fraction_inside(jp, jnp.asarray(valid), jnp.asarray(w2c2), 30.0,
                                                31.0, 15.5, 11.5, 24, 32, 2))


def test_expon_lr_matches():
    from mm3dgs_slam_tpu.models.schedules import expon_lr as jexp
    from mm3dgs_slam_torch.models.schedules import expon_lr as texp

    for step in (0, 5, 120, 30000):
        close(texp(step, 1e-4, 1.6e-6, 100, 0.01, 30000),
              jexp(step, 1e-4, 1.6e-6, 100, 0.01, 30000), rtol=1e-5)


def _random_jax_map(n, cap):
    m = JG.empty_map(cap)
    f = lambda *s: jnp.asarray(RNG.normal(size=s).astype(np.float32))  # noqa: E731
    idx = np.arange(n)
    return m._replace(
        xyz=m.xyz.at[idx].set(f(n, 3)), features_dc=m.features_dc.at[idx].set(f(n, 1, 3)),
        features_rest=m.features_rest.at[idx].set(f(n, 1, 3)),
        scaling=m.scaling.at[idx].set(f(n, 3) - 3.0), rotation=m.rotation.at[idx].set(f(n, 4)),
        opacity=m.opacity.at[idx].set(f(n, 1)), rgb=m.rgb.at[idx].set(f(n, 3)),
        n_alive=jnp.asarray(n, jnp.int32))


def _np_leaves(m):
    return {f: np.asarray(getattr(m, f)) for f in JG._PARAM_FIELDS} | {"n_alive": np.asarray(m.n_alive)}


def _assert_maps_equal(jm, tm, atol=1e-6):
    n = int(jm.n_alive)
    assert tm.n == n
    for f in JG._PARAM_FIELDS:
        close(getattr(tm, f), np.asarray(getattr(jm, f))[:n], atol=atol, rtol=1e-5)


def test_adam_append_prune_sequence_matches():
    """update, update, append (zeroed moments, persistent step), update,
    prune (moments follow their rows), update, reset_opacity."""
    cap = 64
    jm = _random_jax_map(40, cap)
    tm = TG.from_numpy_params(_np_leaves(jm))
    hyper = JG.MapOptHyper(1e-3, 2e-3, 1e-4, 5e-3, 1e-3, 5e-2, 2e-3)
    thyper = TG.MapOptHyper(*hyper)
    jst, tst = JG.init_adam(jm), TG.init_adam(tm)

    def grads(n):
        g = {f: RNG.normal(size=np.asarray(getattr(jm, f)).shape).astype(np.float32)
             for f in JG._PARAM_FIELDS}
        for v in g.values():
            v[n:] = 0.0
        jg = jm._replace(**{f: jnp.asarray(v) for f, v in g.items()})
        tg = TG.GaussianMap(*(t(g[f][:n]) for f in TG.PARAM_FIELDS))
        return jg, tg

    for _ in range(2):
        jg, tg = grads(int(jm.n_alive))
        jm, jst = JG.adam_update(jm, jg, jst, hyper)
        tm, tst = TG.adam_update(tm, tg, tst, thyper)
    _assert_maps_equal(jm, tm)

    k = 12
    mask = RNG.uniform(size=k) > 0.4
    new = {f: RNG.normal(size=(k,) + np.asarray(getattr(jm, f)).shape[1:]).astype(np.float32)
           for f in JG._PARAM_FIELDS}
    jm, jst, _ = JG.append_gaussians(jm, jst, JG.NewGaussians(
        **{f: jnp.asarray(v) for f, v in new.items()}, mask=jnp.asarray(mask)))
    tm, tst, n_added = TG.append_gaussians(tm, tst, TG.NewGaussians(
        *(t(new[f]) for f in TG.PARAM_FIELDS), mask=torch.as_tensor(mask)))
    assert n_added == int(mask.sum()) and tst.step == int(jst.step)
    _assert_maps_equal(jm, tm)

    jg, tg = grads(int(jm.n_alive))
    jm, jst = JG.adam_update(jm, jg, jst, hyper)
    tm, tst = TG.adam_update(tm, tg, tst, thyper)
    keep = RNG.uniform(size=cap) > 0.3
    jm, jst, _ = JG.prune_compact(jm, jst, jnp.asarray(keep))
    tm, tst, _ = TG.prune_compact(tm, tst, torch.as_tensor(keep[:tm.n]))
    _assert_maps_equal(jm, tm)
    for a, b in ((jst.mu, tst.mu), (jst.nu, tst.nu)):
        _assert_maps_equal(a._replace(n_alive=jm.n_alive), b)

    jg, tg = grads(int(jm.n_alive))
    jm, jst = JG.adam_update(jm, jg, jst, hyper)
    tm, tst = TG.adam_update(tm, tg, tst, thyper)
    jm, jst = JG.reset_opacity(jm, jst)
    tm, tst = TG.reset_opacity(tm, tst)
    _assert_maps_equal(jm, tm, atol=2e-6)
    ext = 0.4
    close(TG.prune_mask_reference(tm, ext, 0.3),
          np.asarray(JG.prune_mask_reference(jm, ext, 0.3))[:tm.n], atol=0)


def test_ply_roundtrip_and_schema(tmp_path):
    from mm3dgs_slam_tpu.models.ply_io import load_ply as jload
    from mm3dgs_slam_torch.models.ply_io import load_ply, save_ply

    n = 9
    d = dict(xyz=RNG.normal(size=(n, 3)), features_dc=RNG.normal(size=(n, 1, 3)),
             features_rest=RNG.normal(size=(n, 3, 3)), opacity=RNG.normal(size=(n, 1)),
             scaling=RNG.normal(size=(n, 3)), rotation=RNG.normal(size=(n, 4)),
             rgb=RNG.uniform(size=(n, 3)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    path = str(tmp_path / "p.ply")
    save_ply(path, **d)
    for loaded in (load_ply(path), jload(path)):
        for k, v in d.items():
            np.testing.assert_array_equal(loaded[k], v)


def test_rgbd_loader_base_matches(tmp_path):
    """The copied loader base reads, resizes and strides a sequence as the
    JAX package's does."""
    import cv2

    from mm3dgs_slam_tpu.data import base as jbase
    from mm3dgs_slam_torch.data import base as tbase

    for i in range(5):
        cv2.imwrite(str(tmp_path / f"color{i}.png"),
                    RNG.integers(0, 256, (24, 32, 3), dtype=np.uint8))
        cv2.imwrite(str(tmp_path / f"depth{i}.png"),
                    RNG.integers(0, 5000, (24, 32), dtype=np.uint16))
    names = [f"color{i}.png" for i in (10, 2, 1)]
    assert tbase.natsorted(names) == jbase.natsorted(names) == ["color1.png", "color2.png",
                                                               "color10.png"]
    pvec = np.array([0.1, -0.2, 0.3, 0.1, 0.2, -0.1, 0.97])
    close(tbase.pose_matrix_from_tum_quaternion(pvec),
          jbase.pose_matrix_from_tum_quaternion(pvec), atol=0)
    cfg = {"dataset": "seq", "cam": {"png_depth_scale": 1000.0, "image_height": 24,
                                     "image_width": 32, "fx": 30.0, "fy": 31.0, "cx": 15.5,
                                     "cy": 11.5}}
    poses = [np.eye(4) + np.pad(0.01 * k * RNG.normal(size=(3, 1)), ((0, 1), (3, 0)))
             for k in range(5)]
    loaded = []
    for base in (tbase, jbase):
        class Seq(base.RGBDDataset):
            def get_filepaths(self):
                return ([str(tmp_path / f"color{i}.png") for i in range(5)],
                        [str(tmp_path / f"depth{i}.png") for i in range(5)])

            def load_poses(self):
                return poses

        loaded.append(Seq(cfg, str(tmp_path), "", stride=2, start=1,
                          desired_height=12, desired_width=16))
    ds_t, ds_j = loaded
    assert len(ds_t) == len(ds_j) == 2
    for i in range(2):
        for a, b in zip(ds_t[i][:4], ds_j[i][:4]):
            np.testing.assert_array_equal(a, b)


def test_ate_matches():
    from mm3dgs_slam_tpu.eval.ate import camera_centers as jcc, evaluate_ate_rmse as jate
    from mm3dgs_slam_torch.eval.ate import camera_centers, evaluate_ate_rmse

    gt = np.concatenate([np.tile([1.0, 0, 0, 0], (8, 1)), RNG.normal(size=(8, 3))], 1)
    est = gt + 0.01 * RNG.normal(size=gt.shape)
    est, gt = est.astype(np.float32), gt.astype(np.float32)
    a_t, e_t = evaluate_ate_rmse(est, gt)
    a_j, e_j = jate(est, gt)
    assert abs(e_t - e_j) < 1e-7
    close(a_t, a_j, atol=1e-5)
    close(camera_centers(est), jcc(est), atol=1e-5)


def test_niqe_matches():
    from mm3dgs_slam_tpu.eval.quality import FrameQuality as JFQ
    from mm3dgs_slam_torch.eval.quality import FrameQuality

    img = RNG.uniform(size=(3, 96, 128))
    assert FrameQuality()._model is not None
    assert FrameQuality()(img) == JFQ()(img)


def test_config_schema_and_ignored_keys():
    from mm3dgs_slam_tpu.config import load_config as jload
    from mm3dgs_slam_torch.config import load_config

    root = Path(__file__).resolve().parents[1] / "configs"
    cfg = load_config(str(root / "synthetic_tum.yml"))
    jcfg = jload(str(root / "synthetic_tum.yml"))
    for k in ("tracking", "mapping", "cam", "synthetic", "pipeline"):
        assert cfg[k] == jcfg[k]
    for k in ("rebin_every", "map_rebin_every", "group_mapping_schedule", "max_new_per_frame"):
        assert cfg["tpu"][k] == jcfg["tpu"][k]
    assert cfg["device"] == "tpu"  # read, and ignored by the port
