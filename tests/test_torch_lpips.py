"""The port's LPIPS (a VGG16 torch module) held against the JAX package's on
the CPU: the pretrained-weights metric through a weights .npz written here,
NaN without one, and the always-finite random-weights proxy."""
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.eval import lpips as jlpips

from mm3dgs_slam_torch.eval import lpips as tlpips

torch.set_num_threads(1)
RTOL = 1e-4


def _images(h, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    return a, b


def _weights(path):
    """VGG16-shaped random weights and positive heads, as an .npz."""
    rng = np.random.default_rng(1)
    w = tlpips.proxy_weights()
    for k in w:
        w[k] = (w[k] * rng.uniform(0.5, 1.5, w[k].shape)).astype(np.float32)
        if k.endswith("_b"):
            w[k] = rng.normal(0.0, 0.01, w[k].shape).astype(np.float32)
    np.savez(path, **w)


@pytest.mark.parametrize("hw", [(48, 64), (45, 61)])
def test_lpips_proxy_matches_jax(hw):
    a, b = _images(*hw)
    want = jlpips.lpips_proxy(a, b)
    got = tlpips.lpips_proxy(torch.as_tensor(a), torch.as_tensor(b))
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert tlpips.lpips_proxy(a, a) == 0.0


def test_lpips_matches_jax_with_weights_and_is_nan_without(tmp_path, monkeypatch):
    a, b = _images(40, 56, seed=3)
    monkeypatch.delenv("MM3DGS_LPIPS_WEIGHTS", raising=False)
    jlpips._load_weights.cache_clear()
    assert np.isnan(tlpips.lpips(a, b)) and np.isnan(jlpips.lpips(a, b))
    path = tmp_path / "lpips_vgg.npz"
    _weights(path)
    monkeypatch.setenv("MM3DGS_LPIPS_WEIGHTS", str(path))
    jlpips._load_weights.cache_clear()
    try:
        want = jlpips.lpips(a, b)
    finally:
        jlpips._load_weights.cache_clear()
    got = tlpips.lpips(a, b)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert abs(got - tlpips.lpips_proxy(a, b)) > 1e-3 * got   # not the proxy's weights
