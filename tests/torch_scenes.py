"""Scenes of PyTorch tensors that card tests and CPU tests share, in a
module free of JAX (the card's machine has none; tests/utils.py imports it)."""
import numpy as np
import torch

from mm3dgs_slam_torch.ops.camera import Camera
from mm3dgs_slam_torch.ops.render import ActivatedGaussians
from mm3dgs_slam_torch.ops.sh import rgb_to_sh


def pose_edge_scene(dev, n=3000, h=120, w=160, f=140.0, seed=5):
    """Gaussians drawn as test_torch_gpu.py's `_scene` draws them (unbinned)
    with edge rows for kernel 4: an eighth each behind z = 0.2, past the 1.3
    tanfov clamp in x and in y (both signs), a fifth of all rows dead;
    scales up to e^-1.5. Returns (g, cam)."""
    cam = Camera(h, w, f, f, w / 2 - 0.5, h / 2 - 0.5)
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 6.0, n)
    px, py = rng.uniform(-8, w + 8, n), rng.uniform(-8, h + 8, n)
    xyz = np.stack([(px - cam.cx) / f * z, (py - cam.cy) / f * z, z], -1)
    k = n // 8
    xyz[:k, 2] = rng.uniform(-1.0, 0.2, k)
    for col, lim, rows in ((0, cam.tanfovx, slice(k, 2 * k)), (1, cam.tanfovy, slice(2 * k, 3 * k))):
        xyz[rows, col] = (xyz[rows, 2] * 1.3 * lim * rng.choice([-1.0, 1.0], k)
                          * rng.uniform(1.01, 3.0, k))
    q = rng.normal(size=(n, 4))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    g = ActivatedGaussians(
        xyz=t(xyz), scales=t(np.exp(rng.uniform(-4.5, -1.5, (n, 3)))),
        rotations=t(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        opacity=t(1 / (1 + np.exp(-2 * rng.normal(size=n)))),
        shs=torch.cat([rgb_to_sh(t(rng.uniform(-0.3, 1.2, (n, 1, 3)))), t(np.zeros((n, 1, 3)))],
                      1),
        alive=torch.as_tensor(rng.uniform(size=n) > 0.2, device=dev))
    return g, cam
