"""Procedural synthetic RGB-D dataset rendered from a random Gaussian scene
(JAX counterpart: data/synthetic.py).

Frames are rendered by the port's exact oracle (ops/oracle.py) from a known
camera trajectory, so SLAM on it should recover a near-zero ATE. The JAX
package draws its scene from `jax.random`, which torch cannot reproduce;
this generator draws the same distributions from
`numpy.random.default_rng(seed)`, so its scenes (and golden numbers) differ
from the JAX package's for the same seed. A caller can inject a scene
instead (`scene=` numpy arrays), which is how the tests feed both packages
the same one. The JAX package's own scenes of configs/synthetic_tum.yml and
configs/synthetic_hard.yml ship as `assets/jax_scene_<config>.npz`
(`load_scene`, `jax_scene_path`): injected, the port renders the frames of
the JAX package's golden runs.

Config block (all optional):
  synthetic: {n_gaussians: 400, n_frames: 12, seed: 0, orbit_radius: 0.15,
              textured: false, occluders: 0, noise_std: 0.0}
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.camera import Camera
from ..ops.oracle import composite_oracle
from ..ops.pose import w2c_to_pose
from ..ops.render import ActivatedGaussians, RenderSettings, project_for_pose
from ..ops.sh import rgb_to_sh

SCENE_FIELDS = ("xyz", "scales", "rotations", "opacity", "rgb")
ASSETS = Path(__file__).resolve().parent.parent / "assets"


def _texture_rgb(xyz):
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r = 0.5 + 0.25 * np.sin(21.0 * x + 13.0 * y) + 0.25 * np.sin(7.0 * z)
    g = 0.5 + 0.25 * np.sin(17.0 * y + 5.0 * z) + 0.25 * np.sin(29.0 * x)
    b = 0.5 + 0.25 * np.sin(11.0 * x * y) + 0.25 * np.sin(19.0 * z + 3.0 * y)
    return np.clip(np.stack([r, g, b], axis=-1), 0.02, 0.98)


def make_scene(seed: int, n: int, cam: Camera, textured: bool = False,
               occluders: int = 0) -> dict:
    """The JAX `_make_scene` distributions (data/synthetic.py:52-98) drawn
    from a numpy stream: dict of float32 arrays xyz, scales, rotations,
    opacity, rgb."""
    rng = np.random.default_rng(seed)
    n_fg = min(n // 5, occluders * max(n // 20, 1)) if occluders else 0
    n_bg = n - n_fg
    z = rng.uniform(1.5, 5.0, n)
    px = rng.uniform(-10.0, cam.width + 10.0, n)
    py = rng.uniform(-10.0, cam.height + 10.0, n)
    if n_fg:
        stripe = rng.integers(0, occluders, n_fg)
        centers = np.linspace(0.2, 0.8, occluders)[stripe] * cam.width
        px[n_bg:] = centers + rng.normal(size=n_fg) * 0.02 * cam.width
        py[n_bg:] = rng.uniform(-5.0, cam.height + 5.0, n_fg)
        z[n_bg:] = 1.0 + 0.1 * rng.normal(size=n_fg)
    xyz = np.stack([(px - cam.cx) / cam.fx * z, (py - cam.cy) / cam.fy * z, z], axis=-1)
    scales = np.exp(rng.uniform(-3.2, -1.8, (n, 3)))
    if n_fg:
        scales[n_bg:] *= 0.6
    q = rng.normal(size=(n, 4))
    rot = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opacity = np.clip(1.0 / (1.0 + np.exp(-rng.normal(size=n))) + 0.7, 0.7, 0.98)
    if n_fg:
        opacity[n_bg:] = 0.97
    rgb = _texture_rgb(xyz) if textured else rng.uniform(0.0, 1.0, (n, 3))
    out = dict(xyz=xyz, scales=scales, rotations=rot, opacity=opacity, rgb=rgb)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def trajectory_w2c(s: float, orbit: float, dtype=np.float32) -> np.ndarray:
    """The smooth camera path at s in [0, 1] (smooth beyond, too): a gentle
    arc with a yaw sweep and a forward drift; w2c."""
    ang = 0.5 * np.pi * s
    yaw = 0.05 * np.sin(ang)
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=dtype)
    w2c[:3, :3] = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    w2c[:3, 3] = [orbit * np.sin(ang), 0.5 * orbit * (1 - np.cos(ang)), 0.1 * s]
    return w2c


def render_frame(scene: ActivatedGaussians, w2c: np.ndarray, rs: RenderSettings):
    """The oracle's render of `scene` from w2c: (rgb [3, H, W] in [0, 1],
    depth [H, W] in scene units, 0 where the silhouette is below 0.5)."""
    dev = scene.xyz.device
    pose7 = w2c_to_pose(torch.as_tensor(w2c, device=dev))
    img6 = composite_oracle(project_for_pose(scene, pose7, rs), rs.cam, torch.zeros(6, device=dev))
    rgb = torch.clamp(img6[:3], 0, 1).cpu().numpy()
    sil = img6[4].cpu().numpy()
    depth = img6[3].cpu().numpy()
    return rgb, np.where(sil > 0.5, depth / np.maximum(sil, 1e-6), 0.0).astype(np.float32)


def scene_gaussians(scene: dict, device=None) -> ActivatedGaussians:
    """Scene arrays -> ActivatedGaussians on `device`: xyz, scales,
    rotations, opacity and either shs [N, 1, 3] (taken as they are) or rgb
    (make_scene's dict; converted with rgb_to_sh)."""
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         for k, v in scene.items() if k in SCENE_FIELDS + ("shs",)}
    shs = t["shs"] if "shs" in t else rgb_to_sh(t["rgb"])[:, None, :]
    return ActivatedGaussians(
        xyz=t["xyz"], scales=t["scales"], rotations=t["rotations"],
        opacity=t["opacity"], shs=shs,
        alive=torch.ones(t["xyz"].shape[0], dtype=torch.bool, device=device))


def jax_scene_path(config_name: str) -> Path:
    """The shipped JAX-package scene of configs/<config_name>.yml."""
    return ASSETS / f"jax_scene_{config_name}.npz"


def load_scene(path) -> dict:
    """A scene .npz (xyz, scales, rotations, opacity, shs or rgb) as a dict
    of float32 arrays, for `SyntheticDataset(scene=...)` / `SLAM(scene=...)`."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


class SyntheticDataset:
    has_imu = False

    def __init__(self, config_dict, basedir=None, sequence=None, stride=1,
                 start=0, end=-1, desired_height=64, desired_width=80,
                 relative_pose=True, device=None, scene: dict | None = None, **kwargs):
        syn = config_dict.get("synthetic", {}) or {}
        n_gauss = int(syn.get("n_gaussians", 400))
        n_frames = int(syn.get("n_frames", 12))
        seed = int(syn.get("seed", 0))
        orbit = float(syn.get("orbit_radius", 0.15))
        noise_std = float(syn.get("noise_std", 0.0))

        cam_cfg = config_dict["cam"]
        h, w = desired_height, desired_width
        ratio_h, ratio_w = h / cam_cfg["image_height"], w / cam_cfg["image_width"]
        cam = Camera(height=h, width=w,
                     fx=cam_cfg["fx"] * ratio_w, fy=cam_cfg["fy"] * ratio_h,
                     cx=cam_cfg["cx"] * ratio_w, cy=cam_cfg["cy"] * ratio_h)
        self.cam = cam
        if scene is None:
            scene = make_scene(seed, n_gauss, cam, textured=bool(syn.get("textured", False)),
                               occluders=int(syn.get("occluders", 0)))
        self.scene = scene_gaussians(scene, device)
        rs = RenderSettings(cam=cam)
        self.frames, self.poses = [], []
        noise_rng = np.random.default_rng(seed + 1)
        for i in range(n_frames):
            w2c = trajectory_w2c(i / max(n_frames - 1, 1), orbit)
            rgb, d = render_frame(self.scene, w2c, rs)
            if noise_std > 0.0:
                rgb = np.clip(rgb + noise_rng.normal(0.0, noise_std, rgb.shape).astype(np.float32),
                              0.0, 1.0)
            self.frames.append((rgb, d))
            self.poses.append(np.linalg.inv(w2c))  # c2w

        sl = slice(start, None if end == -1 else end, stride or 1)
        self.frames, self.poses = self.frames[sl], self.poses[sl]
        if relative_pose:
            first = self.poses[0]
            self.poses = [np.linalg.inv(first) @ p for p in self.poses]
        self.num_imgs = len(self.frames)

    def __len__(self):
        return self.num_imgs

    def __getitem__(self, index):
        rgb, depth = self.frames[index]
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1] = self.cam.fx, self.cam.fy
        K[0, 2], K[1, 2] = self.cam.cx, self.cam.cy
        return ((rgb.transpose(1, 2, 0) * 255.0).astype(np.float32),
                depth[..., None].astype(np.float32), K,
                self.poses[index].astype(np.float32), None)
