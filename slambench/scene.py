"""The cells' inputs, made from the seed: the scene, the camera path, the
frames, and for UT-MM the written sequence.

Frozen copies, as of commit e88f4e05ce172d38c9780fabda9487fc7eec7bc7, of
mm3dgs_slam_torch/data/synthetic.py (make_scene, _texture_rgb,
trajectory_w2c, SyntheticDataset's noise and frame layout) and
mm3dgs_slam_torch/data/synthetic_utmm.py (write_synthetic_utmm). The frames
are rendered by the reference's vectorised composite (reference.py) in
float32 on the card, where the port's loader renders them with its oracle,
one Gaussian at a time; the benchmark hands its frames to the port's
synthetic loader in place of that render.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import reference as ref

UTMM_T0 = 1000.0     # timestamp of frame 0, seconds
IMU_COLUMNS = 36
GRAVITY = np.array([0.0, -9.80665, 0.0])
# robot body frame -> camera optical frame (data/utmm.py _C2R)
C2R = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def _texture_rgb(xyz):
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r = 0.5 + 0.25 * np.sin(21.0 * x + 13.0 * y) + 0.25 * np.sin(7.0 * z)
    g = 0.5 + 0.25 * np.sin(17.0 * y + 5.0 * z) + 0.25 * np.sin(29.0 * x)
    b = 0.5 + 0.25 * np.sin(11.0 * x * y) + 0.25 * np.sin(19.0 * z + 3.0 * y)
    return np.clip(np.stack([r, g, b], axis=-1), 0.02, 0.98)


def make_scene(seed: int, n: int, cam: ref.Cam, textured: bool = False,
               occluders: int = 0) -> dict:
    """n Gaussians in front of the first camera: float32 arrays xyz, scales,
    rotations, opacity, rgb."""
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
    """The camera path at s in [0, 1]: an arc with a yaw sweep and a forward
    drift; w2c."""
    ang = 0.5 * np.pi * s
    yaw = 0.05 * np.sin(ang)
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=dtype)
    w2c[:3, :3] = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    w2c[:3, 3] = [orbit * np.sin(ang), 0.5 * orbit * (1 - np.cos(ang)), 0.1 * s]
    return w2c


def scene_gaussians(scene: dict, device, dtype=torch.float32) -> ref.Gaussians:
    t = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in scene.items()}
    # the loader's rgb -> SH -> rgb round trip, in float32 as there
    sh = (torch.as_tensor(scene["rgb"], device=device) - 0.5) / ref.SH_C0
    rgb = torch.clamp(ref.SH_C0 * sh + 0.5, min=0.0).to(dtype)
    return ref.Gaussians(t["xyz"], t["scales"], t["rotations"], t["opacity"], rgb)


@torch.no_grad()
def render_frame(g: ref.Gaussians, w2c: np.ndarray, cam: ref.Cam):
    """(rgb [3, H, W] in [0, 1], depth [H, W], 0 where the silhouette is at
    most 0.5), float32 numpy: the loader's frame layout."""
    pose = ref.w2c_to_pose(torch.as_tensor(np.asarray(w2c, np.float64), device=g.xyz.device))
    img = ref.render_image(g, pose.to(g.xyz.dtype), cam, g.xyz.dtype)
    rgb = torch.clamp(img[:3], 0, 1).float().cpu().numpy()
    sil, depth = img[4].cpu().numpy(), img[3].cpu().numpy()
    depth = np.where(sil > 0.5, depth / np.maximum(sil, 1e-6), 0.0).astype(np.float32)
    return rgb, depth


class SyntheticSequence:
    """The frames of a synthetic cell: the scene from `seed`, n_frames views
    along the path (frame i at s = i / (n_frames - 1)), the photometric
    noise drawn as the port's loader draws it (a stream seeded seed + 1)."""

    def __init__(self, traffic: dict, cam: ref.Cam, seed: int, device):
        self.cam = cam
        self.scene = make_scene(seed, int(traffic["n_gaussians"]), cam,
                                textured=bool(traffic.get("textured", False)),
                                occluders=int(traffic.get("occluders", 0)))
        g = scene_gaussians(self.scene, device)
        n, orbit = int(traffic["n_frames"]), float(traffic["orbit_radius"])
        self.w2c = [trajectory_w2c(i / max(n - 1, 1), orbit) for i in range(n)]
        self.clean = [render_frame(g, w, cam) for w in self.w2c]
        noise_std = float(traffic.get("noise_std", 0.0))
        rng = np.random.default_rng(seed + 1)
        self.frames = []
        for rgb, d in self.clean:
            if noise_std > 0.0:
                rgb = np.clip(rgb + rng.normal(0.0, noise_std, rgb.shape).astype(np.float32),
                              0.0, 1.0)
            self.frames.append((rgb, d))

    def renderer(self):
        """A stand-in for the loader's per-frame render: the i-th call
        returns the i-th clean frame, after checking that the loader asks
        for the same camera pose."""
        calls = iter(range(len(self.clean)))

        def render(scene, w2c, rs):
            i = next(calls)
            if not np.allclose(np.asarray(w2c, np.float64), self.w2c[i], atol=1e-6):
                raise ValueError(f"the loader asked for frame {i} at another pose")
            if (rs.cam.height, rs.cam.width) != (self.cam.height, self.cam.width):
                raise ValueError("the loader renders at another size")
            return self.clean[i]

        return render

    def gt_color_depth(self, i: int):
        """Frame i as the SLAM loop hands it to tracking and mapping: colour
        [3, H, W] and depth [H, W], float32."""
        rgb, d = self.frames[i]
        color = (rgb.transpose(1, 2, 0) * 255.0).astype(np.float32)
        return (np.transpose(color, (2, 0, 1)) / 255.0).astype(np.float32), d


def _tum_line(t: float, m: np.ndarray) -> str:
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(m[:3, :3]).as_quat()   # x y z w
    return f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*m[:3, 3], *q))


def _i2c() -> np.ndarray:
    from scipy.spatial.transform import Rotation

    m = np.eye(4)
    m[:3, :3] = Rotation.from_euler("xyz", [0.02, -0.03, 0.05]).as_matrix()
    m[:3, 3] = [0.05, -0.02, 0.01]
    return m


def write_utmm(root: str, traffic: dict, cfg: dict, seed: int, device) -> None:
    """A UT-MM sequence at the config's native camera: rgb/ and depth/ PNGs,
    rgb.txt, depth.txt, groundtruth.txt (robot frame), tf.txt (i2c) and a
    `imu_hz` imu.txt whose angular velocity is the sxyz Euler step of the
    IMU's rotation over a sample period and whose accelerometer is
    R^T (a + g), a by central differences."""
    import cv2
    from scipy.spatial.transform import Rotation

    c = cfg["cam"]
    cam = ref.Cam(int(c["image_height"]), int(c["image_width"]), c["fx"], c["fy"], c["cx"],
                  c["cy"])
    n_frames, fps = int(traffic["frames_written"]), float(traffic["fps"])
    imu_hz, orbit = float(traffic["imu_hz"]), float(traffic["orbit_radius"])
    g = scene_gaussians(make_scene(seed, int(traffic["n_gaussians"]), cam), device)
    duration = (n_frames - 1) / fps

    def c2w_at(t: float) -> np.ndarray:
        return np.linalg.inv(trajectory_w2c(t / duration, orbit, np.float64))

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_l, dep_l, gt_l = [], [], ["# timestamp tx ty tz qx qy qz qw"]
    r2c = np.eye(4)
    r2c[:3, :3] = C2R[:3, :3].T
    for i in range(n_frames):
        t = i / fps
        c2w = c2w_at(t)
        rgb, depth = render_frame(g, np.linalg.inv(c2w).astype(np.float32), cam)
        name = f"{UTMM_T0 + t:.6f}.png"
        cv2.imwrite(os.path.join(root, "rgb", name),
                    np.round(rgb[::-1].transpose(1, 2, 0) * 255.0).astype(np.uint8))
        cv2.imwrite(os.path.join(root, "depth", name),
                    np.round(depth * c["png_depth_scale"]).astype(np.uint16))
        rgb_l.append(f"{UTMM_T0 + t:.6f} rgb/{name}")
        dep_l.append(f"{UTMM_T0 + t + 0.003:.6f} depth/{name}")
        gt_l.append(_tum_line(UTMM_T0 + t + 0.001, c2w @ r2c))

    i2c = _i2c()
    dt = 1.0 / imu_hz
    imu_l = []
    for k in range(int(round(duration * imu_hz)) + 2):
        t = k * dt
        pose = [c2w_at(t + o * dt) @ i2c for o in (-1, 0, 1)]
        rot, pos = pose[1][:3, :3], [p[:3, 3] for p in pose]
        accel = (pos[2] - 2.0 * pos[1] + pos[0]) / (dt * dt)
        step = Rotation.from_matrix(pose[0][:3, :3].T @ rot).as_euler("xyz")
        vals = np.zeros(IMU_COLUMNS)
        vals[13:16] = step / dt
        vals[25:28] = rot.T @ (accel + GRAVITY)
        imu_l.append(f"{UTMM_T0 + t:.6f} " + " ".join(f"{v:.9f}" for v in vals))

    for name, lines in (("rgb.txt", rgb_l), ("depth.txt", dep_l),
                        ("groundtruth.txt", gt_l), ("imu.txt", imu_l)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "tf.txt"), "w") as f:
        f.write(_tum_line(0.0, i2c).split(" ", 1)[1] + "\n")


def read_utmm_frame(root: str, index: int, cfg: dict):
    """Frame `index` of a written sequence as the SLAM loop receives it
    (stride and resize applied the way the loader applies them): colour
    [3, H, W] in [0, 1] and depth [H, W], float32. Relies on the writer's
    one-to-one association of rgb, depth, pose and IMU rows."""
    import cv2

    i = int(cfg["start_idx"]) + index * int(cfg["stride"] or 1)
    names = [ln.split()[1] for ln in open(os.path.join(root, "rgb.txt")) if ln.strip()]
    dnames = [ln.split()[1] for ln in open(os.path.join(root, "depth.txt")) if ln.strip()]
    img = cv2.imread(os.path.join(root, names[i]), cv2.IMREAD_UNCHANGED)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float64)
    size = (int(cfg["desired_width"]), int(cfg["desired_height"]))
    color = cv2.resize(img.astype(np.float32), size, interpolation=cv2.INTER_LINEAR)
    dep = cv2.imread(os.path.join(root, dnames[i]), cv2.IMREAD_UNCHANGED).astype(np.int64)
    dep = cv2.resize(dep.astype(np.float64), size, interpolation=cv2.INTER_NEAREST)
    depth = (dep / cfg["cam"]["png_depth_scale"]).astype(np.float32)
    color = (np.transpose(color.astype(np.float32), (2, 0, 1)) / 255.0).astype(np.float32)
    return color, depth
