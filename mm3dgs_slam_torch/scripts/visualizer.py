"""Map visualizer: a saved map and its trajectory, offline or interactive
(JAX counterpart: scripts/visualizer.py; the reference's Open3D viewer).

    python -m mm3dgs_slam_torch.scripts.visualizer --config <yml> --iteration N
        [--online] [--interactive] [--frames 24] [--device cuda|cpu]

Loads ``point_cloud/iteration_N`` and results.npz's estimated poses from the
config's output directory and renders the map with the port's `render` on
--device (the card unless told otherwise, so kernel 1 draws every view).
Offline (the default) it writes ``<outputdir>/visualizer/view_NNNN.png``,
each the render beside its depth in viridis, with cv2: a fly-around of
--frames poses spaced along the estimated trajectory, or with --online the
trajectory itself, frame by frame. --interactive opens a free-view window
(matplotlib, imported only then; WASD/RF move, arrows and ,/. turn, home
resets, q quits) and falls back to the offline views where no GUI backend
or display is available.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import load_config


def load_map_and_poses(cfg: dict, iteration: int, device="cpu"):
    """(GaussianMap of the saved PLY on `device`, pose_est [N, 7])."""
    from ..models import gaussians as G
    from ..models.ply_io import load_ply

    data = load_ply(os.path.join(cfg["outputdir"], "point_cloud", f"iteration_{iteration}",
                                 "point_cloud.ply"))
    n = data["xyz"].shape[0]
    rest = max((cfg["mapping"]["sh_degree"] + 1) ** 2 - 1, 1)
    fr = data["features_rest"]
    if fr.shape[1] < rest:
        fr = np.concatenate([fr, np.zeros((n, rest - fr.shape[1], 3), np.float32)], axis=1)
    m = G.from_numpy_params(dict(data, features_rest=fr, n_alive=n), device)
    results = np.load(os.path.join(cfg["outputdir"], "results.npz"), allow_pickle=True)
    return m, results["pose_est"]


class FreeViewController:
    """Keyboard free-view camera over a w2c 7-vector pose, a pure state
    machine fed key names (the reference's Open3D view-control loop).

    Keys (camera-local): w/s dolly, a/d truck, r/f pedestal; arrow keys
    yaw/pitch; ,/. roll; home resets. Steps are `move_step` and
    `turn_step` (radians)."""

    MOVES = {"w": (2, +1), "s": (2, -1), "a": (0, -1), "d": (0, +1),
             "f": (1, +1), "r": (1, -1)}
    TURNS = {"left": (1, +1), "right": (1, -1), "up": (0, +1),
             "down": (0, -1), ",": (2, +1), ".": (2, -1)}

    def __init__(self, pose7, move_step=0.1, turn_step=0.05):
        self.home = np.asarray(pose7, np.float64).copy()
        self.pose = self.home.copy()
        self.move_step = float(move_step)
        self.turn_step = float(turn_step)

    def _w2c(self):
        q, t = self.pose[:4], self.pose[4:]
        w, x, y, z = q / np.linalg.norm(q)
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        return R, t

    def handle_key(self, key: str) -> bool:
        """Apply one key; returns True if the pose changed."""
        if key == "home":
            self.pose = self.home.copy()
            return True
        if key in self.MOVES:
            axis, sign = self.MOVES[key]
            # moving the camera by +d along its local axis: t' = t - d e_axis
            self.pose[4 + axis] -= sign * self.move_step
            return True
        if key in self.TURNS:
            axis, sign = self.TURNS[key]
            half = sign * self.turn_step / 2.0
            dq = np.zeros(4)
            dq[0] = np.cos(half)
            dq[1 + axis] = np.sin(half)
            # camera-local rotation: w2c' = dR^T w2c, so q' = conj(dq) q
            dq[1:] = -dq[1:]
            w1, x1, y1, z1 = dq
            w2, x2, y2, z2 = self.pose[:4]
            q = np.array([
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ])
            # turn about the camera centre c = -R^T t, which stays put
            R, t = self._w2c()
            c = -R.T @ t
            self.pose[:4] = q / np.linalg.norm(q)
            Rn, _ = self._w2c()
            self.pose[4:] = -Rn @ c
            return True
        return False


def render_settings(cfg: dict):
    """The config's camera (its cam block at the desired size, unscaled) and
    render switches."""
    from ..ops.camera import Camera
    from ..ops.render import RenderSettings

    cam = Camera(height=cfg["desired_height"], width=cfg["desired_width"],
                 fx=cfg["cam"]["fx"], fy=cfg["cam"]["fy"], cx=cfg["cam"]["cx"],
                 cy=cfg["cam"]["cy"])
    return RenderSettings(cam=cam, sh_degree=cfg["mapping"]["sh_degree"],
                          force_isotropic=cfg["pipeline"]["force_isotropic"],
                          white_background=cfg["white_background"])


def render_view(g, pose, rs):
    """One view: (rgb [H, W, 3] in [0, 1], depth in viridis [H, W, 3])."""
    import torch

    from ..ops.depth import depth_to_rgb_np
    from ..ops.render import render

    with torch.no_grad():
        out = render(g, torch.as_tensor(np.asarray(pose, np.float32), device=g.xyz.device), rs)
    rgb = np.clip(out["render"].cpu().numpy(), 0, 1).transpose(1, 2, 0)
    sil = out["depth"][1].cpu().numpy()
    depth = out["depth"][0].cpu().numpy() / np.maximum(sil, 1e-6)
    return rgb, depth_to_rgb_np(depth).transpose(1, 2, 0)


def write_view(path: str, rgb, depth_rgb) -> None:
    """The render beside its depth as one 8-bit PNG."""
    import cv2

    panel = (np.clip(np.concatenate([rgb, depth_rgb], axis=1), 0, 1) * 255).astype(np.uint8)
    cv2.imwrite(path, cv2.cvtColor(panel, cv2.COLOR_RGB2BGR))


def run_interactive(view, ctrl: FreeViewController):
    """Matplotlib free-view loop (needs a GUI backend); `view` maps a pose to
    (rgb, depth_rgb)."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    rgb, dep = view(ctrl.pose)
    im0, im1 = axes[0].imshow(rgb), axes[1].imshow(dep)
    axes[0].set_title("render — w/a/s/d/r/f move, arrows turn, home resets")
    axes[1].set_title("depth")
    for ax in axes:
        ax.axis("off")

    def on_key(event):
        if event.key == "q":
            plt.close(fig)
            return
        if ctrl.handle_key(event.key):
            rgb, dep = view(ctrl.pose)
            im0.set_data(rgb)
            im1.set_data(dep)
            fig.canvas.draw_idle()

    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show()


def _interactive_backend() -> bool:
    try:
        import matplotlib
    except ImportError:
        return False
    for backend in ("TkAgg", "QtAgg", "GTK4Agg"):
        try:
            matplotlib.use(backend)
            return True
        except Exception:  # noqa: BLE001 — any backend failure means try the next
            continue
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="render a saved map and its trajectory")
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--iteration", type=int, required=True)
    ap.add_argument("--online", action="store_true", help="replay the estimated trajectory")
    ap.add_argument("--interactive", action="store_true",
                    help="free-view window (matplotlib GUI backend; offline views "
                         "where there is none)")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import resolve_device

    cfg = load_config(args.config)
    m, pose_est = load_map_and_poses(cfg, args.iteration, resolve_device(args.device))
    g, rs = m.activated(), render_settings(cfg)
    view = lambda pose: render_view(g, pose, rs)  # noqa: E731

    if args.interactive:
        if _interactive_backend():
            try:
                run_interactive(view, FreeViewController(pose_est[0]))
                return 0
            except Exception as e:  # noqa: BLE001 — e.g. no display: go offline
                print(f"interactive window failed ({e!r}); falling back to offline rendering")
        else:
            print("no interactive matplotlib backend; falling back to offline rendering")

    out_dir = os.path.join(cfg["outputdir"], "visualizer")
    os.makedirs(out_dir, exist_ok=True)
    if args.online:
        poses = pose_est
    else:   # fly-around through the estimated trajectory
        poses = pose_est[np.linspace(0, len(pose_est) - 1, args.frames).astype(int)]
    for i, pose in enumerate(poses):
        write_view(os.path.join(out_dir, f"view_{i:04d}.png"), *view(pose))
    print(f"Wrote {len(poses)} views to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
