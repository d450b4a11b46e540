"""Trajectory evaluation CLI: align and score a saved results.npz (JAX
counterpart: scripts/eval_traj.py; the reference's scripts/eval_traj.py).

    python -m mm3dgs_slam_torch.scripts.eval_traj --config <yml> [--results <npz>] [--animate]

Prints the Umeyama-aligned ATE RMSE of the w2c pose vectors (the
`ate_rmse` that results.npz holds) and of the camera centres, then writes
``trajectory_plot.png`` (and with --animate ``trajectory_animation.mp4``)
to the config's output directory; the plot needs matplotlib, the ATEs do
not.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import load_config
from ..eval.ate import camera_centers, evaluate_ate_rmse


def trajectory_ates(pose_est: np.ndarray, pose_gt: np.ndarray) -> dict:
    """The two Umeyama ATEs of a run's w2c 7-vector lists: `ate_w2c` (of the
    pose vectors' translations) and `ate_c2w` (of the camera centres), with
    the aligned centres and the centres of both lists for the plot."""
    est_centers, gt_centers = camera_centers(pose_est), camera_centers(pose_gt)
    aligned_c2w, ate_c2w = evaluate_ate_rmse(est_centers, gt_centers, "umeyama")
    _, ate_w2c = evaluate_ate_rmse(pose_est, pose_gt, "umeyama")
    return dict(ate_w2c=ate_w2c, ate_c2w=ate_c2w, aligned_c2w=aligned_c2w,
                est_centers=est_centers, gt_centers=gt_centers)


def plot(t: dict, outdir: str, animate: bool = False):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt, al = t["gt_centers"], t["aligned_c2w"]
    fig = plt.figure(figsize=(12, 5))
    ax = fig.add_subplot(121)
    ax.plot(gt[:, 4], gt[:, 6], "k-", label="ground truth")
    ax.plot(al[:, 4], al[:, 6], "b-", label="estimated (aligned)")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend()
    ax.set_title(f"trajectory (ATE RMSE {t['ate_c2w']:.4f} m)")
    ax3 = fig.add_subplot(122, projection="3d")
    ax3.plot(gt[:, 4], gt[:, 5], gt[:, 6], "k-")
    ax3.plot(al[:, 4], al[:, 5], al[:, 6], "b-")
    ax3.set_title("3D")
    out_png = os.path.join(outdir, "trajectory_plot.png")
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("Plot saved to", out_png)

    if animate:
        from matplotlib import animation

        fig2, ax2 = plt.subplots()
        ax2.plot(gt[:, 4], gt[:, 6], "k-")
        (line,) = ax2.plot([], [], "b-")

        def update(i):
            line.set_data(al[: i + 1, 4], al[: i + 1, 6])
            return (line,)

        anim = animation.FuncAnimation(fig2, update, frames=len(al), interval=33, blit=True)
        out_mp4 = os.path.join(outdir, "trajectory_animation.mp4")
        anim.save(out_mp4, fps=30)
        plt.close(fig2)
        print("Animation saved to", out_mp4)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="ATE of a saved results.npz, and its plot")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--results", type=str, default=None,
                        help="path to results.npz (default: the config's output directory's)")
    parser.add_argument("--animate", action="store_true", help="write trajectory_animation.mp4")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    r = np.load(args.results or os.path.join(cfg["outputdir"], "results.npz"), allow_pickle=True)
    t = trajectory_ates(r["pose_est"], r["pose_gt"])
    print(f"ATE RMSE (w2c pose vectors): {t['ate_w2c']} m")
    print(f"ATE RMSE (camera centers):   {t['ate_c2w']} m")
    plot(t, cfg["outputdir"], args.animate)
    return t


if __name__ == "__main__":
    main()
