"""Profile one frame of the port's main path on the card.

    python -m mm3dgs_slam_torch.profile_frame --config configs/synthetic_tum.yml [--frames 3]

Runs the first `frames - 1` frames of the config's synthetic sequence as the
SLAM loop does, then the last frame's tracking and its mapping each under
`torch.profiler` (CPU and CUDA activity), with the same inputs `SLAM._step`
gives them; the tracking is first timed twice without the profiler (a
first and a warm call). Prints, per phase: wall ms, ms per iteration,
device-busy ms and share (summed time of the device activities: kernels and
copies, over wall), device activities per iteration, and the device
activities and host operators that take the most time. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import load_config
from .slam.slam import SLAM
from .slam.tracker import track_frame


def _report(name: str, prof, wall_s: float, iters: int, top: int) -> None:
    events = prof.key_averages()
    # device activity (kernels, copies) only: an operator's row repeats the
    # device time of the kernels it launched
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in on_dev)
    launches = sum(e.count for e in on_dev)
    print(f"[{name}] wall {wall_s * 1e3:.1f} ms, {wall_s * 1e3 / iters:.3f} ms/iteration, "
          f"device busy {device_us / 1e3:.1f} ms ({100 * device_us / 1e6 / wall_s:.1f}% of wall), "
          f"{launches / iters:.0f} device activities/iteration")
    by_dev = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    for e in by_dev:
        print(f"[{name}]   device {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d}x  {e.key[:90]}")
    by_cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    for e in by_cpu:
        print(f"[{name}]   host   {e.self_cpu_time_total / 1e3:9.2f} ms  {e.count:7d}x  {e.key[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--frames", type=int, default=3, help="profile the last of this many frames")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    if args.frames < 2:
        p.error("--frames must be at least 2 (frame 0 is not tracked)")
    cfg = load_config(args.config)
    cfg["synthetic"]["n_frames"] = args.frames
    with tempfile.TemporaryDirectory() as out:
        cfg["outputdir"] = out
        slam = SLAM(cfg, device="cuda")
        for idx in range(args.frames - 1):
            slam._step(idx)
        idx = args.frames - 1
        color, depth, _, c2w, imu = slam.dataset[idx]
        color_np = np.transpose(color, (2, 0, 1)) / 255.0
        depth_np = depth[..., 0]
        gt_color, gt_depth = slam._dev(color_np), slam._dev(depth_np)
        seed = slam._dev(slam._seed_pose(idx, imu))
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

        args_t = (slam.gaussians.activated(), seed, gt_color, gt_depth,
                  torch.zeros_like(gt_depth), slam.track_settings)
        for call in ("first", "warm"):  # the first call pays one-time set-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            track_frame(*args_t)
            torch.cuda.synchronize()
            print(f"[track] {call} call without the profiler: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pose, _ = track_frame(*args_t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report("track", prof, wall, slam.track_settings.iters, args.top)

        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            slam.mapper.run_frame(idx, slam.gaussians, slam.adam, pose.cpu().numpy(), gt_color,
                                  gt_depth, None, color_np, depth_np, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report("map", prof, wall, slam.mapper.num_iter, args.top)
        print(f"[profile] {slam.gaussians.n} gaussians at {cfg['desired_width']}x"
              f"{cfg['desired_height']}, frame {idx}; {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
