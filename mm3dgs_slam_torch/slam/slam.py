"""SLAM orchestrator: the per-frame track -> map loop and the artifact
writers (JAX counterpart: slam/slam.py; reference slam/SLAM.py:38-502).

Construct from a config dict and call `.run()`. Artifacts:
``point_cloud/iteration_N/point_cloud.ply`` and ``results.npz`` with the JAX
package's keys (pose_est, pose_gt, keyframes, ate_rmse, psnr_list,
ssim_list, lpips_list, lpips_proxy_list, avg_*_time,
binning_overflow_frames), and with `debug.create_video` the 2x3-panel
``debug_video.mp4``. lpips_list is NaN unless `MM3DGS_LPIPS_WEIGHTS` names
the pretrained weights; lpips_proxy_list is always finite
(eval/lpips.py). Binning is sized exactly, so binning_overflow_frames is
always empty.

Ported paths: the const-velocity and IMU motion models (the IMU seed is
computed on the host, reproducing the JAX package: frame 1 seeds a zero
velocity, dt_imu is 1/100, at most `tpu.imu_pad` samples are integrated),
the IMU pose prior, GT depth or a monocular estimate (`use_gt_depth: false`:
the estimator runs on the SLAM's device and is rescaled per frame by the LS
scale/shift fit), the vigs/mm3dgs and splatam methods, bundle adjustment
(`mapping.do_BA`: the window's optimized poses replace the keyframes' and
the current frame's estimate), and checkpoint resume (`iteration`: the map
from ``point_cloud/iteration_N``, the poses and keyframes from
``results.npz`` in the output directory, as either package writes them;
the run then starts again from frame 0 on that map). The frame loop reads
its frames through a one-frame-ahead prefetch thread (`tpu.prefetch`, on by
default, data/prefetch.py); everything else reads the dataset directly.

Two debug switches measure a run (the JAX package's keys):
`debug.frame_decomp` books each frame's wall time to the phases data,
depth_est, track, depth_fit, overflow_check (binning is sized exactly, so
it checks nothing; kept so the table's rows are the JAX package's) and
logging, and the mapper's map.* phases; each phase ends at
`torch.cuda.synchronize` (only while the switch is on), the table of
per-frame medians is printed and results.npz gains frame_decomp,
frame_decomp_phases and frame_decomp_rows. `debug.jax_profiler_dir` traces
the whole run with torch.profiler (CPU and, on the card, CUDA activities)
and writes a Chrome trace ``trace.json`` into that directory.

`tpu.mesh_devices: W > 1` runs the sharded map (parallel/, JAX slam.py:160-187)
in W processes started by ``torchrun --standalone --nproc_per_node W``: each
rank runs this whole frame loop on the same frames and holds its own rows of
the map; the tracking and mapping renders split the tile grid among the
ranks. A world size other than W raises ValueError. The poses, keyframes and
NIQE decisions are the same on every rank; rank 0 alone writes results.npz,
the PLY (every rank's rows gathered) and the video, and prints the metrics.
A rank that fails ends the run without saving (the save needs every rank);
torchrun then stops the others.
"""
from __future__ import annotations

import os
import sys
import time
import traceback
from collections import defaultdict

import numpy as np
import torch

from ..config import normalize_config, resolve_device
from ..data import get_dataset_type
from ..data.prefetch import Prefetcher
from ..eval.ate import evaluate_ate_rmse
from ..eval.depth_est import get_dpt
from ..eval.lpips import lpips as lpips_fn, lpips_proxy
from ..models import gaussians as G
from ..models.ply_io import load_ply, save_ply
from ..ops.camera import Camera
from ..ops.depth import depth_to_rgb_np, get_scale_shift_ls
from ..ops.losses import psnr as psnr_fn, ssim as ssim_fn
from ..ops.pose import propagate_const_vel, propagate_imu, w2c_to_pose
from ..ops.render import RenderSettings
from ..parallel.mesh import make_mesh
from ..parallel.sharded import gather_rows, shard_map_state
from ..parallel.tile_sharded import render_sharded
from .mapper import KeyFrame, Mapper
from .tracker import TrackSettings, track_frame


def _pose7(w2c: np.ndarray) -> np.ndarray:
    return w2c_to_pose(torch.as_tensor(w2c, dtype=torch.float32)).numpy()


class SLAM:
    def __init__(self, cfg: dict, device=None, scene: dict | None = None):
        """`device`: "cuda" (default) or "cpu"; `scene`: optional synthetic
        scene arrays (data/synthetic.py) in place of the generated one."""
        cfg = normalize_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.failed: BaseException | None = None
        # tpu.mesh_devices > 1: this process is one rank of the sharded map
        self.mesh = make_mesh(int(cfg["tpu"].get("mesh_devices", 1)), self.device)
        self.device = self.mesh.device
        self.is_writer = self.mesh.rank == 0

        extra = {"device": self.device, "scene": scene} if cfg["dataset"].lower() == "synthetic" else {}
        self.dataset = get_dataset_type(cfg["dataset"])(
            config_dict=cfg, basedir=cfg["inputdir"], sequence=cfg["scene"],
            start=cfg["start_idx"], end=cfg.get("early_stop_idx", -1),
            stride=cfg["stride"], desired_height=cfg["desired_height"],
            desired_width=cfg["desired_width"], relative_pose=True, **extra)
        self.n_img = len(self.dataset)
        self._frames = Prefetcher(self.dataset, enabled=bool(cfg["tpu"].get("prefetch", True)))
        _, _, intrinsics, _, _ = self.dataset[0]
        cam_cfg = cfg["cam"]
        cam_cfg["cx"], cam_cfg["cy"] = float(intrinsics[0, 2]), float(intrinsics[1, 2])
        cam_cfg["fx"], cam_cfg["fy"] = float(intrinsics[0, 0]), float(intrinsics[1, 1])

        self.dyn_model = (cfg["tracking"]["dynamics_model"] or "").lower() or None
        if self.dyn_model == "imu":
            self.tstamps = self.dataset.tstamps
            self.c2i = torch.as_tensor(self.dataset.get_c2i_tf(), dtype=torch.float32)
            self.imu_pad = int(cfg["tpu"]["imu_pad"])

        self.output = cfg["outputdir"]
        os.makedirs(self.output, exist_ok=True)
        cam = Camera(height=cfg["desired_height"], width=cfg["desired_width"],
                     fx=cam_cfg["fx"], fy=cam_cfg["fy"], cx=cam_cfg["cx"], cy=cam_cfg["cy"])
        self.rs = RenderSettings(
            cam=cam,
            sh_degree=cfg["mapping"]["sh_degree"],
            transform_means_python=cfg["pipeline"]["transform_means_python"],
            force_isotropic=cfg["pipeline"]["force_isotropic"],
            compute_cov3d_python=cfg["pipeline"]["compute_cov3D_python"],
            white_background=cfg["white_background"],
        )
        self.gaussians = G.empty_map(cfg["mapping"]["sh_degree"], self.device)
        self.estimate_pose_list = np.zeros((self.n_img, 7), np.float32)
        self.gt_pose_list = np.zeros((self.n_img, 7), np.float32)
        # checkpoint resume (SLAM.py:90-106, mapper.py:65-71)
        self._resume = "iteration" in cfg
        if self._resume:
            self.load_checkpoint(cfg["iteration"])
        self.adam = G.init_adam(self.gaussians)
        self.gaussians, self.adam = shard_map_state(self.gaussians, self.adam, self.mesh)
        # the motion model's seed of each tracked frame (NaN where untracked)
        self.seed_pose_list = np.full((self.n_img, 7), np.nan, np.float32)

        tr = cfg["tracking"]
        self.track_settings = TrackSettings(
            rs=self.rs, iters=int(tr["iters"]), method=cfg["method"].lower(),
            use_gt_depth=cfg["use_gt_depth"],
            use_depth_estimate_loss=bool(tr["use_depth_estimate_loss"]),
            pearson_weight=float(tr["pearson_weight"]),
            use_imu_loss=bool(tr["use_imu_loss"]),
            imu_T_weight=float(tr.get("imu_T_weight", 0.0)),
            imu_q_weight=float(tr.get("imu_q_weight", 0.0)),
            position_lr=float(tr["position_lr"]), rotation_lr=float(tr["rotation_lr"]),
            rebin_every=int(cfg["tpu"].get("rebin_every", 1)), mesh=self.mesh)
        self.mapper = Mapper(cfg, self.rs, self.device, self.mesh)
        if self._resume:
            self._restore_keyframes()
        self.dpt = None
        if not cfg["use_gt_depth"]:
            self.dpt = get_dpt(cfg["dpt_model"], self.device, weights=cfg["dpt_weights"])
        self.video_writer = None
        if cfg["debug"]["create_video"] and self.is_writer:
            import cv2

            self.video_writer = cv2.VideoWriter(
                os.path.join(self.output, "debug_video.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                cfg["cam"]["fps"], (cfg["desired_width"] * 3, cfg["desired_height"] * 2))
        self.tracking_time_sum = 0.0
        self.tracking_iter_count = 0
        self.rendering_time_sum = 0.0
        self.rendering_iter_count = 0
        self.frame_seconds: list[float] = []  # wall time of each completed frame
        # debug.frame_decomp: phase -> seconds over the run, shared with the
        # mapper, and each frame's deltas (the medians are the steady state)
        self.frame_decomp = defaultdict(float)
        self.frame_decomp_rows: list[dict] = []
        self._decomp_on = bool(cfg["debug"].get("frame_decomp"))
        self.mapper.decomp_on = self._decomp_on
        self.mapper.decomp = self.frame_decomp

    def load_checkpoint(self, iteration: int):
        """The map of ``point_cloud/iteration_N`` and the poses of
        ``results.npz`` in the output directory (JAX slam.py:259-286)."""
        data = load_ply(os.path.join(self.output, "point_cloud", f"iteration_{iteration}",
                                     "point_cloud.ply"))
        n = data["xyz"].shape[0]
        rest = self.gaussians.features_rest.shape[1]
        fr = data["features_rest"]
        if fr.shape[1] < rest:
            fr = np.concatenate([fr, np.zeros((n, rest - fr.shape[1], 3), np.float32)], axis=1)
        self.gaussians = G.from_numpy_params(dict(data, features_rest=fr, n_alive=n),
                                             self.device)
        results = np.load(os.path.join(self.output, "results.npz"), allow_pickle=True)
        pose_est = results["pose_est"]
        self.estimate_pose_list[:len(pose_est)] = pose_est

    def _restore_keyframes(self):
        """The keyframes of ``results.npz`` and their covisibility graph
        (JAX slam.py:288-302; each keyframe is linked against all but the
        last, itself included, as there)."""
        results = np.load(os.path.join(self.output, "results.npz"), allow_pickle=True)
        as_np = lambda x: None if x is None else np.asarray(x)  # noqa: E731
        for d in results["keyframes"]:
            self.mapper.append_keyframe(KeyFrame(
                idx=int(d["idx"]), gt_color=np.asarray(d["gt_color"]),
                pose=np.asarray(d["est_pose"]), gt_depth=as_np(d["gt_depth"]),
                est_depth=as_np(d["est_depth"])))
        g_act = self.gaussians.activated()
        for k in range(len(self.mapper.keyframes)):
            self.mapper.update_covisibility_graph(k, g_act)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dev(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def get_scene_radius(self, depth) -> float:
        return float(torch.max(depth)) / self.cfg["scene_radius_depth_ratio"]

    def _seed_pose(self, idx: int, imu_meas) -> np.ndarray:
        """Motion-model pose seed (tracker.py:196-230), on the host."""
        prev = torch.as_tensor(self.estimate_pose_list[idx - 1])
        if self.dyn_model == "const_velocity" and idx - 2 >= 0:
            return propagate_const_vel(prev, torch.as_tensor(self.estimate_pose_list[idx - 2])).numpy()
        if self.dyn_model == "imu":
            if imu_meas is None:
                raise ValueError("dynamics_model: imu needs a dataset with IMU rows")
            rows = torch.as_tensor(imu_meas[:self.imu_pad], dtype=torch.float32)
            if idx - 2 >= 0:
                prev2 = torch.as_tensor(self.estimate_pose_list[idx - 2])
                dt_cam = self.tstamps[idx - 1] - self.tstamps[idx - 2]
            else:   # frame 1: no earlier pose, so a zero velocity
                prev2, dt_cam = prev, 1.0
            return propagate_imu(prev, prev2, rows[:, 13:16], rows[:, 25:28], self.c2i,
                                 float(dt_cam), 1.0 / 100.0).numpy()
        return prev.numpy()

    def _fit_est_depth(self, idx: int, est_depth, gt_depth):
        """Scale the inverse-depth estimate to metric (SLAM.py:411-448):
        frame 0 by `depth_fit` ("ls": LS fit against GT depth; "tum_heuristic":
        png_depth_scale / 10 / (est + 0.001)), later frames by an LS fit
        against the map's render at the tracked pose over the pixels with
        silhouette > 0.99 (frame 0 too when resuming)."""
        if idx == 0 and not self._resume:
            mode = self.cfg.get("depth_fit")
            if mode is None:
                ds = self.cfg["dataset"].lower()
                mode = {"utmm": "ls", "synthetic": "ls", "tum": "tum_heuristic"}.get(ds)
                if mode is None:
                    raise ValueError(
                        f"dataset {ds!r} runs monocular (use_gt_depth: false) but has no "
                        "default depth-scale anchoring; set depth_fit: ls (LS fit of "
                        "frame 0 against GT depth) or depth_fit: tum_heuristic "
                        "(png_depth_scale/10 MiDaS magnitude heuristic) in the config")
            if mode == "ls":
                s, b = get_scale_shift_ls(est_depth, gt_depth, gt_depth > 0)
                return 1.0 / (s * est_depth + b)
            if mode != "tum_heuristic":
                raise ValueError(f"unknown depth_fit: {mode!r}")
            return 1.0 / (est_depth + 0.001) * self.cfg["cam"]["png_depth_scale"] / 10.0
        with torch.no_grad():
            out = render_sharded(self.gaussians.activated(),
                                 self._dev(self.estimate_pose_list[idx]), self.rs, self.mesh)
        render_depth, sil = out["depth"][0], out["depth"][1]
        s, b = get_scale_shift_ls(est_depth, render_depth, (sil > 0.99) & (est_depth > 1e-6))
        return 1.0 / (s * est_depth + b)

    def run(self):
        """Run every frame, then save the map and results even when a frame
        fails (SLAM.py:494-502). A failure is printed and kept in
        `self.failed`."""
        print("Method: " + self.cfg["method"])
        last_idx = 0
        prof = self._start_profiler()
        try:
            for idx in range(self.n_img):
                t_frame = time.perf_counter()
                before = dict(self.frame_decomp)
                self._step(idx)
                self._sync()
                self.frame_seconds.append(time.perf_counter() - t_frame)
                if self._decomp_on:
                    self.frame_decomp_rows.append({
                        k: v - before.get(k, 0.0) for k, v in self.frame_decomp.items()
                        if v - before.get(k, 0.0) > 0.0})
                if self.cfg["debug"].get("get_runtime_stats"):
                    n = self.n_gaussians()
                    if self.is_writer:
                        print(f"frame {idx + 1}/{self.n_img}: "
                              f"{self.frame_seconds[-1]:.2f}s, {n} gaussians", flush=True)
                last_idx += 1
                if idx in (self.cfg.get("save_iterations") or []):
                    self.save_map(idx)
        except Exception as e:  # noqa: BLE001 — save-on-failure boundary
            traceback.print_exc()
            self.failed = e
            if self.mesh.size > 1:
                raise   # the save needs every rank: end this rank's run
            print("\nSLAM failed. Saving map and results.\n")
        finally:
            if prof is not None:
                self._stop_profiler(prof)
            self._frames.close()
            if self.mesh.size == 1 or self.failed is None:
                self.save_map(last_idx)
                self.save_results(last_idx)
        if self.mesh.size > 1:
            self._print_rank_summary()

    def n_gaussians(self) -> int:
        """Rows of the whole map (every rank's)."""
        return sum(self.mesh.row_counts(self.gaussians.n))

    def _print_rank_summary(self):
        """One line per rank, ``[rank r/W] {json}``: its rows, its kernel
        launches (all, and over a tile window), its ms per tracking and
        mapping iteration (with debug.get_runtime_stats; null without) and
        a SHA-1 of its pose list, which every rank must share. The ranks
        share one stdout, so the line goes out in one write, after
        everything printed before it: a line split over two writes can be
        joined to another rank's."""
        import hashlib
        import json

        from ..ops import kernels

        def per_it(total, n):
            return total / n * 1e3 if n else None

        line = f"[rank {self.mesh.rank}/{self.mesh.size}] " + json.dumps({
            "gaussians": self.gaussians.n,
            "launches": kernels.launch_counts(),
            "launches_windowed": kernels.launch_counts_windowed(),
            "ms_track": per_it(self.tracking_time_sum, self.tracking_iter_count),
            "ms_map": per_it(self.mapper.mapping_time_sum, self.mapper.mapping_iter_count),
            "pose_sha1": hashlib.sha1(self.estimate_pose_list.tobytes()).hexdigest()})
        sys.stdout.flush()
        sys.stdout.write(line + "\n")
        sys.stdout.flush()

    def _start_profiler(self):
        """debug.jax_profiler_dir: a torch.profiler trace of the whole run."""
        if not self.cfg["debug"].get("jax_profiler_dir"):
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof):
        self._sync()
        prof.stop()
        trace_dir = str(self.cfg["debug"]["jax_profiler_dir"])
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        print(f"torch profiler trace written to {trace_dir}")

    def _phase(self, name: str, t0: float) -> float:
        """Book the time since t0 to a frame-decomposition phase, which ends
        at a card synchronize; returns a fresh t0."""
        if not self._decomp_on:
            return t0
        self._sync()
        t1 = time.perf_counter()
        self.frame_decomp[name] += t1 - t0
        return t1

    def _step(self, idx: int):
        t0 = time.perf_counter()
        gt_color_np, gt_depth_np, _, gt_c2w, imu_meas = self._frames[idx]
        gt_depth_np = gt_depth_np[..., 0]
        gt_w2c = np.linalg.inv(gt_c2w)
        gt_color_np = np.transpose(gt_color_np, (2, 0, 1)) / 255.0
        gt_color = self._dev(gt_color_np)
        gt_depth = self._dev(gt_depth_np)
        t0 = self._phase("data", t0)

        est_depth = None
        if self.dpt is not None:
            if hasattr(self.dpt, "gt_depth"):
                self.dpt.gt_depth = gt_depth_np
            est_depth = self.dpt.estimate_depth(gt_color_np)
            t0 = self._phase("depth_est", t0)

        if idx == 0 or self.cfg["tracking"]["use_gt_pose"]:
            self.estimate_pose_list[idx] = _pose7(gt_w2c)
        else:
            seed = self._seed_pose(idx, imu_meas)
            self.seed_pose_list[idx] = seed
            self._sync()
            t1 = time.perf_counter()
            pose, _ = track_frame(self.gaussians.activated(), self._dev(seed), gt_color,
                                  gt_depth, torch.zeros_like(gt_depth) if est_depth is None
                                  else est_depth, self.track_settings)
            pose = pose.cpu().numpy()
            if self.cfg["debug"]["get_runtime_stats"]:
                self.tracking_time_sum += time.perf_counter() - t1
                self.tracking_iter_count += self.track_settings.iters
            self.estimate_pose_list[idx] = pose
        t0 = self._phase("track", t0)

        est_scaled = est_scaled_np = None
        if est_depth is not None:
            est_scaled = self._fit_est_depth(idx, est_depth, gt_depth)
            est_scaled_np = est_scaled.cpu().numpy()
            t0 = self._phase("depth_fit", t0)
        if idx == 0:
            self.mapper.camera_extent = self.get_scene_radius(
                gt_depth if est_scaled is None else est_scaled)
        self._sync()
        t1 = time.perf_counter()
        self.gaussians, self.adam, self.estimate_pose_list[idx] = self.mapper.run_frame(
            idx, self.gaussians, self.adam, self.estimate_pose_list[idx], gt_color,
            gt_depth, est_scaled, gt_color_np, gt_depth_np, est_scaled_np, self.n_img)
        self._sync()
        if self.cfg["debug"]["get_runtime_stats"]:
            self.mapper.mapping_time_sum += time.perf_counter() - t1
            self.mapper.mapping_iter_count += self.mapper.num_iter
        # the mapper booked its own map.* phases; binning is sized exactly,
        # so the overflow check has nothing to fetch
        t0 = self._phase("overflow_check", time.perf_counter())
        self.gt_pose_list[idx] = _pose7(gt_w2c)
        if self.cfg["debug"]["create_video"] and idx > 0:
            self._write_video_frame(idx, gt_color_np, gt_depth_np, est_scaled_np)
        self._phase("logging", t0)

    @torch.no_grad()
    def render_eval(self, idx: int):
        """One no-grad eval or video render (rgb [3, H, W], depth [3, H, W]),
        timed into "Average Rendering Time"."""
        self._sync()
        t0 = time.perf_counter()
        out = render_sharded(self.gaussians.activated(), self._dev(self.estimate_pose_list[idx]),
                             self.rs, self.mesh)
        self._sync()
        self.rendering_time_sum += time.perf_counter() - t0
        self.rendering_iter_count += 1
        return out["render"], out["depth"]

    @torch.no_grad()
    def evaluate_images(self, last_idx: int):
        """PSNR, SSIM, LPIPS and the LPIPS proxy every eval_every frames
        (SLAM.py:197-231), on the SLAM's device."""
        psnrs, ssims, lpipss, proxies = [], [], [], []
        for idx in range(last_idx):
            if idx != 0 and (idx + 1) % self.cfg["eval_every"] != 0:
                continue
            gt_color_np = self.dataset[idx][0]
            gt = self._dev(np.transpose(gt_color_np, (2, 0, 1)) / 255.0)
            img, _ = self.render_eval(idx)
            psnrs.append(float(psnr_fn(img, gt)))
            ssims.append(float(ssim_fn(img, gt)))
            lpipss.append(lpips_fn(img, gt))
            proxies.append(lpips_proxy(img, gt))
        return psnrs, ssims, lpipss, proxies

    def _write_video_frame(self, idx, gt_color_np, gt_depth_np, est_depth_np):
        """rgb | render | |error| over GT depth | render depth | the scaled
        estimate (GT depth without one), viridis (JAX slam.py:747-765). Under
        a mesh every rank renders, rank 0 writes."""
        import cv2

        img, depth = self.render_eval(idx)
        if self.video_writer is None:
            return
        img, depth = img.cpu().numpy(), depth[0].cpu().numpy()
        row1 = np.concatenate([gt_color_np, img, np.abs(img - gt_color_np)], axis=2)
        third = gt_depth_np if est_depth_np is None else est_depth_np
        row2 = np.concatenate([depth_to_rgb_np(gt_depth_np), depth_to_rgb_np(depth),
                               depth_to_rgb_np(third)], axis=2)
        frame = np.concatenate([row1, row2], axis=1)   # [3, 2H, 3W]
        frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
        self.video_writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def full_map(self) -> G.GaussianMap:
        """The whole map: every rank's rows, in rank order, on every rank (a
        collective)."""
        counts = self.mesh.row_counts(self.gaussians.n)
        return G.GaussianMap(*(gather_rows(t.detach(), self.mesh, counts)
                               for t in self.gaussians))

    def save_map(self, iteration: int):
        path = os.path.join(self.output, "point_cloud", f"iteration_{iteration}",
                            "point_cloud.ply")
        m = self.full_map()
        if not self.is_writer:
            return
        d = G.to_numpy_dict(m)
        n_rest_true = (self.cfg["mapping"]["sh_degree"] + 1) ** 2 - 1
        save_ply(path, xyz=d["xyz"], features_dc=d["features_dc"],
                 features_rest=d["features_rest"][:, :n_rest_true], opacity=d["opacity"],
                 scaling=d["scaling"], rotation=d["rotation"], rgb=d["rgb"])
        print("Map saved to " + path)

    def save_results(self, last_idx: int):
        """results.npz and the printed metrics; under a mesh every rank
        renders the eval frames and rank 0 alone prints and writes."""
        est = self.estimate_pose_list[:last_idx]
        gt = self.gt_pose_list[:last_idx]
        results = {"pose_est": est, "pose_gt": gt}
        if self.video_writer is not None:
            self.video_writer.release()
        if not self.is_writer:
            if last_idx > 0:
                self.evaluate_images(last_idx)
            return
        results["keyframes"] = np.array(
            [{"idx": kf.idx, "gt_color": kf.gt_color, "est_pose": kf.pose,
              "gt_depth": kf.gt_depth, "est_depth": kf.est_depth}
             for kf in self.mapper.keyframes], dtype=object)
        if last_idx > 0:
            _, ate = evaluate_ate_rmse(est, gt, method="umeyama")
            results["ate_rmse"] = ate
            print(f"Average Trajectory Error RMSE: {ate} m")
            psnrs, ssims, lpipss, proxies = self.evaluate_images(last_idx)
            results.update(psnr_list=psnrs, ssim_list=ssims, lpips_list=lpipss,
                           lpips_proxy_list=proxies)
            if psnrs:
                print("  PSNR : {:>12.7f}".format(np.mean(psnrs)))
                print("  SSIM : {:>12.7f}".format(np.mean(ssims)))
                finite = [x for x in lpipss if np.isfinite(x)]
                print("  LPIPS: {:>12.7f}".format(np.mean(finite) if finite else float("nan")))
                if not finite:
                    # random-VGG perceptual distance, comparable only with itself
                    print("  LPIPS-proxy (random-VGG, uncalibrated): "
                          "{:>12.7f}".format(np.mean(proxies)))
        if self.cfg["debug"]["get_runtime_stats"]:
            t_it = self.tracking_time_sum / max(self.tracking_iter_count, 1)
            m_it = self.mapper.mapping_time_sum / max(self.mapper.mapping_iter_count, 1)
            r_it = self.rendering_time_sum / max(self.rendering_iter_count, 1)
            print(f"\nAverage Tracking/Iteration Time: {t_it * 1000} ms")
            print(f"Average Mapping/Iteration Time: {m_it * 1000} ms")
            print(f"Average Rendering Time: {r_it * 1000} ms")
            results["avg_tracking_it_time"] = t_it * 1000
            results["avg_mapping_it_time"] = m_it * 1000
            results["avg_rendering_time"] = r_it * 1000
        results["binning_overflow_frames"] = np.zeros((0,), np.int64)
        if self._decomp_on and last_idx > 0:
            results.update(self._decomp_table())
        np.savez(os.path.join(self.output, "results"), **results)
        print("Results saved to " + os.path.join(self.output, "results.npz"))

    def _decomp_table(self) -> dict:
        """Print the per-frame decomposition (median over frames = steady
        state, and mean) and return its results.npz entries."""
        phases = sorted(self.frame_decomp, key=self.frame_decomp.get, reverse=True)
        rows = self.frame_decomp_rows
        print(f"\nPer-frame wall decomposition (debug.frame_decomp, {len(rows)} frames; "
              "median = steady state):")
        print(f"  {'phase':<24s} {'median':>10s} {'mean':>10s}  ms/frame")
        tot_med = tot_mean = 0.0
        for name in phases:
            per = np.asarray([r.get(name, 0.0) for r in rows])
            med, mean = float(np.median(per)), float(per.mean())
            tot_med += med
            tot_mean += mean
            print(f"  {name:<24s} {med * 1000:>10.1f} {mean * 1000:>10.1f}")
        print(f"  {'(sum)':<24s} {tot_med * 1000:>10.1f} {tot_mean * 1000:>10.1f}")
        return {"frame_decomp": np.array(dict(self.frame_decomp), dtype=object),
                "frame_decomp_phases": np.asarray(phases, dtype=object),
                "frame_decomp_rows": np.asarray(
                    [[r.get(name, 0.0) for name in phases] for r in rows], np.float64)}
