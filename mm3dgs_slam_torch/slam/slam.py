"""SLAM orchestrator: the per-frame track -> map loop and the artifact
writers (JAX counterpart: slam/slam.py; reference slam/SLAM.py:38-502).

Construct from a config dict and call `.run()`. Artifacts:
``point_cloud/iteration_N/point_cloud.ply`` and ``results.npz`` with the JAX
package's keys (pose_est, pose_gt, keyframes, ate_rmse, psnr_list,
ssim_list, lpips_list, lpips_proxy_list, avg_*_time,
binning_overflow_frames). LPIPS is not ported: its two lists hold NaN.
Binning is sized exactly, so binning_overflow_frames is always empty.

Ported paths: the const-velocity and IMU motion models (the IMU seed is
computed on the host, reproducing the JAX package: frame 1 seeds a zero
velocity, dt_imu is 1/100, at most `tpu.imu_pad` samples are integrated),
the IMU pose prior, GT depth or a monocular estimate (`use_gt_depth: false`:
the estimator runs on the SLAM's device and is rescaled per frame by the LS
scale/shift fit), and the vigs/mm3dgs method.

Not ported yet (they raise NotImplementedError at construction): the
splatam method, bundle adjustment (`mapping.do_BA`), checkpoint resume
(`iteration`) and the debug video (`debug.create_video`).
"""
from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch

from ..config import normalize_config, resolve_device
from ..data import get_dataset_type
from ..eval.ate import evaluate_ate_rmse
from ..eval.depth_est import get_dpt
from ..models import gaussians as G
from ..models.ply_io import save_ply
from ..ops.camera import Camera
from ..ops.depth import get_scale_shift_ls
from ..ops.losses import psnr as psnr_fn, ssim as ssim_fn
from ..ops.pose import propagate_const_vel, propagate_imu, w2c_to_pose
from ..ops.render import RenderSettings, render
from .mapper import Mapper
from .tracker import TrackSettings, track_frame


def _unported(cfg: dict) -> list[str]:
    checks = [
        (cfg["method"].lower() == "splatam", "method: splatam"),
        (bool(cfg["mapping"]["do_BA"]), "mapping.do_BA"),
        ("iteration" in cfg, "checkpoint resume (iteration)"),
        (bool(cfg["debug"]["create_video"]), "debug.create_video"),
    ]
    return [name for bad, name in checks if bad]


def _pose7(w2c: np.ndarray) -> np.ndarray:
    return w2c_to_pose(torch.as_tensor(w2c, dtype=torch.float32)).numpy()


class SLAM:
    def __init__(self, cfg: dict, device=None, scene: dict | None = None):
        """`device`: "cuda" (default) or "cpu"; `scene`: optional synthetic
        scene arrays (data/synthetic.py) in place of the generated one."""
        cfg = normalize_config(cfg)
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(f"not ported to mm3dgs_slam_torch yet: {missing}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.failed: BaseException | None = None

        extra = {"device": self.device, "scene": scene} if cfg["dataset"].lower() == "synthetic" else {}
        self.dataset = get_dataset_type(cfg["dataset"])(
            config_dict=cfg, basedir=cfg["inputdir"], sequence=cfg["scene"],
            start=cfg["start_idx"], end=cfg.get("early_stop_idx", -1),
            stride=cfg["stride"], desired_height=cfg["desired_height"],
            desired_width=cfg["desired_width"], relative_pose=True, **extra)
        self.n_img = len(self.dataset)
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
        self.adam = G.init_adam(self.gaussians)
        self.estimate_pose_list = np.zeros((self.n_img, 7), np.float32)
        self.gt_pose_list = np.zeros((self.n_img, 7), np.float32)
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
            rebin_every=int(cfg["tpu"].get("rebin_every", 1)))
        self.mapper = Mapper(cfg, self.rs, self.device)
        self.dpt = None
        if not cfg["use_gt_depth"]:
            self.dpt = get_dpt(cfg["dpt_model"], self.device, weights=cfg["dpt_weights"])
        self.tracking_time_sum = 0.0
        self.tracking_iter_count = 0
        self.rendering_time_sum = 0.0
        self.rendering_iter_count = 0
        self.frame_seconds: list[float] = []  # wall time of each completed frame

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
        silhouette > 0.99."""
        if idx == 0:
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
            out = render(self.gaussians.activated(), self._dev(self.estimate_pose_list[idx]),
                         self.rs)
        render_depth, sil = out["depth"][0], out["depth"][1]
        s, b = get_scale_shift_ls(est_depth, render_depth, (sil > 0.99) & (est_depth > 1e-6))
        return 1.0 / (s * est_depth + b)

    def run(self):
        """Run every frame, then save the map and results even when a frame
        fails (SLAM.py:494-502). A failure is printed and kept in
        `self.failed`."""
        print("Method: " + self.cfg["method"])
        last_idx = 0
        try:
            for idx in range(self.n_img):
                t_frame = time.perf_counter()
                self._step(idx)
                self._sync()
                self.frame_seconds.append(time.perf_counter() - t_frame)
                if self.cfg["debug"].get("get_runtime_stats"):
                    print(f"frame {idx + 1}/{self.n_img}: "
                          f"{self.frame_seconds[-1]:.2f}s, "
                          f"{self.gaussians.n} gaussians", flush=True)
                last_idx += 1
                if idx in (self.cfg.get("save_iterations") or []):
                    self.save_map(idx)
        except Exception as e:  # noqa: BLE001 — save-on-failure boundary
            traceback.print_exc()
            self.failed = e
            print("\nSLAM failed. Saving map and results.\n")
        finally:
            self.save_map(last_idx)
            self.save_results(last_idx)

    def _step(self, idx: int):
        gt_color_np, gt_depth_np, _, gt_c2w, imu_meas = self.dataset[idx]
        gt_depth_np = gt_depth_np[..., 0]
        gt_w2c = np.linalg.inv(gt_c2w)
        gt_color_np = np.transpose(gt_color_np, (2, 0, 1)) / 255.0
        gt_color = self._dev(gt_color_np)
        gt_depth = self._dev(gt_depth_np)

        est_depth = None
        if self.dpt is not None:
            if hasattr(self.dpt, "gt_depth"):
                self.dpt.gt_depth = gt_depth_np
            est_depth = self.dpt.estimate_depth(gt_color_np)

        if idx == 0 or self.cfg["tracking"]["use_gt_pose"]:
            self.estimate_pose_list[idx] = _pose7(gt_w2c)
        else:
            seed = self._seed_pose(idx, imu_meas)
            self.seed_pose_list[idx] = seed
            self._sync()
            t0 = time.perf_counter()
            pose, _ = track_frame(self.gaussians.activated(), self._dev(seed), gt_color,
                                  gt_depth, torch.zeros_like(gt_depth) if est_depth is None
                                  else est_depth, self.track_settings)
            pose = pose.cpu().numpy()
            if self.cfg["debug"]["get_runtime_stats"]:
                self.tracking_time_sum += time.perf_counter() - t0
                self.tracking_iter_count += self.track_settings.iters
            self.estimate_pose_list[idx] = pose

        est_scaled = est_scaled_np = None
        if est_depth is not None:
            est_scaled = self._fit_est_depth(idx, est_depth, gt_depth)
            est_scaled_np = est_scaled.cpu().numpy()
        if idx == 0:
            self.mapper.camera_extent = self.get_scene_radius(
                gt_depth if est_scaled is None else est_scaled)
        self._sync()
        t0 = time.perf_counter()
        self.gaussians, self.adam = self.mapper.run_frame(
            idx, self.gaussians, self.adam, self.estimate_pose_list[idx], gt_color,
            gt_depth, est_scaled, gt_color_np, gt_depth_np, est_scaled_np)
        self._sync()
        if self.cfg["debug"]["get_runtime_stats"]:
            self.mapper.mapping_time_sum += time.perf_counter() - t0
            self.mapper.mapping_iter_count += self.mapper.num_iter
        self.gt_pose_list[idx] = _pose7(gt_w2c)

    @torch.no_grad()
    def render_eval(self, idx: int):
        """One no-grad eval render, timed into "Average Rendering Time"."""
        self._sync()
        t0 = time.perf_counter()
        out = render(self.gaussians.activated(), self._dev(self.estimate_pose_list[idx]), self.rs)
        img = out["render"]
        self._sync()
        self.rendering_time_sum += time.perf_counter() - t0
        self.rendering_iter_count += 1
        return img

    @torch.no_grad()
    def evaluate_images(self, last_idx: int):
        """PSNR/SSIM every eval_every frames (SLAM.py:197-231); LPIPS is
        not ported, its lists hold NaN."""
        psnrs, ssims, lpipss, proxies = [], [], [], []
        for idx in range(last_idx):
            if idx != 0 and (idx + 1) % self.cfg["eval_every"] != 0:
                continue
            gt_color_np = self.dataset[idx][0]
            gt = self._dev(np.transpose(gt_color_np, (2, 0, 1)) / 255.0)
            img = self.render_eval(idx)
            psnrs.append(float(psnr_fn(img, gt)))
            ssims.append(float(ssim_fn(img, gt)))
            lpipss.append(float("nan"))
            proxies.append(float("nan"))
        return psnrs, ssims, lpipss, proxies

    def save_map(self, iteration: int):
        path = os.path.join(self.output, "point_cloud", f"iteration_{iteration}",
                            "point_cloud.ply")
        d = G.to_numpy_dict(self.gaussians)
        n_rest_true = (self.cfg["mapping"]["sh_degree"] + 1) ** 2 - 1
        save_ply(path, xyz=d["xyz"], features_dc=d["features_dc"],
                 features_rest=d["features_rest"][:, :n_rest_true], opacity=d["opacity"],
                 scaling=d["scaling"], rotation=d["rotation"], rgb=d["rgb"])
        print("Map saved to " + path)

    def save_results(self, last_idx: int):
        est = self.estimate_pose_list[:last_idx]
        gt = self.gt_pose_list[:last_idx]
        results = {"pose_est": est, "pose_gt": gt}
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
                print("  LPIPS: not ported (NaN)")
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
        np.savez(os.path.join(self.output, "results"), **results)
        print("Results saved to " + os.path.join(self.output, "results.npz"))
