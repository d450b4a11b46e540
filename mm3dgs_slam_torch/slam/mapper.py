"""Mapper: keyframes, covisibility graph, Gaussian growth and the map
optimization (JAX counterpart: slam/mapper.py; reference
slam/mapper.py:36-1014). The vigs/mm3dgs keyframe logic; the splatam
window selection and bundle adjustment are not ported yet.

Host randomness is one `np.random.default_rng(cfg seed)` stream drawn in the
JAX package's call order (covisible-window permutation, then the schedule),
so windows and schedules match it.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..eval.quality import FrameQuality
from ..models import gaussians as G
from ..ops.render import RenderSettings
from .map_ops import covis_check_last_kf, covisibility_fraction, kf_world_points, new_gaussian_candidates
from .map_opt import MapOptSettings, MapState, optimize_map


@dataclass
class KeyFrame:
    """Host-side keyframe record; `color`/`depth`/`est` live on the device."""

    idx: int
    gt_color: np.ndarray              # [3, H, W] float in [0, 1]
    pose: np.ndarray                  # [7]
    gt_depth: Optional[np.ndarray]    # [H, W]
    est_depth: Optional[np.ndarray]   # [H, W]
    niqe: Optional[float] = None


class Mapper:
    def __init__(self, cfg: dict, rs: RenderSettings, device: torch.device):
        self.cfg = cfg
        self.rs = rs
        self.cam = rs.cam
        self.device = device
        mp = cfg["mapping"]
        self.num_iter = int(mp["iters"])
        self.camera_extent = 0.0
        self.keyframes: List[KeyFrame] = []
        self._kf_tensors: list[tuple] = []   # (color, depth, est) on device
        self.covisibility_graph = defaultdict(set)
        self.quality = FrameQuality()
        if mp["niqe_kf"]:
            self.niqe_window: deque[KeyFrame] = deque(maxlen=mp["niqe_window_size"])
        self.rng = np.random.default_rng(cfg.get("seed", 0))
        self.mapping_time_sum = 0.0
        self.mapping_iter_count = 0
        self.max_new = int(cfg["tpu"].get("max_new_per_frame", -1))

        z = torch.zeros((0,), dtype=torch.float32, device=device)
        self.max_radii, self.grad_accum, self.denom = z, z, z
        self.opt_settings = MapOptSettings(
            rs=rs,
            iters=self.num_iter,
            use_gt_depth=cfg["use_gt_depth"],
            use_depth_estimate_loss=bool(mp["use_depth_estimate_loss"]),
            pearson_weight=float(mp["pearson_weight"]),
            lambda_dssim=float(mp["lambda_dssim"]),
            min_opacity=float(mp["min_opacity"]),
            size_threshold=(float(mp["size_threshold"])
                            if mp["size_threshold"] is not None else None),
            pruning_interval=int(mp["pruning_interval"]),
            densify_from_iter=int(mp["densify_from_iter"]),
            densify_until_iter=int(mp["densify_until_iter"]),
            hyper=G.MapOptHyper.from_cfg(mp),
            rebin_every=int(cfg["tpu"].get("map_rebin_every", 1)),
        )
        self.window_size = int(mp["kf_window_size"])
        self.group_schedule = bool(cfg["tpu"].get("group_mapping_schedule", False))

    def _dev(self, x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- keyframe decision (mapper.py:103-173) ---------------------------
    def need_new_keyframe(self, idx, g_act, est_pose, gt_color_np, gt_depth_np,
                          est_depth_np) -> bool:
        mp = self.cfg["mapping"]
        if mp["niqe_kf"]:
            score = self.quality(gt_color_np)
            curr = KeyFrame(idx, gt_color_np, np.asarray(est_pose), gt_depth_np,
                            est_depth_np, score)
            if idx >= mp["niqe_window_size"]:
                while (self.niqe_window
                       and self.niqe_window[0].idx <= idx - mp["niqe_window_size"]):
                    self.niqe_window.popleft()
            while self.niqe_window and score < self.niqe_window[-1].niqe:
                self.niqe_window.pop()
            self.niqe_window.append(curr)
        if len(self.keyframes) == 0 or idx == 0:
            return True
        last = self.keyframes[-1]
        frac = covis_check_last_kf(g_act, self._dev(last.pose), self._dev(est_pose), self.rs)
        if float(frac) > mp["min_covisibility"]:
            return False
        return idx - last.idx >= mp["kf_every"]

    def add_keyframe(self, idx, est_pose, gt_color_np, gt_depth_np, est_depth_np, g_act):
        """mapper.py:88-101: with niqe_kf the lowest-score window frame
        becomes the keyframe (possibly an earlier frame than idx)."""
        if self.cfg["mapping"]["niqe_kf"]:
            kf = self.niqe_window[0]
        else:
            kf = KeyFrame(idx, gt_color_np, np.asarray(est_pose), gt_depth_np, est_depth_np)
        self.keyframes.append(kf)
        self._kf_tensors.append((self._dev(kf.gt_color), self._dev(kf.gt_depth),
                                 self._dev(kf.est_depth)))
        if idx > 0:
            self.update_covisibility_graph(len(self.keyframes) - 1, g_act)
        return kf

    def update_covisibility_graph(self, key: int, g_act):
        """mapper.py:242-277: link the new keyframe to covisible ones."""
        pts, valid = kf_world_points(g_act, self._dev(self.keyframes[key].pose), self.rs)
        thr = self.cfg["mapping"]["kf_covisibility"]
        for kid, other in enumerate(self.keyframes[:-1]):
            f = float(covisibility_fraction(pts, valid, self._dev(other.pose), self.cam))
            if f > thr:
                self.covisibility_graph[key].add(kid)
                self.covisibility_graph[kid].add(key)

    def get_covisible_set(self, idx, N=1):
        """Covisibility-graph BFS (mapper.py:375-407): keyframe indices of the
        window, the current keyframe last."""
        if idx == 0:
            return []
        curr = len(self.keyframes) - 1
        covisible = {curr}
        for _ in range(N):
            frontier = set(covisible)
            for k in frontier:
                covisible |= set(self.covisibility_graph[k]) - covisible
            if frontier == covisible:
                break
        covisible.discard(curr)
        selected = [int(s) for s in self.rng.permutation(sorted(covisible))[: self.window_size - 2]]
        return selected + [curr]

    def _build_schedule(self, n_window: int) -> np.ndarray:
        """Replacement-stack sampling (mapper.py:801-807); with
        group_mapping_schedule the same per-entry quotas as contiguous
        blocks in random order (JAX mapper.py:344-372)."""
        if self.group_schedule:
            counts = np.zeros(n_window, np.int64)
            remaining = self.num_iter
            while remaining > 0:
                perm = self.rng.permutation(n_window)
                take = min(remaining, n_window)
                for e in perm[:take]:
                    counts[e] += 1
                remaining -= take
            blocks = self.rng.permutation(n_window)
            return np.concatenate([np.full(counts[b], b, np.int32) for b in blocks]).astype(np.int32)
        out = np.empty(self.num_iter, np.int32)
        stack: list[int] = []
        for i in range(self.num_iter):
            if not stack:
                stack = list(range(n_window))
            out[i] = stack.pop(int(self.rng.integers(0, len(stack))))
        return out

    # -- one mapping step (mapper.py:952-1014) ---------------------------
    def run_frame(self, idx, m: G.GaussianMap, adam: G.AdamState, est_pose,
                  gt_color, gt_depth, est_depth, gt_color_np, gt_depth_np, est_depth_np):
        """Returns (map, adam). gt_color/gt_depth/est_depth are device
        tensors (est_depth may be None); the *_np arrays feed keyframes."""
        g_act = m.activated()
        window = self.get_covisible_set(idx, N=self.cfg["mapping"]["covisibility_level"])
        if self.max_radii.shape[0] != m.n:
            self.max_radii = torch.zeros((m.n,), dtype=torch.float32, device=self.device)
            self.grad_accum = torch.zeros_like(self.max_radii)
            self.denom = torch.zeros_like(self.max_radii)

        if self.need_new_keyframe(idx, g_act, est_pose, gt_color_np, gt_depth_np, est_depth_np):
            depth_for_init = gt_depth if self.cfg["use_gt_depth"] else est_depth
            stats = new_gaussian_candidates(
                g_act, self._dev(est_pose), gt_color, depth_for_init, self.rs,
                first_frame=(idx == 0 and len(self.keyframes) == 0))
            m, adam, _ = G.append_gaussians(m, adam, stats.candidates, self.max_new)
            # densification resets the stats (gaussian_model.py:482-488)
            self.max_radii = torch.zeros((m.n,), dtype=torch.float32, device=self.device)
            self.grad_accum = torch.zeros_like(self.max_radii)
            self.denom = torch.zeros_like(self.max_radii)
            self.add_keyframe(idx, est_pose, gt_color_np, gt_depth_np, est_depth_np, m.activated())

        zeros = torch.zeros_like(gt_color[0])
        frames = [self._kf_tensors[k] for k in window] + [(gt_color, gt_depth, est_depth)]
        kf_colors = torch.stack([f[0] for f in frames])
        kf_depths = torch.stack([zeros if f[1] is None else f[1] for f in frames])
        kf_ests = torch.stack([zeros if f[2] is None else f[2] for f in frames])
        poses = [self.keyframes[k].pose for k in window] + [est_pose]
        kf_poses = torch.as_tensor(np.stack(poses), dtype=torch.float32, device=self.device)
        schedule = self._build_schedule(len(frames))

        st = optimize_map(MapState(m, adam, self.max_radii, self.grad_accum, self.denom),
                          kf_colors, kf_depths, kf_ests, kf_poses, schedule,
                          self.camera_extent, self.opt_settings)
        self.max_radii, self.grad_accum, self.denom = st.max_radii, st.grad_accum, st.denom
        return st.m, st.adam
