"""What decides `correct`: the program's outputs on one frame of the window
against the plain reference (reference.py), computed from the same inputs.

The reference follows the program from the program's own state where the
frame starts: the map it tracks against, the poses tracked before it, the
mapping window and its schedule (the program's decisions and host random
draws). It works out again everything else: the motion model's seed, the
render, the losses, the gradients and the optimizer steps. The start that
this skips, frame 0's new Gaussians, is checked by itself.

The numbers compared (each against its own limit, limits/<cell>.json):

  frame_rgb_gap, frame_depth_gap  largest |program - reference| of the colour
                                  and depth the loop hands tracking and
                                  mapping (the checked frame and its mapping
                                  window's keyframes). In the synthetic cells
                                  the benchmark renders the frames itself
                                  (scene.py) and hands them to the port's
                                  loader, so these hold the loader's
                                  hand-off of them, not the port's renderer;
                                  in UT-MM the port decodes the PNGs the
                                  benchmark wrote
  seed_xyz_gap                    frame 0's new Gaussians: largest centre gap
                                  (m); infinite where their counts differ
  seed_pose_gap                   the pose tracking starts from against the
                                  reference's constant-velocity seed from the
                                  program's two poses before the frame (the
                                  last pose at frame 1): largest gap of the
                                  [R | t] entries. Cells with the IMU motion
                                  model do not compare it (numbers_for)
  track_loss_gap                  tracking from the same seed pose: largest
                                  relative gap of the losses of its first
                                  three iterations and, where tracking
                                  rebuilds its bins every r > 2 iterations,
                                  of iterations r and r + 1, the first on
                                  bins built after iteration 0
  track_step_gap                  the pose's change over the first three Adam
                                  steps: | |dq| - |dq_ref| | / |dq_ref|, and
                                  the same for T; the worse of the two
  map_loss_gap                    the mapping loop's first three iterations
                                  (a prune, two Adam steps): largest relative
                                  gap of their losses
  map_grad_gap                    the first Adam step's gradient, by leaf:
                                  | |g_program| - |g_reference| | over the
                                  larger of the leaf's and the median leaf's
                                  reference norm; the worst leaf
  map_step_gap                    the same for the leaves' change over the two
                                  steps

and, only where the configuration sets mapping.do_BA (bundle adjustment:
the window's poses move with the map, a rebin every iteration, the map step
confined to a mask of rows), in which case the reference follows the pose
Adam and the program's mask in the three numbers above:

  ba_mask_gap                     the share of rows where the program's mask
                                  of the rows the map step moves and the
                                  reference's differ (rows seen from at
                                  least two window poses, or appended this
                                  frame); infinite where their counts differ
  map_pose_step_gap               the window's poses' change over the first
                                  three iterations (three pose Adam steps,
                                  the prune's included): | |dq| - |dq_ref| |
                                  / |dq_ref| and the same for T; the worst
                                  of the slots that the reference moved

The tracked pose after all its iterations is printed beside them, not
judged: its largest gap to the reference's (pose_gap) and the relative gap
of the reference's loss at the two poses (pose_loss_gap). Where the loss is
flat, Adam walks a converged pose by round-off alone, so sound runs and
the bfloat16 control read alike there (PERF.md, "The check").

Leaves whose reference gradient is under a thousandth of the median leaf's
(features_rest and rgb at sh degree 0, which the render never reads) are
left out of map_grad_gap and map_step_gap.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference as ref
from . import scene as sc

NUMBERS = ("frame_rgb_gap", "frame_depth_gap", "seed_xyz_gap", "seed_pose_gap",
           "track_loss_gap", "track_step_gap", "map_loss_gap", "map_grad_gap", "map_step_gap",
           "ba_mask_gap", "map_pose_step_gap")
BA_NUMBERS = ("ba_mask_gap", "map_pose_step_gap")


def _dyn_model(cfg: dict):
    return (cfg["tracking"].get("dynamics_model") or "").lower() or None


def _do_ba(cfg: dict) -> bool:
    return bool(cfg["mapping"].get("do_BA", False))


def numbers_for(cfg: dict) -> tuple:
    """The numbers a cell compares: all, less seed_pose_gap where the motion
    model is the IMU's, which the reference does not have, and less the
    bundle adjustment's numbers where mapping.do_BA is not set."""
    return tuple(k for k in NUMBERS if (k != "seed_pose_gap" or _dyn_model(cfg) != "imu")
                 and (k not in BA_NUMBERS or _do_ba(cfg)))


def track_held(cfg: dict) -> list:
    """Tracking iterations whose losses are compared: 0-2 and, where bins
    are rebuilt every r > 2 iterations, r and r + 1."""
    r, iters = int(cfg.get("tpu", {}).get("rebin_every", 1)), int(cfg["tracking"]["iters"])
    return [0, 1, 2] + ([r, r + 1] if 2 < r and r + 1 < iters else [])


def track_record(cfg: dict) -> int:
    """Tracking iterations whose pose and loss the harness keeps."""
    return max(track_held(cfg) + [3]) + 1


def track_spec(cfg: dict) -> ref.TrackSpec:
    tr = cfg["tracking"]
    return ref.TrackSpec(
        iters=int(tr["iters"]), rebin_every=int(cfg.get("tpu", {}).get("rebin_every", 1)),
        position_lr=float(tr["position_lr"]), rotation_lr=float(tr["rotation_lr"]),
        use_depth_loss=bool(tr.get("use_depth_estimate_loss", False)) and cfg["use_gt_depth"],
        pearson_weight=float(tr.get("pearson_weight", 0.0)),
        force_isotropic=_isotropic(cfg))


def _isotropic(cfg: dict) -> bool:
    pl = cfg.get("pipeline", {})
    return bool(pl.get("force_isotropic", False)) and not bool(pl.get("compute_cov3D_python",
                                                                      False))


def map_spec(cfg: dict) -> ref.MapSpec:
    mp = cfg["mapping"]
    lr_xyz = mp["position_lr_init"] * mp["spatial_lr_scale"]
    lrs = dict(xyz=lr_xyz, features_dc=mp["feature_lr"], features_rest=mp["feature_lr"] / 20.0,
               scaling=mp["scaling_lr"], rotation=mp["rotation_lr"], opacity=mp["opacity_lr"],
               rgb=mp["rgb_lr"])
    return ref.MapSpec(
        lambda_dssim=float(mp["lambda_dssim"]),
        use_depth_loss=bool(mp.get("use_depth_estimate_loss", False)) and cfg["use_gt_depth"],
        pearson_weight=float(mp.get("pearson_weight", 0.0)),
        min_opacity=float(mp["min_opacity"]),
        size_threshold=None if mp.get("size_threshold") is None else float(mp["size_threshold"]),
        pruning_interval=int(mp["pruning_interval"]),
        densify_from_iter=int(mp["densify_from_iter"]),
        densify_until_iter=int(mp["densify_until_iter"]),
        rebin_every=int(cfg.get("tpu", {}).get("map_rebin_every", 1)), lrs=lrs,
        force_isotropic=_isotropic(cfg), do_BA=_do_ba(cfg),
        cam_q_lr=float(mp.get("cam_q_lr", 0.0)), cam_t_lr=float(mp.get("cam_t_lr", 0.0)))


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _norm_gaps(prog: dict, refd: dict, ref_grad: dict) -> float:
    """Worst leaf's | |prog| - |ref| | over max(|ref leaf|, |median leaf|),
    leaves with a reference gradient under 1e-3 of the median leaf's left out."""
    gnorm = {f: float(ref_grad[f].double().norm()) for f in ref.LEAVES}
    med_g = float(np.median(list(gnorm.values())))
    kept = [f for f in ref.LEAVES if gnorm[f] >= 1e-3 * med_g and gnorm[f] > 0.0]
    rn = {f: float(refd[f].double().norm()) for f in kept}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    worst = 0.0
    for f in kept:
        pn = float(prog[f].double().norm())
        worst = max(worst, abs(pn - rn[f]) / max(rn[f], med, 1e-30))
    return worst


class Inputs:
    """The benchmark's own copy of the cell's frames (the same arrays the
    program was handed) and camera."""

    def __init__(self, cam: ref.Cam, frames: list, w2c0: np.ndarray):
        self.cam, self.frames, self.w2c0 = cam, frames, w2c0


def frame_gaps(cap: dict, inputs: Inputs) -> tuple[float, float]:
    """The checked frame's colour and depth, and each mapping-window frame
    matched to the nearest of the benchmark's frames."""
    seen = [(cap["track_in"]["color"], cap["track_in"]["depth"], cap["check_idx"])]
    for c, d in zip(cap["map_in"]["kf_colors"], cap["map_in"]["kf_depths"]):
        seen.append((c, d, None))
    rgb_gap = depth_gap = 0.0
    for c, d, idx in seen:
        cands = [idx] if idx is not None else range(len(inputs.frames))
        best = min(cands, key=lambda j: _gap(c, torch.as_tensor(inputs.frames[j][0])))
        rgb_gap = max(rgb_gap, _gap(c, torch.as_tensor(inputs.frames[best][0])))
        depth_gap = max(depth_gap, _gap(d, torch.as_tensor(inputs.frames[best][1])))
    return rgb_gap, depth_gap


def seed_numbers(cap: dict, inputs: Inputs, device, dtype) -> dict:
    color, depth = (torch.as_tensor(a, device=device) for a in inputs.frames[0])
    xyz, _, _, _ = ref.first_frame_gaussians(color, depth, torch.as_tensor(inputs.w2c0,
                                                                           device=device),
                                             inputs.cam, dtype)
    return dict(xyz=xyz.float().cpu())


def _track_inputs(cap: dict, inputs: Inputs, device, dtype):
    t = cap["track_in"]
    pdt = ref.param_dtype(dtype)
    xyz, scales, rots, op, shs = (x.to(device=device, dtype=pdt) for x in t["g"][:5])
    g = ref.Gaussians(xyz, scales, rots, op, torch.clamp(ref.SH_C0 * shs[:, 0, :] + 0.5, min=0.0))
    color, depth = (torch.as_tensor(a, device=device) for a in inputs.frames[cap["check_idx"]])
    return g, color, depth


def tracked(cap: dict, inputs: Inputs, cfg: dict, device, dtype) -> dict:
    """The reference's tracking of the checked frame from the program's map
    and seed pose (reference.track)."""
    g, color, depth = _track_inputs(cap, inputs, device, dtype)
    return ref.track(g, cap["track_in"]["pose"].to(device), color, depth, inputs.cam,
                     track_spec(cfg), dtype, n_record=track_record(cfg))


def pose_loss_gap(cap: dict, inputs: Inputs, cfg: dict, device, pose, pose_ref) -> float:
    """How far the reference's tracking loss (float32, bins built at the
    pose) at `pose` lies from its loss at the reference's own answer,
    relative to the latter."""
    g, color, depth = _track_inputs(cap, inputs, device, torch.float32)
    ts = track_spec(cfg)
    best = ref.track_loss_at(g, pose_ref, color, depth, inputs.cam, ts, torch.float32)
    return abs(ref.track_loss_at(g, pose, color, depth, inputs.cam, ts, torch.float32)
               - best) / max(abs(best), 1e-30)


def _early_gaps(early, early_ref, held) -> tuple[float, float]:
    """(largest relative gap of the held iterations' losses, worst of q and
    T of | |p3 - p0| - |p3 - p0|_ref | / |p3 - p0|_ref)."""
    if len(early) <= max(held + [3]):
        return float("inf"), float("inf")
    lg = max(abs(early[i][1] - early_ref["losses"][i]) / max(abs(early_ref["losses"][i]), 1e-30)
             for i in held)
    d, d_ref = early[3][0] - early[0][0], early_ref["poses"][3] - early_ref["poses"][0]
    sg = max(abs(float(d[s].double().norm()) - float(d_ref[s].double().norm()))
             / max(float(d_ref[s].double().norm()), 1e-30) for s in (slice(0, 4), slice(4, 7)))
    return lg, sg


def seed_pose_gap(cap: dict, cfg: dict, dtype) -> float:
    """Largest entry gap of [R | t] between the pose tracking started from
    and the reference's seed from the program's earlier poses."""
    w_ref = ref.seed_pose(cap["seed_prev"], _dyn_model(cfg), dtype).double()
    w_prog = ref.pose_to_w2c(cap["track_in"]["pose"].double())
    return _gap(w_prog[:3], w_ref[:3])


def map_steps(cap: dict, cfg: dict, cam: ref.Cam, device, dtype, row_mask=None) -> dict:
    m = cap["map_in"]
    on = lambda d: {f: t.to(device) for f, t in d.items()}  # noqa: E731
    return ref.map_iterations(on(m["leaves"]), on(m["mu"]), on(m["nu"]), int(m["step"]),
                              m["max_radii"].to(device), float(m["extent"]),
                              m["kf_colors"].to(device), m["kf_depths"].to(device),
                              m["kf_poses"].to(device), m["schedule"], 3, cam,
                              map_spec(cfg), dtype,
                              row_mask=None if row_mask is None else row_mask.to(device))


def ba_mask_ref(cap: dict, cfg: dict, cam: ref.Cam, device, dtype) -> torch.Tensor:
    """The reference's mask of the rows bundle adjustment's map step moves,
    from the map, the window's poses and the rows appended this frame as
    the mapping loop received them."""
    m = cap["map_in"]
    return ref.ba_mask({f: t.to(device) for f, t in m["leaves"].items()},
                       m["kf_poses"].to(device), int(m["n_added"]), cam,
                       map_spec(cfg).force_isotropic, dtype).cpu()


def _mask_gap(mask, mask_ref) -> float:
    """Share of rows where two masks differ; infinite where their counts do."""
    if mask is None or mask.shape != mask_ref.shape:
        return float("inf")
    return float((mask != mask_ref).sum()) / max(mask_ref.numel(), 1)


def _pose_step_gap(poses, poses_ref, start) -> float:
    """Worst, over the window's slots that the reference moved and over q
    and T, of | |d| - |d_ref| | / |d_ref|, d the poses' change over the
    first three iterations."""
    if poses is None or len(poses) < 3 or poses[2].shape != poses_ref[2].shape:
        return float("inf")
    d, d_ref = poses[2].double() - start.double(), poses_ref[2].double() - start.double()
    worst = 0.0
    for slot in range(d_ref.shape[0]):
        if not bool((d_ref[slot] != 0).any()):
            continue
        for s in (slice(0, 4), slice(4, 7)):
            n_ref = float(d_ref[slot, s].norm())
            worst = max(worst, abs(float(d[slot, s].norm()) - n_ref) / max(n_ref, 1e-30))
    return worst


def compare(cap: dict, inputs: Inputs, cfg: dict, device, control: bool = False,
            witness: bool = False) -> dict:
    """{"program": numbers, "pose_gap": the final poses' largest gap} and,
    with `control`, {"control": numbers}: the reference at bfloat16 put in
    the program's place; with `witness`, the reference's tracking in
    float64 beside the float32 one's and the program's."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    rgb_gap, depth_gap = frame_gaps(cap, inputs)
    seed_ref = seed_numbers(cap, inputs, device, f32)
    cand = cap["seed"]
    track_ref = tracked(cap, inputs, cfg, device, f32)
    held, names = track_held(cfg), numbers_for(cfg)
    ba = _do_ba(cfg)
    mask_ref = ba_mask_ref(cap, cfg, inputs.cam, device, f32) if ba else None
    # the reference's map step takes the program's mask: a fault in it shows once
    map_ref = map_steps(cap, cfg, inputs.cam, device, f32, row_mask=cap.get("ba_mask"))

    def numbers(frames, seed_xyz, early, pose, mp, seed_gap) -> dict:
        lg = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(mp["losses"], map_ref["losses"]))
        step_p = {f: mp["after"][f] - mp["before"][f] for f in ref.LEAVES}
        step_r = {f: map_ref["after"][f] - map_ref["before"][f] for f in ref.LEAVES}
        tl, ts_ = _early_gaps(early, track_ref, held)
        out = dict(
            frame_rgb_gap=frames[0], frame_depth_gap=frames[1],
            seed_xyz_gap=_gap(seed_xyz, seed_ref["xyz"]) if seed_xyz.shape == seed_ref[
                "xyz"].shape else float("inf"),
            seed_pose_gap=seed_gap,
            track_loss_gap=tl, track_step_gap=ts_,
            map_loss_gap=lg,
            map_grad_gap=_norm_gaps(mp["first_grad"], map_ref["first_grad"],
                                    map_ref["first_grad"]),
            map_step_gap=_norm_gaps(step_p, step_r, map_ref["first_grad"]),
            # printed, not judged (the module's docstring)
            pose_loss_gap=pose_loss_gap(cap, inputs, cfg, device, pose, track_ref["pose"]))
        if ba:
            out.update(ba_mask_gap=_mask_gap(mp["ba_mask"], mask_ref),
                       map_pose_step_gap=_pose_step_gap(mp["poses"], map_ref["poses"],
                                                        cap["map_in"]["kf_poses"]))
        if "seed_pose_gap" not in names:
            out.pop("seed_pose_gap")
        return out

    prog_map = dict(losses=cap["map_losses"], first_grad=cap["map_grad"],
                    before=cap["map_before"], after=cap["map_after"],
                    ba_mask=cap.get("ba_mask"), poses=cap.get("map_poses"))
    seed_gap = "seed_pose_gap" in names and seed_pose_gap(cap, cfg, torch.float32)
    out["program"] = numbers((rgb_gap, depth_gap), cand["xyz"][cand["mask"]],
                             cap["track_early"], cap["track_out"], prog_map, seed_gap)
    out["pose_gap"] = _gap(cap["track_out"], track_ref["pose"])
    if control:
        frames_c = (max(_gap(torch.as_tensor(f[0]).to(bf16).float(), torch.as_tensor(f[0]))
                        for f in inputs.frames),
                    max(_gap(torch.as_tensor(f[1]).to(bf16).float(), torch.as_tensor(f[1]))
                        for f in inputs.frames))
        seed_c = seed_numbers(cap, inputs, device, bf16)
        track_c = tracked(cap, inputs, cfg, device, bf16)
        early_c = list(zip(track_c["poses"], track_c["losses"]))
        mask_c = ba_mask_ref(cap, cfg, inputs.cam, device, bf16) if ba else None
        map_c = map_steps(cap, cfg, inputs.cam, device, bf16, row_mask=mask_c)
        map_c = dict(map_c, first_grad={f: t.cpu() for f, t in map_c["first_grad"].items()},
                     ba_mask=mask_c)
        seed_gap_c = "seed_pose_gap" in names and _gap(
            ref.seed_pose(cap["seed_prev"], _dyn_model(cfg), bf16).double()[:3],
            ref.seed_pose(cap["seed_prev"], _dyn_model(cfg), f32).double()[:3])
        out["control"] = numbers(frames_c, seed_c["xyz"], early_c, track_c["pose"], map_c,
                                 seed_gap_c)
        out["control_pose_gap"] = _gap(track_c["pose"], track_ref["pose"])
    if witness:
        track_w = tracked(cap, inputs, cfg, device, torch.float64)
        out["witness"] = dict(pose_gap_ref32_ref64=_gap(track_ref["pose"], track_w["pose"]),
                              pose_gap_program_ref64=_gap(cap["track_out"], track_w["pose"]),
                              pose_loss_gap_ref64=pose_loss_gap(cap, inputs, cfg, device,
                                                            track_w["pose"], track_ref["pose"]))
    return out


def judge(numbers: dict, limits: dict, names) -> tuple[bool, list]:
    """(each of `names` within its limit, [(name, value, limit)])."""
    rows = [(k, float(numbers[k]), limits.get(k)) for k in names]
    ok = all(lim is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


def utmm_frames(root: str, cfg: dict, n: int) -> list:
    return [sc.read_utmm_frame(root, i, cfg) for i in range(n)]
