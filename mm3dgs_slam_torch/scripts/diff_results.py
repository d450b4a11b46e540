"""Cross-run parity diff: compare two SLAM run outputs metric by metric
against the 1% thresholds (JAX counterpart: scripts/diff_results.py; the
same checks, the same PASS/FAIL/SKIP lines, the same exit code).

    python -m mm3dgs_slam_torch.scripts.diff_results RUN_A_DIR RUN_B_DIR \\
        [--rel-tol 0.01] [--ate-abs-floor 0.002] [--exact]

Either package's output directory works (both write the same artifacts):
  <dir>/results.npz           pose_est [N, 7] w2c, pose_gt, ate_rmse,
                              psnr_list / ssim_list / lpips_list
  <dir>/point_cloud/iteration_<k>/point_cloud.ply   (optional, map diff)

Checks (each ok or FAIL; exit code 1 on any FAIL):
  * headline metrics (ate_rmse, mean psnr / ssim / lpips) within --rel-tol
    relative (ATE also passes when |a - b| is under --ate-abs-floor m),
  * trajectory cross-ATE: B's estimated trajectory Umeyama-aligned onto A's
    within max(rel_tol * trajectory extent, ate_abs_floor),
  * PLY maps (when both exist): Gaussian counts within rel_tol, and the
    mean opacity, mean log-scale and xyz extent within 5 * rel_tol.
A metric NaN on both sides is SKIP (LPIPS without weights); NaN on one side
only is FAIL. --exact also requires the two runs to be the same bits
(`same_bits`: two runs of one commit on one card are).
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def _load_results(d):
    p = os.path.join(d, "results.npz")
    if not os.path.exists(p):
        raise SystemExit(f"missing {p}")
    return np.load(p, allow_pickle=True)


def _latest_ply(d):
    cands = sorted(
        glob.glob(os.path.join(d, "point_cloud", "iteration_*", "point_cloud.ply")),
        key=lambda s: int(s.split("iteration_")[1].split(os.sep)[0]))
    return cands[-1] if cands else None


def _mean_list(res, key):
    if key not in res:
        return float("nan")
    v = np.asarray(res[key], dtype=np.float64).ravel()
    v = v[np.isfinite(v)]
    return float(v.mean()) if v.size else float("nan")


class Report:
    def __init__(self):
        self.failed = False

    def check(self, name, a, b, rel_tol, abs_floor=0.0):
        if np.isnan(a) and np.isnan(b):
            print(f"  SKIP {name}: NaN on both sides")
            return
        if np.isnan(a) != np.isnan(b):
            print(f"  FAIL {name}: {a} vs {b} (NaN on one side only)")
            self.failed = True
            return
        rel = abs(a - b) / max(abs(a), abs(b), 1e-12)
        ok = rel <= rel_tol or abs(a - b) <= abs_floor
        print(f"  {'ok  ' if ok else 'FAIL'} {name}: {a:.6g} vs {b:.6g} "
              f"(rel {rel * 100:.3f}%, tol {rel_tol * 100:.2f}%)")
        self.failed |= not ok


def diff(run_a: str, run_b: str, rel_tol: float = 0.01, ate_abs_floor: float = 0.002) -> bool:
    """Print the checks; returns True when any failed."""
    from ..eval.ate import camera_centers, evaluate_ate_rmse
    from ..models.ply_io import load_ply

    ra, rb = _load_results(run_a), _load_results(run_b)
    rep = Report()
    print(f"[headline metrics]  A={run_a}  B={run_b}")
    rep.check("ate_rmse (w2c, umeyama)", float(ra.get("ate_rmse", np.nan)),
              float(rb.get("ate_rmse", np.nan)), rel_tol, ate_abs_floor)
    for key in ("psnr_list", "ssim_list", "lpips_list"):
        rep.check(f"mean {key[:-5]}", _mean_list(ra, key), _mean_list(rb, key), rel_tol)

    print("[trajectory cross-ATE]")
    pa, pb = np.asarray(ra["pose_est"]), np.asarray(rb["pose_est"])
    if pa.shape != pb.shape:
        print(f"  FAIL pose_est shapes differ: {pa.shape} vs {pb.shape}")
        rep.failed = True
    else:
        _, cross = evaluate_ate_rmse(pb, pa, method="umeyama")
        ca = camera_centers(pa)
        extent = float(np.linalg.norm(ca.max(0) - ca.min(0)))
        thr = max(rel_tol * extent, ate_abs_floor)
        print(f"  {'ok  ' if cross <= thr else 'FAIL'} cross-ATE(B->A): {cross:.6f} m "
              f"(threshold {thr:.6f}, traj extent {extent:.3f} m)")
        rep.failed |= cross > thr

    ply_a, ply_b = _latest_ply(run_a), _latest_ply(run_b)
    if ply_a and ply_b:
        print("[map PLY]")
        ma, mb = load_ply(ply_a), load_ply(ply_b)
        xa, xb = ma["xyz"], mb["xyz"]
        rep.check("gaussian count", float(len(xa)), float(len(xb)), rel_tol)
        for name, va, vb in (
                ("opacity mean", ma["opacity"].mean(), mb["opacity"].mean()),
                ("scale mean", ma["scaling"].mean(), mb["scaling"].mean()),
                ("xyz extent", np.linalg.norm(xa.max(0) - xa.min(0)),
                 np.linalg.norm(xb.max(0) - xb.min(0)))):
            rep.check(name, float(va), float(vb), 5 * rel_tol)
    else:
        print(f"[map PLY] skipped (A: {ply_a or 'none'}, B: {ply_b or 'none'})")
    print("PARITY:", "FAIL" if rep.failed else "PASS")
    return rep.failed


EXACT_KEYS = ("pose_est", "psnr_list", "ssim_list", "lpips_proxy_list", "ate_rmse")


def same_bits(run_a: str, run_b: str) -> bool:
    """Whether two runs are the same bits: results.npz's EXACT_KEYS
    np.array_equal and the same PLY files under both directories, byte-equal.
    Prints one line per check."""
    ra, rb = _load_results(run_a), _load_results(run_b)
    ok = True
    for k in EXACT_KEYS:
        eq = k in ra and k in rb and np.array_equal(ra[k], rb[k])
        print(f"  {'ok  ' if eq else 'FAIL'} {k}: {'equal' if eq else 'differs'}")
        ok &= eq
    plys = [sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, "**", "*.ply"),
                                                            recursive=True))
            for d in (run_a, run_b)]

    def read(d, f):
        with open(os.path.join(d, f), "rb") as fh:
            return fh.read()

    eq = bool(plys[0]) and plys[0] == plys[1] and all(
        read(run_a, f) == read(run_b, f) for f in plys[0])
    print(f"  {'ok  ' if eq else 'FAIL'} PLY files {plys[0]} / {plys[1]}: "
          f"{'byte-equal' if eq else 'differ'}")
    return ok and eq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="compare two SLAM run outputs")
    ap.add_argument("run_a")
    ap.add_argument("run_b")
    ap.add_argument("--rel-tol", type=float, default=0.01,
                    help="relative tolerance for headline metrics (1%%)")
    ap.add_argument("--ate-abs-floor", type=float, default=0.002,
                    help="absolute ATE agreement floor in meters")
    ap.add_argument("--exact", action="store_true",
                    help="also require the same bits (results.npz and PLY files)")
    args = ap.parse_args(argv)
    failed = diff(args.run_a, args.run_b, args.rel_tol, args.ate_abs_floor)
    if args.exact:
        print("[bit-identity]")
        same = same_bits(args.run_a, args.run_b)
        print("BIT-IDENTICAL:", "PASS" if same else "FAIL")
        failed |= not same
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
