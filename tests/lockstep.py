"""One SLAM frame stepped with its decisions recorded, for either package,
and the table that compares such records. Imports neither package (nor
torch, nor JAX): `chip_smoke.py` uses it on the card beside the port.

`step_recorded(slam, idx)` runs `slam._step(idx)` as `run()` does and
returns the frame's record. Nothing is added to either package: the record
is read from the state before and after the step, from wrappers set on the
mapper instance for the step (need_new_keyframe, add_keyframe,
get_covisible_set, _build_schedule, run_frame), and from wrappers of the
mapper module's functions that the frame calls (covis_check_last_kf, the
keyframe covisibility fractions, new_gaussian_candidates, optimize_map),
each put back after the step. The one piece of extra work is BA's first
loss: optimize_map runs once more on the schedule's first iteration (a
pure function in both packages).

A record holds (RECORD_KEYS): the frame's NIQE score and the window's
(frame, score) list after it; need_new_keyframe's covisibility fraction
(against mapping.min_covisibility) and its decision; the frame that became
the keyframe (-1: none); the new keyframe's covisibility fractions against
the earlier ones (against mapping.kf_covisibility) and the graph edges
added; the mapping window (keyframe indices in rng order, then their
frames); the schedule; the candidate count and the rows appended; ba_mask's
count (-1 without BA); the mapping loss at the first and last iteration;
the window's poses after the optimization (the current frame's slot last);
the tracked pose, the frame's final pose and the map's rows after it."""
from __future__ import annotations

import sys

import numpy as np

DISCRETE = ("kf_decision", "keyframe", "window_frames", "schedule", "edges_added",
            "niqe_window_frames")
COUNTS = ("candidates", "appended", "ba_mask", "rows")
VALUES = ("niqe", "kf_covis", "loss_first", "loss_last")
VECTORS = ("kf_fracs", "niqe_window_scores", "window_poses", "tracked_pose", "final_pose")
RECORD_KEYS = ("frame", "window") + DISCRETE + COUNTS + VALUES + VECTORS
POSES = ("window_poses", "tracked_pose", "final_pose")


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.array(x)


def _rows(m) -> int:
    return int(m.n_alive) if hasattr(m, "n_alive") else int(m.n)


def step_recorded(slam, idx: int) -> dict:
    """Step frame `idx` of `slam` (either package) and return its record."""
    mp = slam.mapper
    mod = sys.modules[type(mp).__module__]
    rec = {"frame": idx, "kf_covis": np.nan, "kf_fracs": [], "candidates": -1,
           "ba_mask": -1, "loss_first": np.nan, "loss_last": np.nan}
    kf_before = len(mp.keyframes)
    graph_before = {k: set(v) for k, v in mp.covisibility_graph.items()}
    rows_before = _rows(slam.gaussians)
    rows_appended = [rows_before]
    window, wrapped = [], []

    def wrap_method(name, after):
        orig = getattr(mp, name)

        def fn(*a, **kw):
            out = orig(*a, **kw)
            after(out, *a)
            return out
        setattr(mp, name, fn)
        wrapped.append(name)

    def covis_last(*a, **kw):
        f = mod_orig["covis_check_last_kf"](*a, **kw)
        rec["kf_covis"] = float(_np(f))
        return f

    def covis_fracs(name):
        def fn(*a, **kw):
            f = mod_orig[name](*a, **kw)
            rec["kf_fracs"] = list(rec["kf_fracs"]) + [float(v) for v in np.ravel(_np(f))]
            return f
        return fn

    def candidates(*a, **kw):
        stats = mod_orig["new_gaussian_candidates"](*a, **kw)
        rec["candidates"] = int(_np(stats.candidates.mask).sum())
        return stats

    def optimize(*a, **kw):
        # the port: (state, colors, depths, ests, poses, schedule, extent,
        # settings) -> state; JAX: (carry, colors, depths, ests, schedule,
        # extent, settings) -> (carry, overflow)
        is_port = len(a) == 8
        si = 5 if is_port else 4
        one = list(a)
        one[si] = np.asarray(a[si])[:1]
        first = mod_orig["optimize_map"](*one, **kw)
        out = mod_orig["optimize_map"](*a, **kw)
        c0, c = (first, out) if is_port else (first[0], out[0])
        rec["loss_first"], rec["loss_last"] = float(_np(c0.last_loss)), float(_np(c.last_loss))
        if mp.opt_settings.do_BA and idx > 0:
            mask = _np(a[0].ba_mask)
            rec["ba_mask"] = int((mask if is_port else mask & _np(a[0].m.alive_mask())).sum())
        rec["window_poses"] = _np(c.kf_poses)[:len(window) + 1]
        return out

    # the keyframe fractions: the port's one per call, JAX's batch
    fracs = [n for n in ("covisibility_fraction", "covisibility_fractions_batch")
             if hasattr(mod, n)]
    wrappers = {"covis_check_last_kf": covis_last, "new_gaussian_candidates": candidates,
                "optimize_map": optimize, **{n: covis_fracs(n) for n in fracs}}
    mod_orig = {name: getattr(mod, name) for name in wrappers}
    wrap_method("need_new_keyframe", lambda out, *a: rec.__setitem__("kf_decision", bool(out)))
    wrap_method("get_covisible_set", lambda out, *a: window.extend(int(k) for k in out))
    wrap_method("_build_schedule",
                lambda out, *a: rec.__setitem__("schedule", [int(s) for s in out]))
    wrap_method("add_keyframe",
                lambda out, *a: rows_appended.append(int(_np(a[-1].alive).sum())))
    # est_pose, the frame's row of the pose list, still holds the tracked
    # pose when run_frame returns: _step writes the mapped pose after it
    wrap_method("run_frame",
                lambda out, *a: rec.__setitem__("tracked_pose", np.array(a[3], np.float32)))
    try:
        for name, fn in wrappers.items():
            setattr(mod, name, fn)
        slam._step(idx)
    finally:
        for name, fn in mod_orig.items():
            setattr(mod, name, fn)
        for name in wrapped:
            del mp.__dict__[name]

    window_nq = list(getattr(mp, "niqe_window", None) or [])
    rec["niqe"] = float(window_nq[-1].niqe) if window_nq else np.nan
    rec["niqe_window_frames"] = [int(f.idx) for f in window_nq]
    rec["niqe_window_scores"] = [float(f.niqe) for f in window_nq]
    rec["keyframe"] = int(mp.keyframes[-1].idx) if len(mp.keyframes) > kf_before else -1
    rec["edges_added"] = sorted(
        (int(a), int(b)) for a, nb in mp.covisibility_graph.items() for b in nb
        if a < b and b not in graph_before.get(a, set()))
    rec["window"] = window
    rec["window_frames"] = [int(mp.keyframes[k].idx) for k in window]
    rec["appended"] = rows_appended[-1] - rows_before
    rec["rows"] = _rows(slam.gaussians)
    rec["final_pose"] = np.array(slam.estimate_pose_list[idx], np.float32)
    return rec


def record_arrays(rec: dict, prefix: str = "record") -> dict:
    """A record as arrays under prefix.<key> (np.savez, no pickle)."""
    out = {}
    for k in RECORD_KEYS:
        v = rec[k]
        if k == "edges_added":
            v = np.asarray(v, np.int64).reshape(-1, 2)
        out[f"{prefix}.{k}"] = np.asarray(v)
    return out


def record_from_arrays(d, prefix: str = "record") -> dict:
    """Inverse of `record_arrays`."""
    rec = {}
    for k in RECORD_KEYS:
        v = np.asarray(d[f"{prefix}.{k}"])
        if k == "edges_added":
            rec[k] = [tuple(e) for e in v.tolist()]
        elif v.dtype.kind == "f":
            rec[k] = float(v) if v.ndim == 0 else v
        else:
            rec[k] = v.tolist()
    return rec


def asset_arrays(state: dict, rec: dict) -> dict:
    """A state and a record in one dict (np.savez, no pickle)."""
    return {**{f"state.{k}": v for k, v in state.items()}, **record_arrays(rec)}


def read_asset(path) -> tuple[dict, dict | None]:
    """(state, record) of a file of `asset_arrays`; (state, None) of a file
    of a bare state."""
    with np.load(path, allow_pickle=False) as f:
        d = {k: f[k] for k in f.files}
    if not any(k.startswith("state.") for k in d):
        return d, None
    return ({k[len("state."):]: v for k, v in d.items() if k.startswith("state.")},
            record_from_arrays(d))


def gap(a: dict, b: dict, k: str):
    """(same, gap) of quantity k between two records: exact equality, and
    for numbers the largest absolute difference (a relative one for the
    losses); gap None where the shapes differ or nothing is numeric."""
    va, vb = a[k], b[k]
    if k in DISCRETE:
        return va == vb, None
    if k in COUNTS:
        return va == vb, float(abs(va - vb))
    x, y = np.asarray(va, np.float64), np.asarray(vb, np.float64)
    if x.shape != y.shape:
        return False, None
    if x.size == 0:
        return True, 0.0
    both_nan = np.isnan(x) & np.isnan(y)
    d = np.where(both_nan, 0.0, np.abs(x - y))
    if k.startswith("loss"):
        d = d / np.maximum(np.abs(y), 1e-30)
    return bool(np.array_equal(x, y, equal_nan=True)), float(np.max(d))


def _fmt_value(rec: dict, k: str) -> str:
    v = rec[k]
    if k in POSES:
        return f"[{', '.join(f'{x:.6g}' for x in np.ravel(v)[:7])}{', ...' if np.size(v) > 7 else ''}]"
    if k == "kf_fracs" or k == "niqe_window_scores":
        return "[" + ", ".join(f"{x:.6g}" for x in v) + "]"
    if k == "schedule":
        return "".join(str(s) for s in v)
    if isinstance(v, float):
        return f"{v:.9g}"
    return str(v)


def _fmt_gap(same: bool, g) -> str:
    if same:
        return "same"
    return "differs" if g is None else f"{g:.3e}"


def table(recs: dict, columns, tag: str) -> tuple[list[str], dict]:
    """Lines of the lockstep table: one per quantity, the value in the
    first record of the first column, then each column's (label, a, b)
    comparison of records recs[a] and recs[b]: "same", "differs" (a
    discrete decision) or the largest gap. Also returns
    {(label, quantity): (same, gap)}."""
    ref = recs[columns[0][1]]
    gaps = {}
    head = f"[{tag}] {'quantity':<20s} {'value (' + columns[0][1] + ')':<44s} " + " ".join(
        f"{label:>22s}" for label, _, _ in columns)
    lines = [head]
    for k in RECORD_KEYS:
        if k in ("frame", "window"):
            continue
        cells = []
        for label, a, b in columns:
            s, g = gap(recs[a], recs[b], k)
            gaps[(label, k)] = (s, g)
            cells.append(_fmt_gap(s, g))
        val = _fmt_value(ref, k)
        lines.append(f"[{tag}] {k:<20s} {val[:44]:<44s} " + " ".join(f"{c:>22s}" for c in cells))
    return lines, gaps
