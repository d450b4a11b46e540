"""The lockstep: the JAX package's whole SLAM state carried into the port
between two frames (mm3dgs_slam_torch/slam/state.py, tests/jax_state.py),
then one frame stepped by both from the same state, every decision of it
recorded (tests/lockstep.py) and compared, on configs/synthetic.yml with
bundle adjustment on its JAX scene (the JAX caps raised as in
test_torch_synthetic.py).

  * test_jax_state_restores_in_jax / test_port_steps_jax_state_like_jax
    (tier 1, one JAX run for both): the config cut to 4 frames at 2
    tracking / 4 mapping iterations (CUT); JAX steps frames 0-1;
    its state restored into a fresh JAX SLAM steps frame 2 as JAX did, and
    restored into the port steps frame 2 with every decision equal and the
    poses within POSE_ATOL.
  * test_lockstep_frame5 (slow): the whole config (40 / 60 iterations).
    JAX steps frames 0-4; its state goes into the port; both step frame 5,
    and so do JAX and the port from the same state with fx and fy one
    float32 ulp up (the yardsticks). The table is printed; then JAX and the
    port go on to frame 7 and the ATE of each is printed. Also holds the
    committed asset mm3dgs_slam_torch/assets/jax_state_synthetic_ba_f4.npz
    (JAX's state after frame 4 and its frame-5 record) bit for bit.
  * test_lockstep_frame5_from_the_port (slow): the reverse direction, the
    port's own run to frame 4 carried into JAX.
The port's own carry is held in test_torch_state_carry.py, and
tpu.max_new_per_frame in test_torch_max_new.py (tier 1, split from this
file so that the test workers share them). Run the slow ones alone, in the background, with -s (the tables are
printed; about an hour on 8 CPU cores):
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lockstep.py -m slow -s

Run as a script, this file writes the asset again, writes one package's
state after frame 4 of the whole config with an input moved by one float32
ulp (none: unmoved), and prints how far such states lie from a first one
(the asset's state, or another written state): map rows, keyframes, the
keyframes' and the store's poses (the largest gap of the 7 numbers, the
quaternions' norms, which BA's pose Adam moves freely since a pose's
rotation is its normalized quaternion, and the keyframes' camera
centres), the covisibility graph, the NIQE window, and the camera centres
of frames 0-4:
    JAX_PLATFORMS=cpu python tests/test_torch_lockstep.py write OUT.npz
    JAX_PLATFORMS=cpu python tests/test_torch_lockstep.py state {jax,port} {none,fx+,fx-,cx+} OUT.npz
    JAX_PLATFORMS=cpu python tests/test_torch_lockstep.py compare REF.npz A.npz [B.npz ...]
"""
import copy
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

if __name__ == "__main__":   # run as a script: the repository and tests/ on the path
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parent)]
    import conftest  # noqa: F401  (the CPU and matmul precision of the JAX tests)

from jax_state import jax_export_state, jax_restore_state
from lockstep import COUNTS, DISCRETE, POSES, asset_arrays, read_asset, record_arrays, \
    step_recorded, table
from test_torch_synthetic import POSE_ATOL, ULP_MOVES, synthetic_cfgs

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "mm3dgs_slam_torch" / "assets" / "jax_state_synthetic_ba_f4.npz"
CUT = dict(early_stop_idx=4, tracking=2, mapping=4)
# in the cut frame 2 sees 0.955 of keyframe 0; at this threshold it makes a
# keyframe (frame 1, the NIQE window's lowest score), and frame 3 makes frame
# 1 a keyframe again, so that the carry's frames add keyframes as frame 5
# does in the whole config (the NIQE window, new Gaussians, the covisibility
# graph and BA's appended rows all run)
CUT_MIN_COVISIBILITY = 0.99
CARRY_AFTER = 1        # the tier-1 cut carries the state after frame 1
WHOLE_AFTER = 4        # the whole config's lockstep carries it after frame 4


def port_slam(cfg):
    from mm3dgs_slam_torch.data.synthetic import jax_scene_path, load_scene
    from mm3dgs_slam_torch.slam.slam import SLAM

    return SLAM(cfg, device="cpu", scene=load_scene(jax_scene_path("synthetic")))


def jax_slam(cfg):
    from mm3dgs_slam_tpu.slam.slam import SLAM as JSLAM

    return JSLAM(cfg)


def fresh(cfg, tag: str):
    """A copy of cfg with its own output directory."""
    cfg = copy.deepcopy(cfg)
    cfg["outputdir"] += "_" + tag
    return cfg


def moved(cfg, move: str = "fx+"):
    """A fresh copy of cfg with the camera keys of ULP_MOVES[move] one
    float32 ulp away."""
    cfg = fresh(cfg, move)
    keys, to = ULP_MOVES[move]
    for k in keys:
        cfg["cam"][k] = float(np.nextafter(np.float32(cfg["cam"][k]), np.float32(to)))
    return cfg


def steps(slam, frames) -> list:
    return [step_recorded(slam, i) for i in frames]


def finish(slam, n: int):
    """Save the map and results as `run()` does after n frames."""
    slam._frames.close()
    slam.save_map(n)
    slam.save_results(n)


def cut_cfgs(root: Path):
    jcfg, tcfg = synthetic_cfgs(root, True, **CUT)
    for c in (jcfg, tcfg):
        c["mapping"]["min_covisibility"] = CUT_MIN_COVISIBILITY
    return jcfg, tcfg


def through_npz(state: dict) -> dict:
    """The state saved with np.savez and loaded without pickle."""
    buf = io.BytesIO()
    np.savez(buf, **state)
    buf.seek(0)
    with np.load(buf, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def assert_states_equal(a: dict, b: dict, keys=None):
    keys = sorted(set(a) & set(b)) if keys is None else keys
    for k in keys:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


# ------------------------------------------ tier 1: JAX's state in the port
@pytest.fixture(scope="module")
def jax_frame2(tmp_path_factory):
    """JAX on the tier-1 cut: frames 0-1, its state, then frame 2 recorded;
    and the same state restored into a fresh JAX SLAM, frame 2 recorded."""
    jcfg, tcfg = cut_cfgs(tmp_path_factory.mktemp("lockstep"))
    jslam = jax_slam(jcfg)
    steps(jslam, range(CARRY_AFTER + 1))
    state = jax_export_state(jslam)
    rec = step_recorded(jslam, CARRY_AFTER + 1)
    again = jax_slam(fresh(jcfg, "restored"))
    jax_restore_state(again, through_npz(state))
    rec_again = step_recorded(again, CARRY_AFTER + 1)
    for s in (jslam, again):
        s._frames.close()
    assert len(jslam.binning_overflow_frames) == 0
    return dict(state=state, rec=rec, rec_again=rec_again, jslam=jslam, tcfg=tcfg)


def _assert_records_match(got: dict, want: dict, pose_atol: float):
    for k in DISCRETE + COUNTS:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in POSES:
        np.testing.assert_allclose(got[k], want[k], atol=pose_atol, rtol=0, err_msg=k)
    # the port's frames are its own oracle's renders of the JAX scene: NIQE
    # reads them to ~1e-7 of JAX's
    np.testing.assert_allclose(got["niqe"], want["niqe"], rtol=1e-6)
    np.testing.assert_allclose(got["niqe_window_scores"], want["niqe_window_scores"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["kf_covis"], want["kf_covis"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["kf_fracs"], want["kf_fracs"], atol=1e-6, rtol=0)
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_jax_state_restores_in_jax(jax_frame2):
    """The JAX helpers' carry: frame 2 from the restored state is JAX's own
    frame 2, every decision the same and every number the same bits."""
    rec, again = jax_frame2["rec"], jax_frame2["rec_again"]
    assert rec["kf_decision"] and rec["ba_mask"] > 0 and len(rec["window"]) >= 1
    _assert_records_match(again, rec, pose_atol=0.0)
    for k in ("loss_first", "loss_last", "niqe", "kf_covis"):
        assert again[k] == rec[k], k


def test_port_steps_jax_state_like_jax(jax_frame2, tmp_path):
    """JAX's state after frame 1 restored into the port, which steps frame
    2: every decision JAX's, the poses within POSE_ATOL, the map rows within
    the Adam bound of tests/test_torch_slam.py (two Adam steps of each
    group's learning rate per mapping iteration)."""
    from mm3dgs_slam_torch.models import gaussians as G
    from mm3dgs_slam_torch.slam.state import export_state, restore_state

    state, want, jslam = jax_frame2["state"], jax_frame2["rec"], jax_frame2["jslam"]
    tslam = port_slam(fresh(jax_frame2["tcfg"], "from_jax"))
    restore_state(tslam, through_npz(state))
    assert_states_equal(export_state(tslam), state)
    got = step_recorded(tslam, CARRY_AFTER + 1)
    tslam._frames.close()
    _assert_records_match(got, want, POSE_ATOL)
    jstate = jax_export_state(jslam)
    tstate = export_state(tslam)
    hyper = G.MapOptHyper.from_cfg(tslam.cfg["mapping"])
    iters = tslam.cfg["mapping"]["iters"]
    for f in G.PARAM_FIELDS:
        a, b = tstate[f"gaussians.{f}"], jstate[f"gaussians.{f}"]
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 2 * iters * getattr(hyper, "lr_" + f) + 1e-6, f
    for k in ("estimate_pose_list", "mapper.kf_store.poses", "mapper.keyframes.pose"):
        np.testing.assert_allclose(tstate[k], jstate[k], atol=POSE_ATOL, rtol=0, err_msg=k)
    for k in ("mapper.keyframes.idx", "mapper.covisibility_graph", "mapper.rng",
              "mapper.niqe_window.keyframe", "mapper.keyframes.pose_is_row"):
        assert np.array_equal(tstate[k], jstate[k]), k


# ------------------------------------------------- slow: frame 5, whole config
COLUMNS = (("port - JAX", "port", "jax"), ("JAX - JAX 1ulp", "jax", "jax_ulp"),
           ("port - port 1ulp", "port", "port_ulp"))


def jax_to_frame4(root: Path):
    """JAX on the whole config with BA: frames 0-4, its state after them,
    then frame 5 recorded. (JAX SLAM, state, frame-5 record)."""
    jcfg, _ = synthetic_cfgs(root, True)
    jslam = jax_slam(jcfg)
    steps(jslam, range(WHOLE_AFTER + 1))
    state = jax_export_state(jslam)
    rec = step_recorded(jslam, WHOLE_AFTER + 1)
    assert len(jslam.binning_overflow_frames) == 0
    return jslam, state, rec


def print_table(recs: dict, tag: str):
    lines, gaps = table(recs, COLUMNS, tag)
    print("\n" + "\n".join(lines), flush=True)
    return gaps


def to_the_end(slam, label: str):
    """Step frames 6.. and save; print the run's ATE and its drift from GT
    per frame (camera centres before alignment)."""
    from mm3dgs_slam_torch.eval.ate import camera_centers

    n = slam.n_img
    steps(slam, range(WHOLE_AFTER + 2, n))
    finish(slam, n)
    ate = float(np.load(os.path.join(slam.output, "results.npz"), allow_pickle=True)["ate_rmse"])
    est = camera_centers(np.asarray(slam.estimate_pose_list[:n]))[:, 4:]
    gt = camera_centers(np.asarray(slam.gt_pose_list[:n]))[:, 4:]
    drift = [float(f"{v:.4g}") for v in np.linalg.norm(est - gt, axis=1)]
    print(f"{label} to frame {n - 1}: ATE {ate!r} m, drift from GT per frame {drift} m",
          flush=True)


@pytest.fixture(scope="module")
def jax_frame5(tmp_path_factory):
    root = tmp_path_factory.mktemp("whole")
    jslam, state, rec = jax_to_frame4(root)
    return dict(root=root, jslam=jslam, state=state, rec=rec)


@pytest.mark.slow
def test_lockstep_frame5(jax_frame5):
    from mm3dgs_slam_torch.slam.state import restore_state

    torch.set_num_threads(4)
    jslam, state, root = jax_frame5["jslam"], jax_frame5["state"], jax_frame5["root"]
    jcfg, tcfg = synthetic_cfgs(root, True)
    recs = {"jax": jax_frame5["rec"]}
    runs = {}
    for tag, cfg in (("port", tcfg), ("port_ulp", moved(tcfg))):
        s = port_slam(fresh(cfg, tag))
        restore_state(s, state)
        recs[tag] = step_recorded(s, WHOLE_AFTER + 1)
        runs[tag] = s
    ju = jax_slam(moved(jcfg))
    jax_restore_state(ju, state)
    recs["jax_ulp"] = step_recorded(ju, WHOLE_AFTER + 1)
    ju._frames.close()
    runs["port_ulp"]._frames.close()
    gaps = print_table(recs, "lockstep f5, JAX's state")
    pose_gap = max(gaps[("port - JAX", k)][1] for k in POSES)
    ulp_gap = max(max(gaps[(c, k)][1] for k in POSES) for c, _, _ in COLUMNS[1:])
    print(f"[lockstep f5] largest pose gap: port - JAX {pose_gap:.3e}, one-ulp "
          f"yardsticks {ulp_gap:.3e}", flush=True)
    for tag, s in (("jax", jslam), ("port", runs["port"])):
        to_the_end(s, f"[lockstep f5] {tag} from JAX's frame-4 state")
    # what the lockstep showed (PERF.md, PR 12)
    for k in DISCRETE:
        assert gaps[("port - JAX", k)][0], k
    assert pose_gap <= 3 * ulp_gap


@pytest.mark.slow
def test_jax_state_asset_matches_jax(jax_frame5):
    """The committed asset holds JAX's state after frame 4 and its frame-5
    record bit for bit."""
    want_state, want_rec = read_asset(ASSET)
    state = jax_frame5["state"]
    assert set(want_state) == set(state)
    assert_states_equal(want_state, state, sorted(state))
    assert_states_equal(record_arrays(want_rec), record_arrays(jax_frame5["rec"]))


@pytest.mark.slow
def test_lockstep_frame5_from_the_port(tmp_path):
    """The port's own run to frame 4 carried into JAX; frame 5 by both and
    by both one-ulp yardsticks from the port's state; then the port's run
    and JAX from the port's state on to frame 7, each ATE printed."""
    from mm3dgs_slam_torch.slam.state import export_state, restore_state

    torch.set_num_threads(4)
    jcfg, tcfg = synthetic_cfgs(tmp_path, True)
    tslam = port_slam(tcfg)
    steps(tslam, range(WHOLE_AFTER + 1))
    state = export_state(tslam)
    recs = {"port": step_recorded(tslam, WHOLE_AFTER + 1)}
    tslam._frames.close()
    js = jax_slam(jcfg)
    jax_restore_state(js, state)
    recs["jax"] = step_recorded(js, WHOLE_AFTER + 1)
    ju = jax_slam(moved(jcfg))
    jax_restore_state(ju, state)
    recs["jax_ulp"] = step_recorded(ju, WHOLE_AFTER + 1)
    tu = port_slam(moved(tcfg))
    restore_state(tu, state)
    recs["port_ulp"] = step_recorded(tu, WHOLE_AFTER + 1)
    for s in (ju, tu):
        s._frames.close()
    gaps = print_table(recs, "lockstep f5, the port's state")
    print(f"\n[lockstep f5, the port's state] the port's state after frame 4 against JAX's "
          f"(the asset): {state_gaps(read_asset(ASSET)[0], state)}", flush=True)
    for tag, s in (("port", tslam), ("jax", js)):
        to_the_end(s, f"[lockstep f5, the port's state] {tag} from the port's frame-4 state")
    for k in DISCRETE:
        assert gaps[("port - JAX", k)][0], k


def state_after_frame4(pkg: str, move: str, root: Path) -> dict:
    """One package's exported state after frame 4 of the whole config with
    BA, the camera keys of ULP_MOVES[move] one ulp away (none: unmoved)."""
    from mm3dgs_slam_torch.slam.state import export_state

    jcfg, tcfg = synthetic_cfgs(root, True)
    cfg = jcfg if pkg == "jax" else tcfg
    if move != "none":
        cfg = moved(cfg, move)
    slam = jax_slam(cfg) if pkg == "jax" else port_slam(cfg)
    for i in range(WHOLE_AFTER + 1):
        slam._step(i)
    slam._frames.close()
    return jax_export_state(slam) if pkg == "jax" else export_state(slam)


def state_gaps(ref: dict, other: dict) -> str:
    """How far `other` lies from `ref`: one line."""
    from mm3dgs_slam_torch.eval.ate import camera_centers

    n = WHOLE_AFTER + 1
    centres = lambda s: camera_centers(s["estimate_pose_list"][:n])[:, 4:]  # noqa: E731
    gap = lambda k: (f"{np.abs(other[k] - ref[k]).max():.3e}"  # noqa: E731
                     if other[k].shape == ref[k].shape else "shapes differ")
    norms = lambda s: [float(f"{v:.5g}") for v in  # noqa: E731
                       np.linalg.norm(s["mapper.keyframes.pose"][:, :4], axis=1)]

    def kf_centres():
        a, b = other["mapper.keyframes.pose"], ref["mapper.keyframes.pose"]
        if a.shape != b.shape:
            return "shapes differ"
        d = np.linalg.norm(camera_centers(a)[:, 4:] - camera_centers(b)[:, 4:], axis=1)
        return [float(f"{v:.3g}") for v in d]
    return (f"map rows {other['gaussians.xyz'].shape[0]} (ref {ref['gaussians.xyz'].shape[0]}), "
            f"keyframes {other['mapper.keyframes.idx'].tolist()} (ref "
            f"{ref['mapper.keyframes.idx'].tolist()}), keyframe poses {gap('mapper.keyframes.pose')}"
            f" (their |q| {norms(other)}, ref {norms(ref)}; their camera centres "
            f"{kf_centres()} m apart), store poses {gap('mapper.kf_store.poses')}, graph "
            f"{'same' if np.array_equal(other['mapper.covisibility_graph'], ref['mapper.covisibility_graph']) else 'differs'}"
            f", NIQE window {other['mapper.niqe_window.other.idx'].tolist()} (ref "
            f"{ref['mapper.niqe_window.other.idx'].tolist()}), camera centres of frames 0-4 "
            f"{[float(f'{v:.3g}') for v in np.linalg.norm(centres(other) - centres(ref), axis=1)]} m")


if __name__ == "__main__":
    import tempfile

    torch.set_num_threads(2)
    usage = ("usage: test_torch_lockstep.py write OUT.npz | state {jax,port} "
             "{none,fx+,fx-,cx+} OUT.npz | compare REF.npz A.npz [B.npz ...]")
    cmd, args = (sys.argv[1], sys.argv[2:]) if len(sys.argv) > 2 else (None, [])
    if cmd == "write" and len(args) == 1:
        with tempfile.TemporaryDirectory() as tmp:
            _, state, rec = jax_to_frame4(Path(tmp))
        np.savez_compressed(args[0], **asset_arrays(state, rec))
        print(f"wrote {args[0]}: JAX's state after frame {WHOLE_AFTER} "
              f"({state['gaussians.xyz'].shape[0]} Gaussians, keyframes "
              f"{state['mapper.keyframes.idx'].tolist()}) and its frame-{WHOLE_AFTER + 1} "
              "record")
    elif cmd == "state" and len(args) == 3 and args[0] in ("jax", "port"):
        with tempfile.TemporaryDirectory() as tmp:
            state = state_after_frame4(args[0], args[1], Path(tmp))
        np.savez_compressed(args[2], **state)
        print(f"wrote {args[2]}: {args[0]}'s state after frame {WHOLE_AFTER}, move {args[1]}")
    elif cmd == "compare" and len(args) >= 2:
        ref = read_asset(args[0])[0]
        for path in args[1:]:
            print(f"[state after frame {WHOLE_AFTER}] {path} against {args[0]}: "
                  f"{state_gaps(ref, read_asset(path)[0])}")
    else:
        sys.exit(usage)
