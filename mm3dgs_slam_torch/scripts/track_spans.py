"""Where a tracking iteration's time goes, by program span, on the card.

    python -m mm3dgs_slam_torch.scripts.track_spans SEED [--workload synthetic_tum.orbit]

Runs frames 0-4 of a benchmark cell's sequence (slambench's configuration,
traffic and synthetic scene for SEED) with the port's spans on, frame 2
under torch.profiler, and prints:

- device activities per tracking iteration by span, and the device's idle
  time by span, from the profiled frame (slambench.program_spans' joins);
- ms per tracking iteration by span (`track.iter`, `track.loss`,
  `track.backward`, `track.bins`, the iteration's own time, which is the Adam
  step, and the host span of `kernel.pose_rows`), over frames 3 and 4. Frame
  1 pays the first tracking call's one-time costs and frame 2 the profiler's.

Every line starts with `[track_spans]`. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from collections import defaultdict

SPANS = ("track.iter", "track.loss", "track.backward", "track.bins")


def _ms_per_iteration(records: list, ms: dict) -> None:
    """Adds each tracking span's duration (ms) in `records` to `ms`."""
    by_id = {r["id"]: r for r in records}
    dur = lambda r: (r["end_ns"] - r["start_ns"]) * 1e-6  # noqa: E731
    child = defaultdict(float)
    for r in records:
        if r["parent"] in by_id:
            child[r["parent"]] += dur(r)
    for r in records:
        if r["name"] in SPANS:
            ms[r["name"]].append(dur(r))
        if r["name"] == "track.iter":
            ms["track.step (iter self)"].append(dur(r) - child[r["id"]])
        if r["name"] == "kernel.pose_rows":
            ms["kernel.pose_rows (host)"].append(dur(r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seed", type=int)
    ap.add_argument("--workload", default="synthetic_tum.orbit")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import mm3dgs_slam_torch.data.synthetic as syn_mod
    from mm3dgs_slam_torch import spans
    from mm3dgs_slam_torch.slam.slam import SLAM
    from slambench import harness, program_spans, scene, trace

    spec = harness.cell_spec(args.workload)
    with tempfile.TemporaryDirectory() as out:
        cfg = harness.slam_config(spec["config"], spec["traffic"], args.seed, out)
        seq = scene.SyntheticSequence(spec["traffic"], harness.loader_cam(cfg), args.seed,
                                      torch.device("cuda"))
        syn_mod.render_frame = seq.renderer()
        slam = SLAM(cfg, "cuda", scene=seq.scene)
        slam._step(0)
        slam._sync()
        ms = defaultdict(list)
        for idx in (1, 2, 3, 4):
            spans.reset()
            spans.enable()
            tr0 = slam.tracking_time_sum
            if idx == 2:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    slam._step(idx)
                    slam._sync()
            else:
                slam._step(idx)
                slam._sync()
            spans.disable()
            records = spans.records()
            took = slam.tracking_time_sum - tr0
            if idx == 2:
                ev = trace.read_events(prof)
                ops = program_spans.device_ops_by_span(ev, records)
                idle = program_spans.idle_by_span(ev, records)
                top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
                print("[track_spans] activities per iteration by span:",
                      json.dumps({k: round(v, 2) for k, v in top}))
                print("[track_spans] idle by span, s:",
                      json.dumps({k: round(v, 3) for k, v in list(idle.items())[:12]}))
                print(f"[track_spans] frame 2 tracking {took:.3f} s (profiled)")
                continue
            print(f"[track_spans] frame {idx} tracking {took:.3f} s")
            if idx > 2:
                _ms_per_iteration(records, ms)
        slam._frames.close()
    n_iter = len(ms["track.iter"])
    print("[track_spans] ms per tracking iteration (frames 3, 4):",
          json.dumps({k: round(sum(v) / n_iter, 3) for k, v in ms.items()}),
          f"over {n_iter} iterations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
