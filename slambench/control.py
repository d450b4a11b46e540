"""The check's two readings for a cell, on the card at the cell's size: for
each seed, one run with a short window (on to the checked frame) gives the
program's numbers and the control's (the reference at bfloat16 in the
program's place), all in one process.

    python3 -m slambench.control --workload <name> --seeds 11 12 ... [--control-seeds 3]
        [--out F.json]

Prints a line per seed and run, then per number the largest program reading
(the lower) and the smallest control reading (the upper), which the limits
in limits/<cell>.json are set between. The numbers are the cell's
(check.numbers_for): ba_mask_gap and map_pose_step_gap where its
configuration sets mapping.do_BA. Standard error gives each seed's check
seconds ("check of frame ...").
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="read the control on the first this many seeds only (default all)")
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[],
                   help="seeds whose tracking is also run by the reference in float64")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("slambench.control needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    rows = []
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = harness.run_cell(spec, seed, args.seconds, False, "cuda", control=i < n_control,
                             witness=seed in args.witness_seeds, mem_frames=0)
        rows.append(dict(seed=seed, check_frame=r["check_frame"], **r["readings"],
                         seconds=time.perf_counter() - t0))
        print(json.dumps(rows[-1]), flush=True)
    names = check.numbers_for(spec["config"]["config"])
    lower = {k: max(r["program"][k] for r in rows) for k in names}
    upper = {k: min(r["control"][k] for r in rows if "control" in r) for k in names}
    summary = dict(workload=args.workload, seeds=args.seeds, lower=lower, upper=upper,
                   device=torch.cuda.get_device_name(0))
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
