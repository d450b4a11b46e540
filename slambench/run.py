"""Run one cell of the benchmark once, on the machine it is started on.

    python3 -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With --trace 0 the result line carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics (one frame
of the window under torch.profiler). The last line of standard output is
the result's JSON; the last lines of standard error give each number the
check compared beside its limit. Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits with 2; if the run
loaded JAX or the JAX package, with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the loop is paced by one host thread
# launching work on the card, and idle BLAS or OpenCV pools spinning beside
# it on a shared host make runs spread. Set before numpy is imported.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import harness  # noqa: E402


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's nvcc libraries already live in its build/)."""
    cache = harness.ROOT / "build" / "slambench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    spec = harness.cell_spec(args.workload)

    import cv2
    import torch

    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"slambench: {args.workload} needs {spec['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found. No result.", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_start=T_START, log=print)
    bad = harness.forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {', '.join(bad)}, which the benchmark of the port "
              "may not load. No result.", file=sys.stderr)
        return 3
    readings = result.pop("readings")
    print(f"[slambench] checked frame {result.pop('check_frame')}; readings "
          f"{json.dumps(readings)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
