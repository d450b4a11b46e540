"""The least time a compositing launch could take on one H100: the larger
of its bytes over the memory bandwidth and its float32 operations over the
float32 peak outside the tensor cores.

A frozen copy, as of commit e88f4e05ce172d38c9780fabda9487fc7eec7bc7, of
chip_smoke.py's arithmetic (H100_BYTES_PER_S, H100_F32_OPS_PER_S, the OPS_*
counts and each kernel's bytes, chip_smoke.py:171-242, 419-541). The counts
are of the work a launch's inputs need (reference.walk_counts on its rows
and bins), not of the launch's own `work` counter, so another kernel that
computes the same thing is read against the same work.
"""
from __future__ import annotations

H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA data sheet (SXM)
H100_F32_OPS_PER_S = 67e12      # float32 outside the tensor cores

# Each pixel-pair a pixel uses or stops on forms dx, dy and the conic
# quadratic; a used one adds exp, the opacity product and the clamp, T and
# w, then per function:
OPS_TEST = 11


def ops_fwd_use(nc: int) -> int:      # acc += w f over nc channels
    return 6 + 2 * nc


def ops_bwd_use(nc: int) -> int:      # the mapping backward's per pixel-pair work
    return 34 + 4 * nc


def ops_pose_use(nc: int) -> int:     # the pose backward's per pixel-pair work
    return 35 + 2 * nc + (2 if nc == 6 else 0)


def ops_pose_pair(nc: int) -> int:    # once per (tile, pair): the 12 sums
    return 53 + (2 if nc == 6 else 0)


def ops_pix_bwd(nc: int) -> int:      # per pixel before a backward walk
    return 2 * nc + 1


def bound_s(n_bytes: float, n_ops: float):
    """(seconds, "bytes" or "operations"): the binding one."""
    tb, to = n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def launch_bound(kind: str, nc: int, w: dict, n_rows: int = 0):
    """The bound of one launch. `kind` is the launch's wrapper (composite_fwd,
    composite_bwd_rows, slot_reduce, composite_pose_bwd); `w` is
    reference.walk_counts of its rows and bins; `n_rows` the rows of dpacked
    (slot_reduce)."""
    used, evaluated = w["used"], w["used"] + w["stops"]
    n_seen, n_pairs, n_tiles = w["n_seen"], w["n_pairs"], w["n_tiles"]
    n_pix = n_tiles * 256
    if kind == "composite_fwd":
        return bound_s(4 * (n_seen * (6 + nc) + n_pairs + 2 * n_tiles + n_pix * (nc + 1)),
                       evaluated * OPS_TEST + used * ops_fwd_use(nc))
    if kind == "composite_bwd_rows":
        nf = 6 + nc
        return bound_s(4 * (n_seen * nf + n_pairs + 2 * n_tiles + n_pix * (2 * nc + 2)
                            + n_pairs * nf),
                       n_pix * ops_pix_bwd(nc) + evaluated * OPS_TEST + used * ops_bwd_use(nc))
    if kind == "slot_reduce":
        nf = 6 + nc
        return bound_s(4 * (n_pairs * nf + n_rows + 1 + n_pairs + 16 * n_rows),
                       w["pairs_used"] * nf)
    if kind == "composite_pose_bwd":
        return bound_s(4 * (n_seen * (6 + nc + 12) + n_pairs + 2 * n_tiles
                            + n_pix * (2 * nc + 2) + n_tiles * 12),
                       n_pix * ops_pix_bwd(nc) + evaluated * OPS_TEST + used * ops_pose_use(nc)
                       + w["pairs_used"] * ops_pose_pair(nc))
    raise ValueError(f"no bound for launch kind {kind!r}")
