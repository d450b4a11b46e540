"""Offline IMU dead-reckoning, the non-ROS counterpart of the reference's
live preintegration node (UT_MM_Scripts/imu_preintegration.py); the port's
copy of the JAX package's scripts/imu_preintegrate.py.

    python -m mm3dgs_slam_torch.scripts.imu_preintegrate --imu path/to/imu.txt \
        --out imu_rel.csv [--world-out traj_world.csv] [--dt 0.01] \
        [--format auto|utmm|plain]

The node's conventions, quirks included (for data parity):
  * the linear acceleration is taken as [ax, 0, 0], the robot-x axis only
    (imu_preintegration.py:77: the Jackal drives forward),
  * a fixed integration step dt (0.010 s at the 100 Hz IMU topic,
    imu_preintegration.py:36) whatever the sample timestamps,
  * each sample's relative transform I_T_N: R = the sxyz Euler matrix of
    w dt, t = v dt + 0.5 a dt^2 (imu_preintegration.py:79-91),
  * the world pose composes on the right, W_T_N <- W_T_N @ I_T_N
    (imu_preintegration.py:95),
  * the CSV rows are the INVERSE relative transforms, with the header
    "Timestamp,T_11,...,T_44" (imu_preintegration.py:152-153).

Input: a UT-MM `imu.txt` (36-column microstrain odometry rows: columns 4-6
angular velocity, 7-9 linear acceleration; data/utmm.py), or a plain
CSV/whitespace file with the columns timestamp ax ay az wx wy wz. Float64
numpy throughout, as the JAX package's script.
"""
from __future__ import annotations

import argparse
import csv

import numpy as np


def euler_matrix_sxyz(ai, aj, ak) -> np.ndarray:
    """The homogeneous sxyz Euler matrix in float64 numpy (the formula of
    ops/pose.euler_sxyz_matrix, kept on the host for a per-sample scalar op)."""
    si, sj, sk = np.sin([ai, aj, ak])
    ci, cj, ck = np.cos([ai, aj, ak])
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    m = np.eye(4)
    m[0, 0] = cj * ck
    m[0, 1] = sj * sc - cs
    m[0, 2] = sj * cc + ss
    m[1, 0] = cj * sk
    m[1, 1] = sj * ss + cc
    m[1, 2] = sj * cs - sc
    m[2, 0] = -sj
    m[2, 1] = cj * si
    m[2, 2] = cj * ci
    return m


def load_samples(path: str, fmt: str):
    """(timestamps [N], linear acceleration [N, 3], angular velocity [N, 3])
    of an IMU file; `fmt` "auto" takes 36 or more columns as UT-MM's."""
    with open(path) as f:
        first = f.readline()
    delim = "," if "," in first else None
    raw = np.loadtxt(path, delimiter=delim, ndmin=2)
    if fmt == "auto":
        fmt = "utmm" if raw.shape[1] >= 36 else "plain"
    if fmt == "utmm":
        # [0] stamp, [4:7] angular velocity, [7:10] linear acceleration
        return raw[:, 0], raw[:, 7:10], raw[:, 4:7]
    return raw[:, 0], raw[:, 1:4], raw[:, 4:7]


def preintegrate(ts, accel, gyro, dt: float):
    """(rel_inv [N, 4, 4], world [N, 4, 4]) by the node's update equations."""
    n = len(ts)
    velocity = np.zeros(3)
    W_T_N = np.eye(4)
    rel_inv = np.zeros((n, 4, 4))
    world = np.zeros((n, 4, 4))
    for i in range(n):
        lin_accel = np.array([accel[i, 0], 0.0, 0.0])  # the x axis only (quirk)
        dpos = velocity * dt + 0.5 * lin_accel * dt * dt
        velocity = velocity + lin_accel * dt
        I_T_N = euler_matrix_sxyz(*(gyro[i] * dt))
        I_T_N[0:3, 3] = dpos
        W_T_N = W_T_N @ I_T_N
        rel_inv[i] = np.linalg.inv(I_T_N)
        world[i] = W_T_N
    return rel_inv, world


HEADER = ["Timestamp"] + [f"T_{i}{j}" for i in range(1, 5) for j in range(1, 5)]


def write_csv(path: str, ts, mats) -> None:
    """One row per sample: the stamp (9 decimals) and the 16 entries."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        for t, m in zip(ts, mats):
            w.writerow([f"{t:.9f}", *m.flatten()])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="offline IMU dead-reckoning")
    ap.add_argument("--imu", required=True,
                    help="imu.txt (UT-MM 36 columns) or 'ts ax ay az wx wy wz'")
    ap.add_argument("--format", choices=("auto", "utmm", "plain"), default="auto")
    ap.add_argument("--out", default="imu_rel.csv",
                    help="relative inv(I_T_N) CSV (the reference's schema)")
    ap.add_argument("--world-out", default=None,
                    help="optional world-frame W_T_N CSV (the same schema)")
    ap.add_argument("--dt", type=float, default=0.010,
                    help="fixed integration step (the reference: 100 Hz)")
    args = ap.parse_args(argv)
    ts, accel, gyro = load_samples(args.imu, args.format)
    rel_inv, world = preintegrate(ts, accel, gyro, args.dt)
    write_csv(args.out, ts, rel_inv)
    print(f"wrote {args.out}: {len(ts)} relative transforms")
    if args.world_out:
        write_csv(args.world_out, ts, world)
        print(f"wrote {args.world_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
