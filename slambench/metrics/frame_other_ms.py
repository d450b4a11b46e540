"""frame_other_ms (frame loop layer: slam/slam.py, slam/state.py, data/*,
ops/pose.py, eval/depth_est.py): per unprofiled frame of the window, its
wall time less its tracking and mapping time (SLAM.tracking_time_sum and
Mapper.mapping_time_sum), in ms: data, seed, depth fit, logging."""


def read(ctx):
    rows = [f["wall_s"] - f["track_s"] - f["map_s"] for f in ctx["frames"] if not f["profiled"]]
    return 1e3 * sum(rows) / len(rows) if rows else None
