"""loop_track_s_per_frame (tracking loop layer: slam/tracker.py): the mean
increase of SLAM.tracking_time_sum per unprofiled frame of the window that
tracked, in s. It stands per layer in the cells where track_s_per_frame
spreads too widely between runs to hold a bound end to end."""


def read(ctx):
    rows = [f["track_s"] for f in ctx["frames"] if not f["profiled"] and f["track_s"] > 0]
    return sum(rows) / len(rows) if rows else None
