"""loop_frames_per_s (frame loop layer: slam/slam.py and all below it): the
window's unprofiled frames over their wall time, in frames/s. It stands
per layer in the cells where frames_per_s spreads too widely between runs
to hold a bound end to end."""


def read(ctx):
    rows = [f["wall_s"] for f in ctx["frames"] if not f["profiled"]]
    return len(rows) / sum(rows) if rows else None
