"""device_idle (device, one H100): 1 less the profiled frame's device-busy
time in its tracking and mapping calls (the union of their activities'
intervals) over the tracking plus mapping time per unprofiled frame of the
window, in %. The denominator comes from unprofiled frames, so the
profiler's own host time does not read as idle."""


def read(ctx):
    rows = [f["track_s"] + f["map_s"] for f in ctx["frames"] if not f["profiled"]]
    busy = ctx["loops_busy_s"]
    if not rows or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (sum(rows) / len(rows)))
