"""device_ops_per_iter.map (render glue under mapping): device activities
launched from the profiled frame's mapping call (the keyframe decision's
renders included), per mapping iteration."""


def read(ctx):
    iters = [f["map_iters"] for f in ctx["frames"] if f["profiled"]]
    n = ctx["phases"]["map"]["n_ops"]
    return n / iters[0] if iters and iters[0] and n else None
