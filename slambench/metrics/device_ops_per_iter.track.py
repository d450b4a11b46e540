"""device_ops_per_iter.track (render glue under tracking: ops/render.py,
projection.py, binning.py, losses.py): device activities (kernels, copies,
fills) launched from the profiled frame's tracking call, per tracking
iteration."""


def read(ctx):
    iters = [f["track_iters"] for f in ctx["frames"] if f["profiled"]]
    n = ctx["phases"]["track"]["n_ops"]
    return n / iters[0] if iters and iters[0] and n else None
