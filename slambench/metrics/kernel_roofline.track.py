"""kernel_roofline.track (kernels: ops/kernels.py -> csrc/*.cu): the
tracking launches' summed bound (bounds.launch_bound, from the work their
inputs need) over their summed device time in the profiled frame, in %."""


def read(ctx):
    ls = [x for x in ctx["launches"] if x["phase"] == "track"]
    dev = sum(x["device_s"] for x in ls)
    return 100.0 * sum(x["bound_s"] for x in ls) / dev if ls and dev > 0 else None
