"""kernel_roofline.map (kernels): the mapping launches' (kernel 1 at nc 3,
4 or 6, kernel 2's rows pass and its slot reduce) summed bound over their
summed device time in the profiled frame, in %."""


def read(ctx):
    ls = [x for x in ctx["launches"] if x["phase"] == "map"]
    dev = sum(x["device_s"] for x in ls)
    return 100.0 * sum(x["bound_s"] for x in ls) / dev if ls and dev > 0 else None
