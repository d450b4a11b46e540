"""mfu.track (device, one tracking iteration): the profiled frame's
tracking launches' summed bound per tracking iteration over the wall time
per tracking iteration of the window's unprofiled frames, in %: the whole
step's share of the chip's peak."""


def read(ctx):
    bound = sum(x["bound_s"] for x in ctx["launches"] if x["phase"] == "track")
    prof = [f for f in ctx["frames"] if f["profiled"]]
    rows = [f["track_s"] / f["track_iters"] for f in ctx["frames"]
            if not f["profiled"] and f["track_s"] > 0]
    if not (bound and prof and rows):
        return None
    return 100.0 * (bound / prof[0]["track_iters"]) / (sum(rows) / len(rows))
