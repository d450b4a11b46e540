"""mfu.map (device, one mapping iteration): the profiled frame's mapping
launches' summed bound per mapping iteration over the wall time per mapping
iteration of the window's unprofiled frames, in %."""


def read(ctx):
    bound = sum(x["bound_s"] for x in ctx["launches"] if x["phase"] == "map")
    prof = [f for f in ctx["frames"] if f["profiled"]]
    rows = [f["map_s"] / f["map_iters"] for f in ctx["frames"]
            if not f["profiled"] and f["map_s"] > 0]
    if not (bound and prof and rows):
        return None
    return 100.0 * (bound / prof[0]["map_iters"]) / (sum(rows) / len(rows))
