"""map_rows (mapping loop layer: slam/mapper.py, map_ops.py): the map's
Gaussians (SLAM.n_gaussians) after the last frame that peak_mem_gib covers;
the map, its gradients and its Adam moments grow with it."""


def read(ctx):
    rows = ctx.get("map_rows")
    return float(rows) if rows else None
