"""map_s_per_frame (mapping loop layer: slam/mapper.py, map_opt.py,
map_ops.py, eval/quality.py): the mean increase of Mapper.mapping_time_sum
per unprofiled frame of the window, in s; it includes the keyframe
decision and NIQE."""


def read(ctx):
    rows = [f["map_s"] for f in ctx["frames"] if not f["profiled"]]
    return sum(rows) / len(rows) if rows else None
