"""Host milliseconds per step inside ``next()`` of the program's batch
iterator (the harness's ``data`` span): the gather, the preprocessing's
launches and, at an epoch's end, the epoch's read."""

import statistics


def read(ctx):
    times = ctx.host.get("data")
    if ctx.kind != "train" or not times:
        return None
    return statistics.fmean(times) * 1e3
