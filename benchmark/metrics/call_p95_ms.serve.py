"""The 95th percentile of the ``segment()`` calls' host time in the traced
window (the harness's ``segment`` span, numpy in to labels on the host).
Not an end-to-end metric: on the one-card machine a call's host copies
swing with the host, and its tail with them (PERF.md §2)."""

import numpy as np


def read(ctx):
    times = ctx.host.get("segment")
    if ctx.kind != "serve" or not times:
        return None
    return float(np.percentile(np.array(times), 95)) * 1e3
