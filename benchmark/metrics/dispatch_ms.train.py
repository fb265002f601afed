"""Host milliseconds per step inside ``train_step`` (the harness's
``step`` span), which returns without waiting for the device: where it
nears the device's time a step, the host sets the pace."""

import statistics


def read(ctx):
    times = ctx.host.get("step")
    if ctx.kind != "train" or not times:
        return None
    return statistics.fmean(times) * 1e3
