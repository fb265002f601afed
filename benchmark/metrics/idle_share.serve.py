"""The device's idle share of the traced window: 1 − (the union of the
device events' intervals) ÷ the window's length."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace.window_s <= 0:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
