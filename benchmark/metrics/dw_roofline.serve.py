"""The depthwise sites' share of their roofline: the least time of every
depthwise pass of the calls (forward) in the window, from the
plain reference's site shapes, over the device time the trace
attributes to those sites (kernels launched inside a site's forward, or by
the backward nodes it created), whatever kernel runs there."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.units:
        return None
    fwd, bwd = ctx.trace.site_device_s()
    spent = fwd + bwd
    if spent <= 0:
        return None
    return ctx.dw_least_s_per_unit * ctx.units / spent * 100.0
