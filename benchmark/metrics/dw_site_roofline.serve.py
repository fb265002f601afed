"""The depthwise passes' share of their roofline, as
``dw_roofline.serve`` computes it, over the device time of the program's
own ``dlv3.dw_site`` spans (opened at the kernel layer's entry, whatever
route runs the pass)."""

from benchmark.spans import dw_site_roofline


def read(ctx):
    return dw_site_roofline(ctx, "serve")
