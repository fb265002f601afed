"""The model's FLOPs (counted on the plain reference's shapes: a
training step's forward and backward, or a serving forward) times the
calls run in the traced window, over the window's seconds times the
float32 peak (TF32 is off)."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.units or ctx.trace.window_s <= 0:
        return None
    peak = ctx.peaks["fp32_flop_per_s"]
    return ctx.flops_per_unit * ctx.units / (ctx.trace.window_s * peak) * 100.0
