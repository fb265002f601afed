"""The model's FLOPs (counted on the plain reference's shapes: a
training step's forward and backward, or a serving forward) times the
calls run in the traced window, over the window's seconds times the
model's peak for the configuration's ``dtype`` (``counts.precision``:
float32, TF32 off, 67 TFLOP/s; bfloat16 and float16 the tensor cores'
dense 989.4)."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.units or ctx.trace.window_s <= 0:
        return None
    peak = ctx.model_peak_flop_per_s
    return ctx.flops_per_unit * ctx.units / (ctx.trace.window_s * peak) * 100.0
