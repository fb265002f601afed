"""Device milliseconds a ``segment()`` call of every BN module in
eval mode (kernels launched inside the program's ``dlv3.bn`` spans)."""

from benchmark.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "serve", "dlv3.bn")
