"""Device milliseconds a training step of every BN module (the
program's ``dlv3.bn`` spans), forward and backward: kernels launched
inside the spans and by the backward nodes that their forward operations
created."""

from benchmark.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "train", "dlv3.bn")
