"""Device milliseconds a training step of the kernels and copies
launched inside the program's ``dlv3.data.batch`` spans: the batch's
gather from the device cache, its preprocessing and the copies of its
indices and validity."""

from benchmark.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "train", "dlv3.data.batch")
