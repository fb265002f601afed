"""Host milliseconds a training step inside the program's
``dlv3.step.optimizer`` span: the zero fill of missing gradients and
the Adam update launched."""

from benchmark.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "train", "dlv3.step.optimizer")
