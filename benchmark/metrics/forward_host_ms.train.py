"""Host milliseconds a training step inside the program's
``dlv3.step.forward`` spans: the model's forward launched (every
microbatch's)."""

from benchmark.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "train", "dlv3.step.forward")
