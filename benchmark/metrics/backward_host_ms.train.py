"""Host milliseconds a training step inside the program's
``dlv3.step.backward`` spans: the calling thread waiting in
``.backward()`` while the autograd engine launches the backward."""

from benchmark.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "train", "dlv3.step.backward")
