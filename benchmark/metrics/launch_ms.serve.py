"""Host milliseconds a ``segment()`` call inside the program's
``dlv3.segment.forward`` span: the label step (the model's forward and
K1) launched, with no synchronise."""

from benchmark.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "serve", "dlv3.segment.forward")
