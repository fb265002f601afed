"""Host milliseconds a ``segment()`` call inside the program's
``dlv3.segment.copy_out`` span: the wait for the device to finish the
call's work, then the labels' device→host copy."""

from benchmark.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "serve", "dlv3.segment.copy_out")
