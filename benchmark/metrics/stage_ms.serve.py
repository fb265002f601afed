"""Host milliseconds a ``segment()`` call inside the program's
``dlv3.segment.copy_in`` span: the host images made a device tensor (the
pageable host→device copy, staged by the host)."""

from benchmark.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "serve", "dlv3.segment.copy_in")
