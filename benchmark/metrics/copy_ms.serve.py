"""Device milliseconds of host→device and device→host copies per
``segment()`` call (the profiler's ``Memcpy`` events in the window)."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.units:
        return None
    s = ctx.trace.device_s("Memcpy")
    return s / ctx.units * 1e3 if s > 0 else None
