"""Device idle milliseconds a ``segment()`` call in the gaps that
begin while the thread running the window is inside one of the
program's ``dlv3.`` spans (the device waiting on the program's host
work)."""

from benchmark.spans import program_idle_ms


def read(ctx):
    return program_idle_ms(ctx, "serve")
