"""Images labelled over the traced window ÷ its seconds: the serving rate
where it is not an end-to-end metric.  The flagship's ``segment()`` is
paced by the host (pageable copies and launches), whose speed swings from
run to run on the one-card machines by more than half of the largest
bound the contract allows, so there it is read per layer (PERF.md §2).
The profiler's cost per operation slows the traced host, so it reads
below the untraced rate."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.units or not getattr(ctx, "window_s", None):
        return None
    return ctx.batch * ctx.units / ctx.window_s
