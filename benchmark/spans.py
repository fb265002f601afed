"""The program's own spans in a traced run.

The program opens profiler ranges whose names start with ``dlv3.``
(``deeplabv3plus_keras_tpu_torch/utils/profiling.py`` ``span``: the
entry point, the train step and its phases, the device data path, each
BN module, each depthwise pass).  They are CPU operations of the same
trace as the device's events, so they share the device's clock.  From a
:class:`benchmark.trace.Trace` this module reads, for a span name:

- host seconds: the summed length of the span's ranges in the window;
- device seconds, (forward, backward): device events launched inside the
  span's ranges (the forward), and those launched by the backward nodes
  that the forward operations inside them created, matched by the
  autograd sequence number the profiler gives a forward operation and its
  backward node (as ``Trace.site_device_s`` reads ``bench.dw_site``).  An
  operation that creates no node records the number the next node will
  take, so a number belongs to the range that holds the last operation
  to record it, the node's creator: the backward of the first operation
  after a range is not the range's;

and, for the whole window, the device's idle gaps by the innermost
``dlv3.`` span of the window's thread at each gap's start.

A trace of a program without these spans gives None throughout.  The
index of a run's trace is built once, kept on the readers' shared
context, and read by every reader.
"""

from __future__ import annotations

import bisect

from benchmark.trace import SPAN_PREFIX, _Cover

PREFIX = "dlv3."
OUTSIDE = "outside"  # a gap that starts in no program span

def _is_span(name: str) -> bool:
    return name.startswith(PREFIX) or name.startswith(SPAN_PREFIX)


def _innermost(spans) -> list:
    """Properly nested (start, end, name) ranges of one thread as disjoint
    (start, end, name) pieces, each named by the innermost range there."""
    out, stack, at = [], [], None
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            at = _close(stack, at, out)
        if stack and a > at:
            out.append((at, a, stack[-1][2]))
        stack.append((a, b, name))
        at = a
    while stack:
        at = _close(stack, at, out)
    return out


def _close(stack: list, at: int, out: list) -> int:
    """Close the innermost open range: its piece from ``at`` to its end."""
    _, end, name = stack.pop()
    if end > at:
        out.append((at, end, name))
    return max(at, end)


class Index:
    """What the readers share, built once from a trace."""

    def __init__(self, tr):
        self.tr = tr
        self.spans: dict[str, list] = {}
        for e in tr.cpu:
            if e.name.startswith(PREFIX) and tr.t0 <= e.start < tr.t1:
                self.spans.setdefault(e.name, []).append(e)
        # per (thread, sequence number), the forward operation that created
        # the autograd node: the last to record the number (an operation
        # that creates no node records the number the next node will take)
        self.creators = {}
        for e in sorted((e for e in tr.cpu if e.seq >= 0 and e.fwd_thread == 0
                         and not _is_span(e.name)), key=lambda e: e.start):
            self.creators[(e.thread, e.seq)] = e
        # backward nodes, on the autograd engine's thread, with the forward's
        self.bwd_ops = [e for e in tr.cpu if e.seq >= 0 and e.fwd_thread != 0]
        by_corr = {e.corr: e for e in tr.cpu if e.corr}
        # each device event with the host event that launched it
        self.launched = [(k, by_corr[k.linked]) for k in tr.device if k.linked in by_corr]
        self._gaps = None

    def host_s(self, name: str) -> float | None:
        """Summed seconds of the ranges ``name`` in the window, or None."""
        sp = self.spans.get(name)
        if not sp:
            return None
        return sum(e.end - e.start for e in sp) / 1e9

    def device_s(self, name: str) -> tuple[float, float] | None:
        """(forward, backward) device seconds of the ranges ``name``, or
        None where the trace has no such range or no device event."""
        sp = self.spans.get(name)
        if not sp or not self.launched:
            return None
        cover = _Cover((e.thread, e.start, e.end) for e in sp)
        keys = {k for k, e in self.creators.items() if cover.has(e.thread, e.start)}
        bwd = _Cover((e.thread, e.start, e.end) for e in self.bwd_ops
                     if (e.fwd_thread, e.seq) in keys)
        f = b = 0
        for k, op in self.launched:
            if cover.has(op.thread, op.start):
                f += k.end - k.start
            elif bwd.has(op.thread, op.start):
                b += k.end - k.start
        return f / 1e9, b / 1e9

    def idle_by_span(self) -> dict[str, list] | None:
        """{innermost ``dlv3.`` span at the gap's start (or ``outside``):
        [idle seconds, gaps]} over every device idle gap in the window,
        or None where the trace has no program span or no device event."""
        if self._gaps is not None:
            return self._gaps
        tr = self.tr
        if not self.spans or not tr.device:
            return None
        thread = tr.window.thread
        pieces = _innermost([(e.start, e.end, e.name) for sp in self.spans.values()
                             for e in sp if e.thread == thread])
        starts = [p[0] for p in pieces]
        edges = [tr.t0] + [x for iv in tr.busy_iv for x in iv] + [tr.t1]
        out: dict[str, list] = {}
        for i in range(0, len(edges) - 1, 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            j = bisect.bisect_right(starts, a) - 1
            name = pieces[j][2] if j >= 0 and pieces[j][0] <= a < pieces[j][1] else OUTSIDE
            acc = out.setdefault(name, [0.0, 0])
            acc[0] += (b - a) / 1e9
            acc[1] += 1
        self._gaps = out
        return out


def index(ctx) -> Index:
    """The index of ``ctx.trace``, built by the first reader of the run."""
    ix = getattr(ctx, "program_spans", None)
    if ix is None or ix.tr is not ctx.trace:
        ix = ctx.program_spans = Index(ctx.trace)
    return ix


def host_ms_per_unit(ctx, kind: str, name: str) -> float | None:
    """Host milliseconds a step or call in the ranges ``name``."""
    if ctx.kind != kind or not ctx.units:
        return None
    s = index(ctx).host_s(name)
    return None if s is None else s / ctx.units * 1e3


def device_ms_per_unit(ctx, kind: str, name: str) -> float | None:
    """Device milliseconds a step or call of the ranges ``name``, forward
    and backward."""
    if ctx.kind != kind or not ctx.units:
        return None
    fb = index(ctx).device_s(name)
    if fb is None or sum(fb) <= 0:
        return None
    return sum(fb) / ctx.units * 1e3


def dw_site_roofline(ctx, kind: str) -> float | None:
    """``dw_roofline``'s formula on the ``dlv3.dw_site`` ranges: the least
    time of the depthwise passes in the window over the device time of
    the ranges, forward and (training) backward."""
    if ctx.kind != kind or not ctx.units:
        return None
    fb = index(ctx).device_s("dlv3.dw_site")
    if fb is None or sum(fb) <= 0 or (kind == "train" and fb[1] <= 0):
        return None
    return ctx.dw_least_s_per_unit * ctx.units / sum(fb) * 100.0


def program_idle_ms(ctx, kind: str) -> float | None:
    """Device idle milliseconds a step or call in gaps that start inside a
    program span."""
    if ctx.kind != kind or not ctx.units:
        return None
    gaps = index(ctx).idle_by_span()
    if gaps is None:
        return None
    return sum(s for name, (s, _) in gaps.items() if name != OUTSIDE) / ctx.units * 1e3
