"""The traced run's reading of a ``torch.profiler`` trace.

The harness marks its own spans with ``record_function`` names that start
with ``bench.`` (the window, the data wait, a step's dispatch, a call, each
depthwise site's forward); everything else in the trace is the program's
and PyTorch's.  From the profiler's events this module takes:

- the device's busy time: the union of every device event's interval
  (kernels, copies, sets) inside the window;
- the device operations that took most time, by name;
- the idle gaps of the device inside the window, each named by the
  innermost ``bench.`` span the host thread that ran the window was in
  when the gap began;
- the device time of the depthwise sites: kernels launched inside a
  ``bench.dw_site`` span (the forward), and kernels launched by the
  backward nodes that those spans created (matched by the autograd
  sequence number the profiler records for a node's forward op and for
  its backward), whatever kernel a site runs;
- the device time of host↔device copies.
"""

from __future__ import annotations

import bisect
import dataclasses

# CUPTI's own bookkeeping, shown as device time but not the program's work
NOT_WORK = ("Activity Buffer Request",)
SPAN_PREFIX = "bench."
SITE_SPAN = "bench.dw_site"
WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Ev:
    name: str
    start: int  # ns
    end: int
    thread: int
    corr: int
    linked: int
    seq: int
    fwd_thread: int
    device: bool


def events_of(prof) -> list[Ev]:
    """The profiler's events as plain records."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Ev(e.name(), start, start + e.duration_ns(), e.start_thread_id(),
                      e.correlation_id(), e.linked_correlation_id(), e.sequence_nr(),
                      e.fwd_thread_id(), str(e.device_type()).endswith("CUDA")))
    return out


def _union(intervals):
    """Disjoint sorted union of (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class _Cover:
    """Per thread, the union of some intervals; ``has(thread, t)``."""

    def __init__(self, rows):
        by = {}
        for thread, a, b in rows:
            by.setdefault(thread, []).append((a, b))
        self.by = {t: _union(v) for t, v in by.items()}
        self.starts = {t: [a for a, _ in v] for t, v in self.by.items()}

    def has(self, thread: int, t: int) -> bool:
        iv = self.by.get(thread)
        if not iv:
            return False
        i = bisect.bisect_right(self.starts[thread], t) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]


class Trace:
    def __init__(self, events: list[Ev]):
        win = [e for e in events if e.name == WINDOW_SPAN and not e.device]
        if len(win) != 1:
            raise ValueError(f"expected one {WINDOW_SPAN} span, found {len(win)}")
        self.window = win[0]
        self.t0, self.t1 = win[0].start, win[0].end
        # the harness's own ranges also show on the device's timeline as
        # annotations: they are not device work
        self.device = [e for e in events if e.device and e.name not in NOT_WORK
                       and not e.name.startswith(SPAN_PREFIX)
                       and e.end > self.t0 and e.start < self.t1]
        self.cpu = [e for e in events if not e.device]
        self.busy_iv = _union((max(e.start, self.t0), min(e.end, self.t1)) for e in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_iv) / 1e9

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0) + (e.end - e.start)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest device idle gaps in the window, each named by the
        innermost ``bench.`` span of the window's thread at its start."""
        edges = [self.t0] + [x for iv in self.busy_iv for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = [e for e in self.cpu if e.thread == self.window.thread
                 and e.name.startswith(SPAN_PREFIX)]
        out = []
        for a, b in gaps[:top]:
            inner = [s for s in spans if s.start <= a < s.end]
            name = min(inner, key=lambda s: s.end - s.start).name if inner else "outside"
            out.append([name, (b - a) / 1e9])
        return out

    def device_s(self, prefix: str) -> float:
        """Device seconds of the events whose name starts with ``prefix``."""
        return sum(e.end - e.start for e in self.device if e.name.startswith(prefix)) / 1e9

    def site_device_s(self) -> tuple[float, float]:
        """(forward, backward) device seconds of the depthwise sites."""
        sites = _Cover((e.thread, e.start, e.end) for e in self.cpu if e.name == SITE_SPAN)
        fwd_keys = {(e.thread, e.seq) for e in self.cpu
                    if e.seq >= 0 and e.fwd_thread == 0 and e.name != SITE_SPAN
                    and sites.has(e.thread, e.start)}
        bwd = _Cover((e.thread, e.start, e.end) for e in self.cpu
                     if e.fwd_thread != 0 and e.seq >= 0 and (e.fwd_thread, e.seq) in fwd_keys)
        by_corr = {e.corr: e for e in self.cpu if e.corr}
        f = b = 0
        for k in self.device:
            op = by_corr.get(k.linked)
            if op is None:
                continue
            if sites.has(op.thread, op.start):
                f += k.end - k.start
            elif bwd.has(op.thread, op.start):
                b += k.end - k.start
        return f / 1e9, b / 1e9
