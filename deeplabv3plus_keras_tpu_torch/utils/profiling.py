"""Tracing, step timing and structured metrics (port of
``deeplabv3plus_keras_tpu/utils/profiling.py:26-85``).

- ``profiler_trace(logdir)``: a ``torch.profiler`` trace (host and CUDA
  activity) of the block, written to ``logdir`` as a Chrome trace with a
  table of device time by kernel beside it.
- ``StepTimer``: per-step time statistics (mean, p50, p95) after a
  warm-up; on a CUDA device from events at both ends of a step, so a
  step's time is the device's, not its enqueue, and the loop never waits.
- ``MetricsLogger``: append-only JSONL of per-epoch metrics.
- ``span(name)``: a named range of the program's host work, recorded by
  an active ``torch.profiler`` (``profiler_trace`` included, whose Chrome
  trace shows it) as a CPU operation on the same clock as the device's
  events.  It is no user annotation, so it adds nothing to the device's
  timeline.  With no profiler active a range costs under a microsecond
  and records nothing; where the installed torch lacks the fast range
  it does nothing.

The program's ranges (every name starts with ``dlv3.``):

- ``dlv3.segment`` around ``segment()``, with ``dlv3.segment.copy_in``
  (the images to the device), ``dlv3.segment.forward`` (the label step's
  launches) and ``dlv3.segment.copy_out`` (the wait for the labels and
  their copy to the host);
- ``dlv3.step`` around a train step, with ``dlv3.step.forward`` (the
  model), ``dlv3.step.tail`` (loss, confusion matrix, L2),
  ``dlv3.step.backward`` and ``dlv3.step.optimizer`` (the gradients'
  zero fill, their reduction over ranks and the update); the first three
  repeat once a ``grad_accum`` microbatch;
- ``dlv3.data.batch`` around each device-side batch of the data path
  (the gather from the device cache, or the copy of the host canvases,
  and the preprocessing);
- ``dlv3.bn`` around each ``BatchNorm`` module's forward;
- ``dlv3.dw_site`` around each depthwise pass (``kernels.depthwise_conv``
  or ``kernels.depthwise_cf``), whatever route runs it.

The forward operations inside a range carry the autograd sequence numbers
of the backward nodes they create, so a trace attributes the backward's
kernels to the range too.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

try:  # a profiler range that is a plain CPU operation (no user annotation)
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # an older torch: no ranges
    _Range = None


def span(name: str):
    """A context manager: the profiler range ``name`` (see the module's
    docstring), or nothing where the installed torch lacks the fast
    range.  Never ``record_function``: that one costs ~15 µs a range and
    is repeated on the device's timeline as an annotation."""
    return _Range(name) if _Range is not None else contextlib.nullcontext()


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """``torch.profiler`` trace of the block if ``logdir`` is set; no-op
    otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40) + "\n")


class StepTimer:
    """``with timer: step()``: the time of each step, the first ``warmup``
    steps left out.  On a CUDA ``device`` a step's time is the device's:
    CUDA events recorded at the block's two ends, read (one synchronise)
    by :meth:`stats`, so timing adds no synchronise to the loop.
    Elsewhere it is the host's clock around the block."""

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.times: list[float] = []
        self._events: list = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._count += 1
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            if self._count > self.warmup:
                self._events.append((self._t0, end))
        else:
            dt = time.perf_counter() - self._t0
            if self._count > self.warmup:
                self.times.append(dt)
        return False

    def stats(self) -> dict:
        for start, end in self._events:
            end.synchronize()
            self.times.append(start.elapsed_time(end) / 1e3)
        self._events = []
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {"steps": n, "mean_s": sum(ts) / n, "p50_s": ts[n // 2],
                "p95_s": ts[min(n - 1, int(n * 0.95))]}


class MetricsLogger:
    """Append-only JSONL metrics log (one line per epoch or event)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: dict):
        if not self.path:
            return
        record = {"ts": time.time(), **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
