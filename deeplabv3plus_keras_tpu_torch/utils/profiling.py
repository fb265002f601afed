"""Tracing, step timing and structured metrics (port of
``deeplabv3plus_keras_tpu/utils/profiling.py:26-85``).

- ``profiler_trace(logdir)``: a ``torch.profiler`` trace (host and CUDA
  activity) of the block, written to ``logdir`` as a Chrome trace with a
  table of device time by kernel beside it.
- ``StepTimer``: per-step time statistics (mean, p50, p95) after a
  warm-up; on a CUDA device from events at both ends of a step, so a
  step's time is the device's, not its enqueue, and the loop never waits.
- ``MetricsLogger``: append-only JSONL of per-epoch metrics.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


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
