"""The program's spans in a traced run, beyond the result line.

    python3 -m benchmark.span_report --workload <cell> --seed <n> --seconds 20 [--out <file>]

runs one traced run of the cell as ``python3 -m benchmark.run ... --trace 1``
does (the result line is printed as there), keeps its trace, and writes a
JSON object of the program's ``dlv3.`` spans (``benchmark/spans.py``) to
``--out``, else as one more line of standard output: per span the ranges
a step or call, host ms, device ms (forward, backward), and device idle
ms by the innermost span at each gap's start.

    python3 -m benchmark.span_report --cost

prints what a range costs on this machine, with no profiler active and
with one, against ``record_function``, and which of the two the
profiler repeats on the device's timeline.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def report(argv, out_path=None) -> int:
    from benchmark import run, spans, trace

    kept = []

    class Kept(trace.Trace):
        def __init__(self, events):
            super().__init__(events)
            kept.append(self)

    trace.Trace = Kept
    rc = run.main(argv + ["--trace", "1"])
    if rc or not kept:
        return rc
    tr = kept[0]
    ix = spans.Index(tr)
    units = len(ix.spans.get("dlv3.step", ())) or len(ix.spans.get("dlv3.segment", ()))
    per = 1e3 / max(units, 1)
    out = {"units": units, "busy_ms": tr.busy_s * per, "window_ms": tr.window_s * per,
           "spans": {n: {"ranges": len(ix.spans[n]) / max(units, 1),
                         "host_ms": ix.host_s(n) * per,
                         "device_ms": [x * per for x in ix.device_s(n) or ()]}
                     for n in sorted(ix.spans)},
           "idle_ms": {n: s * per for n, (s, _) in (ix.idle_by_span() or {}).items()}}
    if out_path is None:
        print(json.dumps(out), flush=True)
    else:
        with open(out_path, "w") as f:
            json.dump(out, f)
    return rc


def _per_range_us(make, n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        with make():
            pass
    return (time.perf_counter() - t) / n * 1e6


def cost() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplabv3plus_keras_tpu_torch.utils import profiling
    from deeplabv3plus_keras_tpu_torch.utils.profiling import span

    out = {"torch": torch.__version__, "fast_range": profiling._Range is not None,
           "span_us": _per_range_us(lambda: span("dlv3.cost"), 100000),
           "record_function_us": _per_range_us(
               lambda: torch.profiler.record_function("rf.cost"), 100000),
           "empty_us": _per_range_us(contextlib.nullcontext, 100000)}
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    x = torch.randn(256, 256, device="cuda" if cuda else "cpu")
    with profile(activities=activities) as prof:
        out["span_us_profiled"] = _per_range_us(lambda: span("dlv3.cost"), 20000)
        out["record_function_us_profiled"] = _per_range_us(
            lambda: torch.profiler.record_function("rf.cost"), 20000)
        for _ in range(10):
            with span("dlv3.kernel"):
                x @ x
            with torch.profiler.record_function("rf.kernel"):
                x @ x
        if cuda:
            torch.cuda.synchronize()
    on_device = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.name().endswith(".kernel"):
            on_device[e.name()] = on_device.get(e.name(), 0) + 1
    out["on_device_timeline"] = on_device
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv == ["--cost"]:
        print(json.dumps(cost()))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    return report(["--workload", args.workload, "--seed", args.seed, "--seconds", args.seconds],
                  args.out)


if __name__ == "__main__":
    sys.exit(main())
