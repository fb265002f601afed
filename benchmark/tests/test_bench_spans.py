"""The readers of the program's ``dlv3.`` spans (``benchmark/spans.py``):
on a synthetic timeline, host time, forward and backward device time
matched through the autograd sequence numbers, and idle gaps by the
innermost span; a trace without the spans (a program that lacks them)
gives None; and a tiny traced CPU run of each kind, in which every new
metric of the kind reads a value."""

from __future__ import annotations

import json
import types
from pathlib import Path

import pytest
import torch

from benchmark import run, spans, trace
from benchmark.tests.tiny import tiny_cell
from benchmark.trace import Ev, Trace

REPO = Path(__file__).resolve().parents[2]
NEW = {
    "serve": ("stage_ms.serve", "launch_ms.serve", "drain_ms.serve", "bn_device_ms.serve",
              "dw_site_roofline.serve", "program_idle_ms.serve"),
    "train": ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train",
              "data_device_ms.train", "tail_device_ms.train", "bn_device_ms.train",
              "dw_site_roofline.train", "program_idle_ms.train"),
}


def cpu(name, a, b, corr=0, seq=-1, fwd=0, thread=1):
    return Ev(name, a, b, thread, corr, 0, seq, fwd, False)


def dev(name, a, b, linked):
    return Ev(name, a, b, 9, 0, linked, -1, 0, True)


def _timeline():
    return [
        cpu("bench.window", 0, 1000),
        cpu("bench.data", 0, 5),
        # an operation that creates no node records the next node's number
        cpu("dlv3.data.batch", 1, 4),
        cpu("aten::index", 2, 3, corr=8, seq=7),
        cpu("bench.step", 5, 500),
        cpu("dlv3.step", 5, 495),
        cpu("dlv3.step.forward", 5, 100),
        cpu("dlv3.bn", 10, 50),
        cpu("aten::clone", 11, 12, seq=7),
        cpu("aten::batch_norm", 12, 40, corr=1, seq=7),
        cpu("aten::relu", 60, 70, corr=2, seq=8),
        cpu("dlv3.step.tail", 100, 150),
        cpu("aten::nll", 110, 140, corr=3, seq=9),
        cpu("dlv3.step.backward", 150, 400),
        # the backward, on the autograd thread: the tail's node, ReLU's, BN's
        cpu("NllBackward", 200, 240, corr=4, seq=9, fwd=1, thread=2),
        cpu("ReluBackward", 250, 280, corr=5, seq=8, fwd=1, thread=2),
        cpu("BnBackward", 300, 350, corr=6, seq=7, fwd=1, thread=2),
        cpu("dlv3.step.optimizer", 400, 495),
        cpu("aten::_foreach_add_", 410, 420, corr=7),
        dev("gather", 6, 8, linked=8),
        dev("bn_fwd", 100, 130, linked=1),
        dev("relu", 130, 140, linked=2),
        dev("nll_fwd", 150, 170, linked=3),
        dev("nll_bwd", 260, 280, linked=4),
        dev("relu_bwd", 280, 290, linked=5),
        dev("bn_bwd", 360, 400, linked=6),
        dev("adam", 420, 430, linked=7),
    ]


def test_synthetic_timeline():
    ix = spans.Index(Trace(_timeline()))
    assert ix.host_s("dlv3.step.forward") == 95 / 1e9
    assert ix.host_s("dlv3.step.backward") == 250 / 1e9
    assert ix.host_s("dlv3.segment") is None
    assert ix.device_s("dlv3.bn") == (30 / 1e9, 40 / 1e9)
    assert ix.device_s("dlv3.step.tail") == (20 / 1e9, 20 / 1e9)
    assert ix.device_s("dlv3.step.forward") == (40 / 1e9, 50 / 1e9)
    assert ix.device_s("dlv3.step.optimizer") == (10 / 1e9, 0.0)
    # the gather's number is BN's: BN's backward is not the data path's
    assert ix.device_s("dlv3.data.batch") == (2 / 1e9, 0.0)
    # gaps: 0..6 (the data path), 8..100 (after dlv3.step opened), 140..150
    # (the tail), 170..260 and 290..360 (the backward), 400..420 and
    # 430..1000 (the optimizer)
    gaps = ix.idle_by_span()
    assert {k: n for k, (_, n) in gaps.items()} == {
        spans.OUTSIDE: 1, "dlv3.step.forward": 1, "dlv3.step.tail": 1,
        "dlv3.step.backward": 2, "dlv3.step.optimizer": 2}
    assert {k: s * 1e9 for k, (s, _) in gaps.items()} == pytest.approx({
        spans.OUTSIDE: 6, "dlv3.step.forward": 92, "dlv3.step.tail": 10,
        "dlv3.step.backward": 160, "dlv3.step.optimizer": 590})
    ctx = _ctx(ix.tr, "train", units=1)
    assert spans.index(ctx) is spans.index(ctx)  # built once a run


def test_readers_on_the_synthetic_timeline():
    tr = Trace(_timeline())
    cell = tiny_cell("flagship-train")
    ctx = _ctx(tr, "train", units=2)
    got = {name: cell.reader(name)(ctx) for name in NEW["train"]}
    assert got["forward_host_ms.train"] == pytest.approx(95 / 2 / 1e6)
    assert got["backward_host_ms.train"] == pytest.approx(250 / 2 / 1e6)
    assert got["optimizer_host_ms.train"] == pytest.approx(95 / 2 / 1e6)
    assert got["tail_device_ms.train"] == pytest.approx(40 / 2 / 1e6)
    assert got["bn_device_ms.train"] == pytest.approx(70 / 2 / 1e6)
    assert got["program_idle_ms.train"] == pytest.approx(852 / 2 / 1e6)
    assert got["data_device_ms.train"] == pytest.approx(2 / 2 / 1e6)
    assert got["dw_site_roofline.train"] is None  # no dlv3.dw_site span
    # the serving readers read nothing of a training run
    serve = tiny_cell("flagship-serve")
    for name in NEW["serve"]:
        assert serve.reader(name)(ctx) is None


def test_a_program_without_spans_reads_none():
    """The parent of the spans: every new reader returns None, none raises."""
    tr = Trace([e for e in _timeline() if not e.name.startswith("dlv3.")])
    for kind, names in NEW.items():
        cell = tiny_cell(f"flagship-{kind}")
        for name in names:
            assert cell.reader(name)(_ctx(tr, kind, units=2)) is None, name


def _ctx(tr, kind, units):
    return types.SimpleNamespace(kind=kind, trace=tr, units=units, flops_per_unit=1.0,
                                 dw_least_s_per_unit=1e-9, host={}, peaks={})


def test_cost_probe():
    """The cost probe of ``span_report``: the fast range is present, costs
    less than ``record_function`` and is never on a device's timeline."""
    from benchmark import span_report

    got = span_report.cost()
    assert got["fast_range"] and got["span_us"] < got["record_function_us"]
    assert "dlv3.kernel" not in got["on_device_timeline"]


def test_entries_in_benchmark_json():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    for kind, names in NEW.items():
        for name in names:
            m = entries[name]
            if kind == "train":
                assert m["workloads"] == ["flagship-train", "xception-train"]
            else:  # the flagship's serving rate is per layer: its cell reads a twin
                assert m["workloads"] == ["xception-serve"]
                twin = entries[f"{name}.flagship"]
                assert twin == dict(m, name=twin["name"], moves="serve_peak_gib",
                                    workloads=["flagship-serve"])
            assert m["layer"] in layers and (REPO / "benchmark/metrics" / f"{name}.py").exists()
            assert m["source"] == ("host_clock" if "_host_" in name or name.split(".")[0] in (
                "stage_ms", "launch_ms", "drain_ms") else "device_trace")


def _mirrored(events_of):
    """The profiler's events with a device event for every leaf ``aten::``
    operation on the CPU, linked to it as CUPTI links a kernel to its
    launch: the CPU has no device timeline of its own."""
    def events(prof):
        evs = events_of(prof)
        by_thread = {}
        for e in evs:
            if not e.device:
                by_thread.setdefault(e.thread, []).append(e)
        out = list(evs)
        for rows in by_thread.values():
            rows.sort(key=lambda e: (e.start, -e.end))
            for i, e in enumerate(rows):
                nxt = rows[i + 1] if i + 1 < len(rows) else None
                leaf = nxt is None or nxt.start >= e.end
                if leaf and e.name.startswith("aten::") and e.corr and e.end > e.start:
                    out.append(Ev("k." + e.name, e.start, e.end, -1, 0, e.corr, -1, 0, True))
        return out
    return events


@pytest.mark.parametrize("name", ["flagship-train", "flagship-serve"])
def test_tiny_traced_run_reads_every_new_metric(monkeypatch, name):
    torch.set_num_threads(4)
    monkeypatch.setattr(trace, "events_of", _mirrored(trace.events_of))
    kept = []

    class Kept(Trace):
        def __init__(self, events):
            super().__init__(events)
            kept.append(self)

    monkeypatch.setattr(trace, "Trace", Kept)
    cell = tiny_cell(name)
    result = run.execute(cell, 2**31 + 29, 0.3, True, device="cpu")
    kind = name.split("-")[1]
    # a twin ``<metric>.flagship`` reads as its base
    got = {m.removesuffix(".flagship"): v for m, v in result["metrics"].items()}
    for m in NEW[kind]:
        assert m in got and got[m]["value"] > 0, m
    assert not [op for op, _ in result["breakdown"]["device_ops"] if op.startswith("dlv3.")]
    if kind == "train":
        # the program's sites and the harness's hooks: the same passes
        assert got["dw_site_roofline.train"]["value"] == pytest.approx(
            got["dw_roofline.train"]["value"], rel=0.1)
        # backward only where a range's operations made autograd nodes
        ix = spans.Index(kept[0])
        assert ix.device_s("dlv3.data.batch")[1] == 0
        assert ix.device_s("dlv3.step.optimizer")[1] == 0
        assert min(ix.device_s("dlv3.bn")) > 0 and min(ix.device_s("dlv3.step.tail")) > 0
        host = result["detail"]["host_ms"]["step"]
        phases = sum(got[m]["value"] for m in ("forward_host_ms.train", "backward_host_ms.train",
                                               "optimizer_host_ms.train"))
        assert phases < host
    else:
        host = result["detail"]["host_ms"]["segment"]
        phases = sum(got[m]["value"] for m in ("stage_ms.serve", "launch_ms.serve",
                                               "drain_ms.serve"))
        assert 0.9 * host < phases < host
