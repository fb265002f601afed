"""A configuration, a traffic mix, a kind of loop, a per-layer metric, a
cell's limits and a reference backbone are found by name: a copy of the
benchmark with new files and new entries only (no existing file edited)
runs its new cell and reads its new metric, and a new backbone in a
16-bit configuration is counted, drawn and run by the reference."""

from __future__ import annotations

import json
import shutil
import types
from pathlib import Path

import pytest
import torch

from benchmark import cells, counts, loops, run
from benchmark.reference import model as ref

REPO = Path(__file__).resolve().parents[2]


def _copy(tmp_path):
    """A copy of the benchmark, ``BENCHMARK.json`` and the bytes of every
    file of the copy."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    return bench, before


def _unchanged(tmp_path, before):
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


def test_new_files_and_entries_only(tmp_path):
    bench, before = _copy(tmp_path)

    # a new configuration: the flagship at 64², a new mix, a new metric
    flagship = json.loads((REPO / "benchmark/configs/mobilenetv2-os16-br.json").read_text())
    flagship["name"] = "dummy-config"
    flagship["config"]["nn_arch"]["image_size"] = 64
    flagship["config"]["hps"]["batch_size"] = 2
    (tmp_path / "benchmark/configs/dummy-config.json").write_text(json.dumps(flagship))
    mix = json.loads((REPO / "benchmark/mixes/serve.json").read_text())
    mix["pool_batches"] = 2
    mix["kind"] = "serve-copy"  # a new kind of loop: a file of its own
    (tmp_path / "benchmark/mixes/dummy-mix.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/kinds/serve-copy.py").write_text(
        (REPO / "benchmark/kinds/serve.py").read_text())
    (tmp_path / "benchmark/metrics/calls.dummy.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    (tmp_path / "benchmark/limits/dummy-cell.json").write_text('{"label_gap": 1.0}')
    bench["configs"].append({"name": "dummy-config", "source": "a test",
                             "file": "benchmark/configs/dummy-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls.dummy", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "a test",
                               "moves": "serve_images_per_s", "workloads": ["dummy-cell"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("dummy-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load("dummy-cell", repo=tmp_path, bench_dir=tmp_path / "benchmark")
    assert cell.config["name"] == "dummy-config" and cell.mix["pool_batches"] == 2
    assert cell.loop_class().__module__.endswith("serve-copy")
    assert [m["name"] for m in cell.per_layer] == ["calls.dummy"]
    assert {m["name"] for m in cell.end_to_end} == {"serve_images_per_s", "serve_peak_gib",
                                                     "setup_s"}
    torch.set_num_threads(4)
    result = run.execute(cell, 2**31 + 3, 0.2, True, device="cpu")
    assert result["metrics"]["calls.dummy"]["value"] == result["attempted"]
    # the cells already there load as before
    for w in ("flagship-train", "xception-serve"):
        old = cells.load(w)
        new = cells.load(w, repo=tmp_path, bench_dir=tmp_path / "benchmark")
        assert (old.config, old.mix, old.limits) == (new.config, new.mix, new.limits)
    # and no file that was there changed
    _unchanged(tmp_path, before)


# A backbone the program does not know: four stride-2 convs with BN, then a
# depthwise conv at k = 5 with BN (output stride 16).
TOY = '''
from benchmark.reference.model import bn, conv, depthwise, relu6

WIDTHS = (16, 24, 32, 48)


def spec(s, os_):
    assert os_ == 16
    cin = 3
    for i, cout in enumerate(WIDTHS):
        s.conv(f"base.toy{i}", cout, cin, 3)
        s.bn(f"base.toy{i}_bn", cout)
        cin = cout
    s.conv("base.toy_dw.depthwise", cin, 1, 5)
    s.bn("base.toy_dw_bn", cin)
    return cin


def forward(run, x, os_):
    for i in range(len(WIDTHS)):
        x = relu6(bn(run, f"base.toy{i}_bn", conv(x, run.p[f"base.toy{i}.weight"], 2), 0.99))
    return relu6(bn(run, "base.toy_dw_bn", depthwise(run, "base.toy_dw.depthwise", x), 0.99))
'''


def test_new_backbone_in_16_bits(tmp_path):
    """A backbone file, a bfloat16 configuration naming it, a train mix and
    a limits file, each new: the cell loads, its weights are drawn, its
    FLOPs and depthwise passes counted at 2 bytes an element, and the
    reference's logits are finite.  The program is not built: it has no
    such backbone."""
    bench, before = _copy(tmp_path)
    bdir = tmp_path / "benchmark"
    (bdir / "reference/backbones/toynet.py").write_text(TOY)
    conf = json.loads((REPO / "benchmark/configs/mobilenetv2-os16-br.json").read_text())
    conf["name"], conf["dtype"] = "toynet-bf16", "bfloat16"
    conf["config"]["base_model"] = "toynet"
    conf["config"]["hps"]["dtype"] = "bfloat16"
    conf["config"]["nn_arch"]["image_size"] = 64
    conf["config"]["hps"]["batch_size"] = 2
    (bdir / "configs/toynet-bf16.json").write_text(json.dumps(conf))
    mix = dict(json.loads((REPO / "benchmark/mixes/train.json").read_text()), images=6)
    (bdir / "mixes/toy-train.json").write_text(json.dumps(mix))
    limits = json.loads((REPO / "benchmark/limits/flagship-train.json").read_text())
    (bdir / "limits/toynet-train.json").write_text(json.dumps(limits))
    bench["configs"].append({"name": "toynet-bf16", "source": "a test",
                             "file": "benchmark/configs/toynet-bf16.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "toynet-train", "config": "toynet-bf16",
                               "traffic": "toy-train", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train_images_per_s" in (m["name"], m.get("moves")) or m["name"] == "train_peak_gib":
            m["workloads"].append("toynet-train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load("toynet-train", repo=tmp_path, bench_dir=bdir)
    assert ([m["name"] for m in cell.per_layer]
            == [m["name"] for m in cells.load("flagship-train").per_layer])
    assert counts.precision(cell.config) == (2, counts.peaks()["bf16_tensor_flop_per_s"])
    torch.set_num_threads(4)
    loop = cell.loop_class()(cell, 2**31 + 5, "cpu", loops.Spans(False))
    try:
        weights = loop.make_weights()
    finally:
        loop.close()
    assert {n for n, _, _ in ref.param_spec(loop.arch)} == set(weights)
    assert "base.toy_dw.depthwise.weight" in weights
    flops, sites = counts.model_flops(loop.arch, loop.batch, loop.size, True,
                                      float(loop.conf["hps"]["weight_decay"]))
    assert flops > 0 and sites[0]["name"] == "base.toy_dw.depthwise" and sites[0]["k"] == 5
    assert counts.depthwise_least_s(sites, True, 2) > 0
    for backward in (False, True):
        half = sum(counts.depthwise_pass(s, backward, 2)[0] for s in sites)
        assert 2 * half == sum(counts.depthwise_pass(s, backward, 4)[0] for s in sites)
    images = torch.rand((loop.batch, loop.size, loop.size, 3)) * 2.0 - 1.0
    logits, up = ref.logits(ref.Run(weights, train=False), loop.arch, images)
    assert logits.shape == (loop.batch, 21, loop.size // up, loop.size // up)
    assert torch.isfinite(logits).all()
    # the reference's own directory has no such backbone
    with pytest.raises(ValueError, match="toynet.*backbones"):
        ref.param_spec(ref.arch_of(loop.conf))
    _unchanged(tmp_path, before)


def test_unlisted_workloads_key():
    """A per-layer metric without ``workloads`` belongs to every cell that
    reports the end-to-end metric it moves."""
    m = {"name": "x", "moves": "serve_images_per_s"}
    assert cells._applies(m, "any", {"serve_images_per_s", "setup_s"})
    assert not cells._applies(m, "any", {"train_images_per_s", "setup_s"})


def test_tagged_name_reads_with_its_base():
    """``<base>.<tag>`` without a file of its own reads with ``<base>``'s
    reader; a name with a file of its own keeps it; no base raises."""
    cell = cells.load("flagship-serve")
    twins = [m["name"] for m in cell.per_layer if m["name"].endswith(".flagship")]
    assert twins and all(m["moves"] == "serve_peak_gib" for m in cell.per_layer)
    for name in twins:
        assert (cell.reader(name).__module__
                == f"benchmark_metrics_{name.removesuffix('.flagship')}")
    own = cell.reader("serve_images_per_s.traced")
    assert own.__module__.endswith("serve_images_per_s.traced")
    ctx = types.SimpleNamespace(kind="serve", units=30, batch=16, window_s=2.0)
    assert own(ctx) == 240.0
    assert own(types.SimpleNamespace(kind="train", units=30, batch=16, window_s=2.0)) is None
    with pytest.raises(FileNotFoundError):
        cell.reader("no_such_metric.flagship")


def test_the_flagships_serving_rate_is_per_layer():
    """``flagship-serve`` reports its memory peak and set-up end to end and
    its rate per layer; ``xception-serve`` its rate and peak end to end."""
    flag, xc = cells.load("flagship-serve"), cells.load("xception-serve")
    assert {m["name"] for m in flag.end_to_end} == {"serve_peak_gib", "setup_s"}
    assert {m["name"] for m in xc.end_to_end} == {"serve_images_per_s", "serve_peak_gib",
                                                  "setup_s"}
    assert "serve_images_per_s.traced" in {m["name"] for m in flag.per_layer}
    assert ({m["name"].removesuffix(".flagship") for m in flag.per_layer}
            == {m["name"] for m in xc.per_layer} | {"serve_images_per_s.traced"})
