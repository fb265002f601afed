"""A configuration, a traffic mix, a kind of loop, a per-layer metric and a
cell's limits are found by name: a copy of the benchmark with new files and new entries
only (no existing file edited) runs its new cell and reads its new
metric."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from benchmark import cells, run

REPO = Path(__file__).resolve().parents[2]


def test_new_files_and_entries_only(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}

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
    assert {m["name"] for m in cell.end_to_end} == {"serve_images_per_s", "setup_s"}
    torch.set_num_threads(4)
    result = run.execute(cell, 2**31 + 3, 0.2, True, device="cpu")
    assert result["metrics"]["calls.dummy"]["value"] == result["attempted"]
    # the cells already there load as before
    for w in ("flagship-train", "xception-serve"):
        old = cells.load(w)
        new = cells.load(w, repo=tmp_path, bench_dir=tmp_path / "benchmark")
        assert (old.config, old.mix, old.limits) == (new.config, new.mix, new.limits)
    # and no file that was there changed
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


def test_unlisted_workloads_key():
    """A per-layer metric without ``workloads`` belongs to every cell that
    reports the end-to-end metric it moves."""
    m = {"name": "x", "moves": "serve_images_per_s"}
    assert cells._applies(m, "any", {"serve_images_per_s", "setup_s"})
    assert not cells._applies(m, "any", {"train_images_per_s", "setup_s"})
