"""A cell on two chips runs as two ranks in a process group (here on the
CPU over gloo), with a kind of loop added as a file: rank 0 returns one
result whose device count is the world's, whose memory peak is the
fullest rank's, and whose compared numbers are the worst rank's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import cells, run

REPO = Path(__file__).resolve().parents[2]

KIND = '''
import torch
import torch.distributed as dist

from benchmark.loops import Loop as Base


class Loop(Base):
    kind = "ranks-dummy"

    def setup(self):
        self.rank = dist.get_rank()
        self.phase("setup")

    def window(self, seconds):
        total = torch.ones(1) * (self.rank + 1)
        dist.all_reduce(total)
        return {"units": 1, "attempted": 1, "failed": 0, "window_s": 1.0,
                "memory_peak_bytes": 1000 * (self.rank + 1),
                "metrics": {"serve_images_per_s": float(total)}}

    def check(self):
        return {"numbers": {"label_gap": 0.1 * self.rank}, "detail": {}}
'''


def test_two_ranks(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark/kinds/ranks-dummy.py").write_text(KIND)
    (tmp_path / "benchmark/mixes/ranks-mix.json").write_text('{"kind": "ranks-dummy"}')
    (tmp_path / "benchmark/limits/ranks-cell.json").write_text('{"label_gap": 0.05}')
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ranks-cell", "config": "mobilenetv2-os16-br",
                               "traffic": "ranks-mix", "chips": 2, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_images_per_s":
            m["workloads"].append("ranks-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load("ranks-cell", repo=tmp_path, bench_dir=tmp_path / "benchmark")
    result = run.ranks(cell, 2**31 + 7, 0.1, False, device_type="cpu", backend="gloo")
    assert result is not None
    assert result["device"]["count"] == 2
    assert result["device"]["memory_peak_bytes"] == 2000
    assert result["metrics"]["serve_images_per_s"]["value"] == 3.0
    assert result["checks"]["label_gap"]["value"] == 0.1  # rank 1's
    assert result["correct"] is False
    assert result["forbidden"] == []
