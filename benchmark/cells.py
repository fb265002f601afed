"""Cells by name: ``BENCHMARK.json`` names each cell's configuration and
traffic mix, and the files are found by those names, so a configuration,
a mix, a per-layer metric or a cell's correctness limits is added as files
and entries alone:

- a configuration: the ``file`` its ``configs`` entry names;
- a mix: ``mixes/<traffic>.json``, which names its kind of loop;
- a kind of loop: ``kinds/<kind>.py``, whose ``Loop`` class drives it;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns
  the value or None; a name ``<base>.<tag>`` with no file of its own reads
  with ``<base>``'s (the same quantity in cells that report another
  end-to-end metric, which its entry ``moves``);
- a cell's correctness limits: ``limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict       # the configuration file's contents
    mix: dict          # the mix file's contents
    end_to_end: list   # the cell's end-to-end metric entries
    per_layer: list    # the cell's per-layer metric entries
    limits: dict       # the correctness limits, by compared number
    bench_dir: Path

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric: ``metrics/<name>.py``,
        else that of the name with its last ``.<tag>`` taken off, in turn."""
        name = metric
        while not (self.bench_dir / "metrics" / f"{name}.py").exists() and "." in name:
            name = name.rsplit(".", 1)[0]
        return _module(self.bench_dir / "metrics" / f"{name}.py").read

    def loop_class(self):
        """The ``Loop`` class of the mix's kind."""
        return _module(self.bench_dir / "kinds" / f"{self.mix['kind']}.py").Loop


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, workload: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load(workload: str, repo: Path = REPO, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((repo / configs[w["config"]]["file"]).read_text())
    mix = json.loads((bench_dir / "mixes" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text())
    return Cell(workload, int(w["chips"]), config, mix, e2e, per_layer, limits, bench_dir)
