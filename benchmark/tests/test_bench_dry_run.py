"""A dry run of every cell at a tiny size on the CPU (the program's plain
paths): the result line has the keys a run prints, the metrics the cell
names, and every compared number beside its limit, last."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_cell

CELLS = ("flagship-train", "xception-train", "flagship-serve", "xception-serve")


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, traced):
    torch.set_num_threads(4)
    cell = tiny_cell(name)
    line = run.result_line(run.execute(cell, 2**31 + 17, 0.3, bool(traced), device="cpu"))
    result = json.loads(line)
    keys = list(result)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert keys[-1] == "checks"
    assert ("breakdown" in result) == bool(traced)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert isinstance(result["correct"], bool)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in cell.per_layer}
        # on the CPU the device readers find nothing and are left out
        assert set(result["metrics"]) <= names
        assert any(n.startswith("mfu.") for n in result["metrics"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert "setup_s" in result["metrics"]
        for m in result["metrics"].values():
            assert m["value"] > 0 or m["unit"] == "GiB"
    assert set(result["checks"]) == set(cell.limits)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
