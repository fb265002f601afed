"""On the card, at a cell's own size: the control (the plain reference in
the precision below the configuration's put in the program's place: TF32
for these float32 cells) and a planted fault come out not correct through
the harness's own check.  Skips without a card."""

from __future__ import annotations

import pytest
import torch

from benchmark import cells, control, run

FAULT = {"train": "half_batch", "serve": "altered_label"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32, the control's precision, exists only there")
    run.configure(cells.REPO)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship-train", "xception-train",
                                  "flagship-serve", "xception-serve"])
def test_control_and_fault_fail(card, name):
    cell = cells.load(name)
    for reading in ("control", FAULT[cell.mix["kind"]]):
        out = control.reading(cell, 2**31 + 101, reading, 1.0)
        assert out["correct"] is False, out
        assert any(v > cell.limits[k] for k, v in out["numbers"].items()), out
