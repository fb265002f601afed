"""A run with the timed path broken underneath comes out not correct.
The harness's look for a chip is skipped (``run.execute`` on the CPU at a
tiny size), and each fault a cell can have is planted in the program
before the warm-up (``benchmark/control.py``, the faults the chip readings
plant):

- training: a step that returns its parameters unchanged; one that leaves
  BN's running statistics unchanged; one that leaves out half of the
  batch and takes the mean over the rest;
- serving: a label altered where it is produced.

A cell on one chip has no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, run
from benchmark.tests.tiny import tiny_cell

TRAIN_FAULTS = {"unchanged_state": "update_gap", "unchanged_stats": "stats_gap",
                "half_batch": "grad_gap"}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_training_fault_is_not_correct(fault):
    torch.set_num_threads(4)
    cell = tiny_cell("flagship-train")
    result = run.execute(cell, 2**31 + 29, 0.2, False, device="cpu",
                         patch=control.READINGS[fault])
    assert result["correct"] is False
    number = TRAIN_FAULTS[fault]
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


def test_serving_fault_is_not_correct():
    torch.set_num_threads(4)
    cell = tiny_cell("flagship-serve")
    result = run.execute(cell, 2**31 + 31, 0.2, False, device="cpu",
                         patch=control.altered_label)
    assert result["correct"] is False
    assert result["checks"]["label_gap"]["value"] > result["checks"]["label_gap"]["limit"]
