"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: 64²
images, batches of 2, a tree of 6 images (three steps an epoch, so the
warm-up crosses an epoch's end), a pool of 2 batches."""

from __future__ import annotations

import copy

from benchmark import cells


def tiny_cell(name: str, **limits):
    c = cells.load(name)
    c.config = copy.deepcopy(c.config)
    c.config["config"]["nn_arch"]["image_size"] = 64
    c.config["config"]["hps"]["batch_size"] = 2
    c.mix = dict(c.mix, images=6, pool_batches=2)
    c.limits = dict(c.limits, **limits)
    return c
