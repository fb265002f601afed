"""The FLOP counter and the depthwise bytes against hand counts on small
convolutions, the precision a configuration's ``dtype`` gives, the counts
of the configurations' sites, and the float32 cells' counts and weights
pinned at the values the harness gave before the reference's backbones
moved into files of their own."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import cells, counts
from benchmark.reference import model as ref

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("groups", [1, 8])
def test_conv_flops_by_hand(groups):
    B, C, H, W, k, O = 2, 8, 10, 12, 3, 8
    x = torch.randn(B, C, H, W, requires_grad=True)
    w = torch.randn(O, C // groups, k, k, requires_grad=True)
    with counts.flop_counter() as c:
        y = F.conv2d(x, w, padding=1, groups=groups)
        y.sum().backward()
    forward = 2 * B * O * (C // groups) * k * k * H * W
    assert c.get_total_flops() == 3 * forward  # forward, input and weight gradients


@pytest.mark.parametrize("size", [4, 2])
def test_depthwise_bytes_by_hand(size):
    """A 16-bit element halves a pass's bytes and leaves its FLOPs."""
    site = {"x": (2, 8, 10, 12), "y": (2, 8, 5, 6), "k": 3}
    x, y, w = 2 * 8 * 10 * 12, 2 * 8 * 5 * 6, 8 * 9
    assert counts.depthwise_pass(site, False, size) == (size * (x + y + w), 2.0 * y * 9)
    assert counts.depthwise_pass(site, True, size) == (size * (2 * x + y + 2 * w), 4.0 * y * 9)
    b, f = counts.depthwise_pass(site, False, size)
    assert counts.least_seconds(b, f, counts.peaks()) == max(b / 3.35e12, f / 67e12)
    assert counts.depthwise_least_s([site], True, size) == sum(
        max(b / 3.35e12, f / 67e12) for b, f in (counts.depthwise_pass(site, False, size),
                                                  counts.depthwise_pass(site, True, size)))


@pytest.mark.parametrize("dtype,expected", [("float32", (4, 67e12)),
                                            ("bfloat16", (2, 989.4e12)),
                                            ("float16", (2, 989.4e12))])
def test_precision_of_the_dtype(dtype, expected):
    assert counts.precision({"dtype": dtype}) == expected


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="float64"):
        counts.precision({"dtype": "float64"})


# Each float32 cell at 16 x 512^2 as the harness counted it before the
# backbones moved into files of their own: the model's FLOPs, the least
# time of its depthwise passes, and the weights of seed 0 on the CPU
# (sha256 over each tensor's name and bytes in layout order; float64 sum
# and sum of squares over every element).
PINNED = {
    "flagship-train": (558980136960, 0.001579591909253731, "mobilenetv2"),
    "xception-train": (2635047874560, 0.004178008597014921, "xception"),
    "flagship-serve": (186930692096, 0.0006047825767164179, "mobilenetv2"),
    "xception-serve": (878948561920, 0.001671155553432834, "xception"),
}
WEIGHTS = {
    "mobilenetv2": ("c2055fda7cf6452edfc1998263592390cb80d2b04b894d4a47e754951742a2ae",
                    21866.476688740277, 26189.72947300453),
    "xception": ("c345f23ad7c312ff52625bb9157f4d63466e6d93ba3e997e4038c6f84e249823",
                 50682.35901306586, 74732.93421841394),
}


@pytest.mark.parametrize("name", list(PINNED))
def test_float32_cells_pinned(name):
    flops, least, base = PINNED[name]
    cell = cells.load(name)
    conf = dict(cell.config["config"], **cell.mix.get("conf_extra", {}))
    arch = ref.arch_of(conf)
    assert arch.base_model == base
    train = cell.mix["kind"] == "train"
    got, sites = counts.model_flops(arch, 16, 512, train, float(conf["hps"]["weight_decay"]))
    assert got == flops
    assert counts.depthwise_least_s(sites, train, counts.precision(cell.config)[0]) == least
    weights = ref.random_weights(arch, 0, "cpu")
    digest, total, squares = hashlib.sha256(), 0.0, 0.0
    for n, _, _ in ref.param_spec(arch):
        a = weights[n].double().numpy()
        digest.update(n.encode())
        digest.update(weights[n].numpy().tobytes())
        total += float(np.sum(a))
        squares += float(np.sum(a * a))
    assert (digest.hexdigest(), total, squares) == WEIGHTS[base]


def test_sites_recorded_by_the_reference():
    """Every depthwise weight of a configuration is one site of its forward."""
    for name in ("mobilenetv2-os16-br", "xception-os16"):
        conf = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())["config"]
        arch = ref.arch_of(conf)
        flops, sites = counts.model_flops(arch, 2, 64, train=False)
        dw = [n for n, shp, _ in ref.param_spec(arch) if len(shp) == 4 and shp[1] == 1]
        assert [s["name"] + ".weight" for s in sites] == dw
        assert flops > 0
        train_flops, _ = counts.model_flops(arch, 2, 64, train=True)
        # a step's backward costs about twice its forward (no dgrad of the images)
        assert 2.5 * flops < train_flops < 3.1 * flops
