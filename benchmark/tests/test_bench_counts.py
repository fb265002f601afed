"""The FLOP counter and the depthwise bytes against hand counts on small
convolutions, and the counts of the two configurations' sites."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import counts
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


def test_depthwise_bytes_by_hand():
    site = {"x": (2, 8, 10, 12), "y": (2, 8, 5, 6), "k": 3}
    x, y, w = 2 * 8 * 10 * 12, 2 * 8 * 5 * 6, 8 * 9
    assert counts.depthwise_pass(site, False) == (4.0 * (x + y + w), 2.0 * y * 9)
    assert counts.depthwise_pass(site, True) == (4.0 * (2 * x + y + 2 * w), 4.0 * y * 9)
    b, f = counts.depthwise_pass(site, False)
    assert counts.least_seconds(b, f, counts.peaks()) == max(b / 3.35e12, f / 67e12)


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
