"""Operations and bytes of the work a cell asks for, counted from the
plain reference's shapes (never from the program), and the chip's peaks.

- The model's FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the
  reference's forward (serving: up to the pre-upsample logits, what a
  label call computes) or forward and backward (a training step, loss
  included), run on the ``meta`` device at the cell's shapes.  Nothing is
  recomputed there, so nothing recomputed is counted.  The counter's own
  formula for a convolution's backward ignores ``groups`` (it counts a
  depthwise kernel gradient C times over); :func:`_conv_backward_flops`
  replaces it: each of the input and weight gradients costs the forward's
  multiply-adds.
- The depthwise work: every depthwise site of that forward, its input and
  output shapes recorded by the reference; in training also its backward.
  A pass's least time is the larger of its bytes over the memory
  bandwidth (each input byte read once, each output byte written once)
  and its FLOPs over the float32 peak.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from .reference import model as ref
from .reference import train as ref_train



def peaks() -> dict:
    """The chip's published peaks (``peaks.json``)."""
    return json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def _meta_inputs(arch: ref.Arch, batch: int, size: int):
    params = {n: torch.empty(shp, device="meta") for n, shp, _ in ref.param_spec(arch)}
    images = torch.empty((batch, size, size, 3), device="meta")
    return params, images


def model_flops(arch: ref.Arch, batch: int, size: int, train: bool, weight_decay: float = 0.0):
    """(FLOPs of one serving forward or one training step, the depthwise
    sites of the forward)."""
    params, images = _meta_inputs(arch, batch, size)
    sites = []
    with flop_counter() as counter:
        if train:
            leaves = {n: p.requires_grad_(True) for n, p in params.items() if ref.is_trainable(n)}
            onehot = torch.empty((batch, size, size, arch.num_classes), device="meta")
            valid = torch.empty((batch,), device="meta")
            run_params = dict(params, **leaves)
            value = _train_loss(arch, run_params, images, onehot, valid, weight_decay, sites)
            value.backward()
        else:
            with torch.no_grad():
                ref.logits(ref.Run(params, train=False, sites=sites), arch, images)
    return counter.get_total_flops(), sites


def flop_counter():
    """``FlopCounterMode`` with a convolution backward that counts groups."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.convolution_backward:
                                           _conv_backward_flops})


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape=None, **kwargs) -> int:
    if transposed:
        raise ValueError("the reference has no transposed convolution")
    forward = 2 * math.prod(w_shape) * x_shape[0] * math.prod(grad_out_shape[2:])
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _train_loss(arch, params, images, onehot, valid, wd, sites):
    probs = ref.probabilities(ref.Run(params, train=True, sites=sites), arch, images)
    pw, nw = (torch.as_tensor(w).to("meta") for w in ref_train.class_weights(arch.num_classes))
    per_pixel = -(pw * onehot * torch.log(probs + ref_train.EPS)
                  + nw * (1.0 - onehot) * torch.log(1.0 - probs + ref_train.EPS)).sum(-1)
    return per_pixel.mean() + wd * sum(params[n].square().sum() for n in params
                                       if ref.is_l2(n) and ref.is_trainable(n))


def depthwise_pass(site: dict, backward: bool, dtype_bytes: int = 4) -> tuple[float, float]:
    """(bytes, FLOPs) of one depthwise site's forward, or its backward
    (dx and dk from x and dy)."""
    x, y, k = math.prod(site["x"]), math.prod(site["y"]), site["k"]
    c = site["x"][1]
    w = c * k * k
    flops = 2.0 * y * k * k
    if not backward:
        return float((x + y + w) * dtype_bytes), flops
    return float((x + y + w + x + w) * dtype_bytes), 2.0 * flops


def least_seconds(bytes_: float, flops: float, peak: dict) -> float:
    return max(bytes_ / peak["hbm_bytes_per_s"], flops / peak["fp32_flop_per_s"])


def depthwise_least_s(sites: list, train: bool) -> float:
    """The least time of every depthwise pass of one forward (and, in
    training, its backward), summed site by site."""
    peak, total = peaks(), 0.0
    for s in sites:
        total += least_seconds(*depthwise_pass(s, False), peak)
        if train:
            total += least_seconds(*depthwise_pass(s, True), peak)
    return total
