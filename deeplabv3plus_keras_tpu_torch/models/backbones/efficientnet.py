"""EfficientNet B0–B7 backbones, truncated at the reference's cut points
(port of ``deeplabv3plus_keras_tpu/models/backbones/efficientnet.py:1-212``).

Keras ``EfficientNetB{0..7}`` cut at the last block of stage 3 (output
stride 8: ``block3?_add``) or stage 5 (output stride 16: ``block5?_add``).
The Keras application normalises its own input: ``Rescaling(1/255)`` and a
``Normalization`` layer whose mean and variance are weights (zero and one
when random), so the reference's (−1, 1) images are normalised a second
time.  That prologue runs in the images' dtype (float32), before the stem
conv casts to the compute dtype, as in the JAX package; the statistics
are the buffers ``normalization_mean``/``normalization_var`` (the JAX
``batch_stats``).

Stem: ``round_filters(32)`` 3×3 stride 2 + BN + swish.  MBConv: expand
1×1 (ratio 6; stage 1: none) + BN + swish → depthwise k×k (stride) + BN +
swish → squeeze-excite (mean → 1×1 conv with bias → swish → 1×1 conv with
bias → sigmoid gate; bottleneck 0.25 of the block's *input* filters) →
project 1×1 + BN → stochastic depth and the residual add when the shape
is kept.  The drop rate grows with the block index, ``drop_connect_rate``
× index / blocks (0.2, the JAX module's attribute); the masks come from the
step's ``torch.Generator``.  BN momentum 0.99, eps 1e-3; widths rounded to
a multiple of 8.  Depthwise sites: k = 3 and k = 5, stride 1 and 2.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...parallel import spatial
from ..blocks import (
    BatchNorm,
    Conv,
    DepthwiseConv,
    QuantConv,
    Dropout,
    efficientnet_conv_init_,
    sigmoid,
    swish,
)

# (width_coefficient, depth_coefficient) per variant
_VARIANTS = {
    "efficientnetb0": (1.0, 1.0),
    "efficientnetb1": (1.0, 1.1),
    "efficientnetb2": (1.1, 1.2),
    "efficientnetb3": (1.2, 1.4),
    "efficientnetb4": (1.4, 1.8),
    "efficientnetb5": (1.6, 2.2),
    "efficientnetb6": (1.8, 2.6),
    "efficientnetb7": (2.0, 3.1),
}

# (kernel, base_repeats, base_filters_out, stride, expand_ratio)
_STAGES = [
    (3, 1, 16, 1, 1),
    (3, 2, 24, 2, 6),
    (5, 2, 40, 2, 6),
    (3, 3, 80, 2, 6),
    (5, 3, 112, 1, 6),
    (5, 4, 192, 2, 6),
    (3, 1, 320, 1, 6),
]


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


class MBConv(nn.Module):
    """expand → depthwise k×k → SE → project → stochastic depth + add."""

    def __init__(self, cin: int, features_out: int, kernel: int, strides: int,
                 expand_ratio: int, drop_rate: float = 0.0, se_ratio: float = 0.25):
        super().__init__()
        init = efficientnet_conv_init_
        expanded = cin * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand_conv = QuantConv(cin, expanded, 1, init_fn=init)
            self.expand_bn = BatchNorm(expanded)
        self.dwconv = DepthwiseConv(expanded, kernel, strides, init_fn=init)
        self.bn = BatchNorm(expanded)
        se_filters = max(1, int(cin * se_ratio))
        self.se_reduce = Conv(expanded, se_filters, 1, init_fn=init, bias=True)
        self.se_expand = Conv(se_filters, expanded, 1, init_fn=init, bias=True)
        self.project_conv = QuantConv(expanded, features_out, 1, init_fn=init)
        self.project_bn = BatchNorm(features_out)
        self.residual = strides == 1 and cin == features_out
        self.drop = Dropout(drop_rate, per_sample=True) if self.residual else None

    def forward(self, x, generator: torch.Generator | None = None):
        inputs = x
        if self.has_expand:
            x = swish(self.expand_bn(self.expand_conv(x)))
        x = swish(self.bn(self.dwconv(x)))
        # under mesh_space the whole image's mean on every rank, and the
        # two 1x1 convs on that replicated (B, C, 1, 1) as one process runs them
        se = spatial.mean_hw(x)
        with spatial.local():
            se = self.se_expand(swish(self.se_reduce(se)))
        x = x * sigmoid(se)
        x = self.project_bn(self.project_conv(x))
        if self.residual:
            x = self.drop(x, generator) + inputs
        return x


class EfficientNetBackbone(nn.Module):
    """Truncated EfficientNet: stages 1–3 (output stride 8) or 1–5 (16),
    (B, 3, S, S) → (B, C, S/os, S/os).  ``dtype``: the compute dtype the
    stem conv casts the normalised images to (None: theirs); the model
    hands this backbone its images uncast (``casts_images``), where it
    casts them for the others."""

    casts_images = True

    def __init__(self, variant: str = "efficientnetb0", output_stride: int = 16,
                 dtype: torch.dtype | None = None, drop_connect_rate: float = 0.2):
        super().__init__()
        width, depth = _VARIANTS[variant]
        self.dtype = dtype
        self.register_buffer("normalization_mean", torch.zeros(3))
        self.register_buffer("normalization_var", torch.ones(3))
        self.stem_conv = Conv(3, round_filters(32, width), 3, strides=2,
                              init_fn=efficientnet_conv_init_)
        self.stem_bn = BatchNorm(round_filters(32, width))
        last_stage = 3 if output_stride == 8 else 5
        total = sum(round_repeats(r, depth) for _, r, _, _, _ in _STAGES)
        cin, index = round_filters(32, width), 0
        self.blocks = []
        for stage, (k, base_r, base_f, stride, expand) in enumerate(_STAGES[:last_stage], start=1):
            fout = round_filters(base_f, width)
            for r in range(round_repeats(base_r, depth)):
                name = f"block{stage}{chr(ord('a') + r)}"
                self.add_module(name, MBConv(cin, fout, k, stride if r == 0 else 1, expand,
                                             drop_connect_rate * index / total))
                self.blocks.append(name)
                cin, index = fout, index + 1
        self.out_channels = cin

    def forward(self, x, generator: torch.Generator | None = None):
        x = x / 255.0
        x = (x - self.normalization_mean[:, None, None]) / torch.sqrt(
            self.normalization_var[:, None, None] + 1e-7)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = swish(self.stem_bn(self.stem_conv(x)))
        for name in self.blocks:
            x = getattr(self, name)(x, generator)
        return x

    @staticmethod
    def feature_channels(variant: str, output_stride: int) -> int:
        return round_filters(40 if output_stride == 8 else 112, _VARIANTS[variant][0])


EFFICIENTNET_VARIANTS = tuple(_VARIANTS)
