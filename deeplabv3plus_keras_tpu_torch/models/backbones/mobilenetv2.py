"""MobileNetV2 backbone (ImageNet topology, alpha=1.0), truncated at the
reference's output-stride cuts (port of
``deeplabv3plus_keras_tpu/models/backbones/mobilenetv2.py:35-136``).

Stem Conv 32×3×3 s2 + BN(momentum .999, eps 1e-3) + ReLU6, then inverted
residual blocks (expand 6×, depthwise 3×3, linear project).  The Keras
application pads stride-2 convs with ``correct_pad`` + VALID, which is TF
``SAME``: on an even size the extra row/column goes after, so the stem
pads explicitly and the depthwise kernel takes the same pads.

Cut 'block_5_add'  → 32 channels at stride 8 (output_stride 8);
cut 'block_12_add' → 96 channels at stride 16 (output_stride 16).
Submodule names follow the Keras layer names, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from ..blocks import BatchNorm, Conv, DepthwiseConv, relu6

_BN_MOMENTUM = 0.999
_BN_EPS = 1e-3


class InvertedResidual(nn.Module):
    """expand(1×1) → depthwise(3×3, stride) → project(1×1, linear)."""

    def __init__(self, cin: int, features: int, strides: int = 1, expand_ratio: int = 6):
        super().__init__()
        mid = cin * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand = Conv(cin, mid, 1)
            self.expand_BN = BatchNorm(mid, _BN_MOMENTUM, _BN_EPS)
        self.depthwise = DepthwiseConv(mid, 3, strides)
        self.depthwise_BN = BatchNorm(mid, _BN_MOMENTUM, _BN_EPS)
        self.project = Conv(mid, features, 1)
        self.project_BN = BatchNorm(features, _BN_MOMENTUM, _BN_EPS)
        self.residual = strides == 1 and cin == features

    def forward(self, x):
        inputs = x
        if self.has_expand:
            x = relu6(self.expand_BN(self.expand(x)))
        x = relu6(self.depthwise_BN(self.depthwise(x)))
        x = self.project_BN(self.project(x))
        return x + inputs if self.residual else x


# (features, stride, expand_ratio) per block, Keras block_1..block_16.
_BLOCK_PLAN = [
    (24, 2, 6), (24, 1, 6),                     # block_1, block_2
    (32, 2, 6), (32, 1, 6), (32, 1, 6),         # block_3..block_5   ← os8 cut
    (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6),   # block_6..block_9
    (96, 1, 6), (96, 1, 6), (96, 1, 6),         # block_10..block_12 ← os16 cut
    (160, 2, 6), (160, 1, 6), (160, 1, 6),      # block_13..block_15
    (320, 1, 6),                                # block_16
]


class MobileNetV2Backbone(nn.Module):
    """Truncated MobileNetV2 feature extractor, (B, 3, S, S) → (B, C, S/os, S/os).

    output_stride 8 → through block_5 (32 ch); 16 → through block_12 (96 ch).
    """

    def __init__(self, output_stride: int = 16):
        super().__init__()
        self.Conv1 = Conv(3, 32, 3, strides=2)
        self.bn_Conv1 = BatchNorm(32, _BN_MOMENTUM, _BN_EPS)
        self.expanded_conv = InvertedResidual(32, 16, strides=1, expand_ratio=1)
        last_block = 5 if output_stride == 8 else 12
        cin = 16
        self.blocks = []
        for i, (feat, stride, t) in enumerate(_BLOCK_PLAN[:last_block], start=1):
            self.add_module(f"block_{i}", InvertedResidual(cin, feat, stride, t))
            self.blocks.append(f"block_{i}")
            cin = feat
        self.out_channels = cin

    def forward(self, x, generator: torch.Generator | None = None):
        x = relu6(self.bn_Conv1(self.Conv1(x)))
        x = self.expanded_conv(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x
