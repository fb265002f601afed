"""Xception backbone (ImageNet topology), truncated at the reference's
output-stride cuts (port of
``deeplabv3plus_keras_tpu/models/backbones/xception.py:30-123``).

Entry flow: conv 32×3×3 stride 2 and conv 64×3×3, both ``VALID`` (512 →
255 → 253), each BN+ReLU; then three residual blocks (128, 256, 728) of
two separable convs and a 3×3 stride-2 ``SAME`` max-pool, with 1×1
stride-2 conv shortcuts.  Middle flow: 8 blocks of 3×(ReLU → sepconv 728
→ BN) with identity residuals.  Exit: ReLU → sepconv 728 → BN → ReLU →
sepconv 1024 → BN.  BN momentum 0.99, eps 1e-3; convs glorot_uniform.
Every depthwise site is 3×3, stride 1, dilation 1: the sites the
channels-first kernels take under ``DLV3_DW_LAYOUT=bhcw``.

Cut ``block4_sepconv2_bn`` → 728 channels at stride 8 (output_stride 8),
before block 4's pool and residual; cut ``block13_sepconv2_bn`` → 1024
channels at stride 16 (output_stride 16), before block 13's pool.
Submodule names follow the flax tree (Keras layer names, ``conv2d_*`` and
``batch_normalization_*`` for the shortcuts).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNorm, Conv, SeparableConv, max_pool_same

_BN_MOMENTUM = 0.99


class XceptionBackbone(nn.Module):
    """Truncated Xception feature extractor, (B, 3, S, S) → (B, C, ~S/os, ~S/os)."""

    def __init__(self, output_stride: int = 16):
        super().__init__()
        self.output_stride = output_stride
        self.block1_conv1 = Conv(3, 32, 3, strides=2, padding="VALID")
        self.block1_conv1_bn = BatchNorm(32, _BN_MOMENTUM)
        self.block1_conv2 = Conv(32, 64, 3, padding="VALID")
        self.block1_conv2_bn = BatchNorm(64, _BN_MOMENTUM)
        # the residual blocks 2-4: (shortcut names, block, in, out channels)
        self.entry = []
        for i, (b, cin, cout) in enumerate(((2, 64, 128), (3, 128, 256), (4, 256, 728))):
            suffix = f"_{i}" if i else ""
            self.add_module(f"conv2d{suffix}", Conv(cin, cout, 1, strides=2))
            self.add_module(f"batch_normalization{suffix}", BatchNorm(cout, _BN_MOMENTUM))
            self._sepconv(b, 1, cin, cout)
            self._sepconv(b, 2, cout, cout)
            self.entry.append((b, f"conv2d{suffix}", f"batch_normalization{suffix}"))
        if output_stride != 8:
            for b in range(5, 13):
                for s in range(1, 4):
                    self._sepconv(b, s, 728, 728)
            self._sepconv(13, 1, 728, 728)
            self._sepconv(13, 2, 728, 1024)
        self.out_channels = 728 if output_stride == 8 else 1024

    def _sepconv(self, block: int, i: int, cin: int, cout: int) -> None:
        name = f"block{block}_sepconv{i}"
        self.add_module(name, SeparableConv(cin, cout, 3))
        self.add_module(f"{name}_bn", BatchNorm(cout, _BN_MOMENTUM))

    def _sep(self, x, block: int, i: int):
        name = f"block{block}_sepconv{i}"
        return getattr(self, f"{name}_bn")(getattr(self, name)(x))

    def forward(self, x):
        x = F.relu(self.block1_conv1_bn(self.block1_conv1(x)))
        x = F.relu(self.block1_conv2_bn(self.block1_conv2(x)))

        for b, conv, bn in self.entry:
            res = getattr(self, bn)(getattr(self, conv)(x))
            if b > 2:  # blocks 3 and 4 start with a ReLU, block 2 does not
                x = F.relu(x)
            x = self._sep(F.relu(self._sep(x, b, 1)), b, 2)
            if b == 4 and self.output_stride == 8:
                # the cut: block 4's shortcut is computed, as in the flax
                # module (so its BN statistics move in training), and unused
                return x
            x = max_pool_same(x, 3, 2) + res

        for b in range(5, 13):
            res = x
            for s in range(1, 4):
                x = self._sep(F.relu(x), b, s)
            x = x + res

        x = self._sep(F.relu(x), 13, 1)
        return self._sep(F.relu(x), 13, 2)
