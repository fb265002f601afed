"""DenseNet-121/169/201 backbones, truncated at the reference's cut points
(port of ``deeplabv3plus_keras_tpu/models/backbones/densenet.py:1-117``).

Keras ``DenseNet{121,169,201}`` cut at ``pool3_conv`` (output stride 8)
or ``pool4_conv`` (16): the 1×1 conv inside the third or fourth
transition, before its stride-2 average pool.

Stem: ``ZeroPadding2D(3)`` + 7×7 stride 2 conv(64) + BN + ReLU, then
``ZeroPadding2D(1)`` + 3×3 stride 2 max pool (zero pads, not TF ``SAME``).
Dense blocks of (6, 12, 24|32|48, 16|32|32) layers, growth 32; a layer is
BN → ReLU → 1×1 conv(128) → BN → ReLU → 3×3 conv(32), concatenated to its
input; a transition is BN → ReLU → 1×1 conv(C/2) → 2×2 stride 2 average
pool.  BN momentum 0.99, eps 1.001e-5; convs glorot_uniform.  No
depthwise site: only the ASPP's and K1 run the port's kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNorm, Conv, QuantConv, avg_pool_valid, pool_zero_padded

_BN_EPS = 1.001e-5

_BLOCKS = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, epsilon=_BN_EPS)


class DenseLayer(nn.Module):
    """Submodules ``0_bn``, ``1_conv``, ``1_bn``, ``2_conv`` (the flax and
    Keras names)."""

    def __init__(self, cin: int, growth_rate: int = 32):
        super().__init__()
        self.add_module("0_bn", _bn(cin))
        self.add_module("1_conv", QuantConv(cin, 4 * growth_rate, 1))
        self.add_module("1_bn", _bn(4 * growth_rate))
        self.add_module("2_conv", Conv(4 * growth_rate, growth_rate, 3))

    def forward(self, x):
        m = self._modules
        y = m["1_conv"](F.relu(m["0_bn"](x)))
        y = m["2_conv"](F.relu(m["1_bn"](y)))
        return torch.cat([x, y], 1)


class DenseNetBackbone(nn.Module):
    """Truncated DenseNet, (B, 3, S, S) → (B, C, S/os, S/os)."""

    def __init__(self, variant: str = "densenet121", output_stride: int = 16):
        super().__init__()
        self.conv1_conv = Conv(3, 64, 7, strides=2, padding=((3, 3), (3, 3)))
        self.conv1_bn = _bn(64)
        last = 3 if output_stride == 8 else 4
        self.stages = []  # (dense layer names, transition index)
        c = 64
        for bi, n_layers in enumerate(_BLOCKS[variant][:last - 1], start=2):
            names = []
            for li in range(1, n_layers + 1):
                names.append(f"conv{bi}_block{li}")
                self.add_module(names[-1], DenseLayer(c))
                c += 32
            self.add_module(f"pool{bi}_bn", _bn(c))
            self.add_module(f"pool{bi}_conv", QuantConv(c, c // 2, 1))
            c //= 2
            self.stages.append((names, bi))
        self.last = last
        self.out_channels = c

    def forward(self, x, generator: torch.Generator | None = None):
        x = F.relu(self.conv1_bn(self.conv1_conv(x)))
        x = pool_zero_padded(x, 3, ((1, 1), (1, 1)), "max")
        for names, t in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            x = getattr(self, f"pool{t}_conv")(F.relu(getattr(self, f"pool{t}_bn")(x)))
            if t == self.last:
                return x  # the pre-pool cut (pool3_conv / pool4_conv)
            x = avg_pool_valid(x, 2)
        raise AssertionError("cut point not reached")

    @staticmethod
    def feature_channels(variant: str, output_stride: int) -> int:
        c = 64
        for bi, n_layers in enumerate(_BLOCKS[variant], start=2):
            c += n_layers * 32
            if bi == (3 if output_stride == 8 else 4):
                return c // 2
            c //= 2
        raise AssertionError


DENSENET_VARIANTS = tuple(_BLOCKS)
