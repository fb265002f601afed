"""Encoder middle: config-driven ASPP DAG interpreter (port of
``deeplabv3plus_keras_tpu/models/encoder.py:30-101``).

Each entry of ``encoder_middle_conf`` builds a branch whose input is the
backbone output (``input: -1``) or an earlier branch (``input: k``):

- ``conv`` kernel=1 → 1×1 Conv(reduction_size, l2)+BN+ReLU;
- ``conv`` kernel>1 → split separable block, dilation rate×conv_rate_multiplier;
- ``pyramid_pooling`` → AvgPool(kernel, valid) → 1×1 Conv(l2)+BN+ReLU →
  bilinear ×target_size_factor.

Branch outputs are concatenated, Dropout(dropout_rate) (identity in eval),
then 1×1 Conv(concat_channels, l2)+BN+ReLU.  Training draws the dropout
mask from the ``torch.Generator`` the caller hands in (the train step
seeds one from (seed, step), as the JAX step folds the step into its key);
it never draws from torch's global generator.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import MiddleOp
from ..ops.resize import tf_resize_images_matmul
from .blocks import ConvBNReLU, Dropout, SplitSepConvBlock, avg_pool_valid


class EncoderMiddle(nn.Module):
    def __init__(self, in_channels: int, middle_conf: Sequence[MiddleOp],
                 reduction_size: int, concat_channels: int,
                 conv_rate_multiplier: int, dropout_rate: float,
                 bn_momentum: float, bn_scale: bool):
        super().__init__()
        self.middle_conf = tuple(middle_conf)
        bn = dict(bn_momentum=bn_momentum, bn_scale=bn_scale)
        self.branch_names = []
        width = []
        for i, op in enumerate(self.middle_conf):
            cin = in_channels if op.input == -1 else width[op.input]
            if op.op == "conv" and op.kernel == 1:
                name, m = f"branch{i}_conv1x1", ConvBNReLU(cin, reduction_size, 1, **bn)
            elif op.op == "conv":
                dil = (op.rate[0] * conv_rate_multiplier, op.rate[1] * conv_rate_multiplier)
                name = f"branch{i}_sep"
                m = SplitSepConvBlock(cin, reduction_size, op.kernel, dil, **bn)
            elif op.op == "pyramid_pooling":
                name, m = f"branch{i}_pool_conv", ConvBNReLU(cin, reduction_size, 1, **bn)
            else:
                raise ValueError(f"Invalid operation. (op={op.op!r})")
            self.add_module(name, m)
            self.branch_names.append(name)
            width.append(reduction_size)
        self.dropout = Dropout(dropout_rate)
        self.projection = ConvBNReLU(sum(width), concat_channels, 1, **bn)

    def forward(self, base_features, generator: torch.Generator | None = None):
        branches = []
        for op, name in zip(self.middle_conf, self.branch_names):
            x = base_features if op.input == -1 else branches[op.input]
            if op.op == "pyramid_pooling":
                x = avg_pool_valid(x, op.kernel)
                x = getattr(self, name)(x)
                x = tf_resize_images_matmul(
                    x, op.target_size_factor[0], op.target_size_factor[1]
                ).contiguous(memory_format=torch.channels_last)
            else:
                x = getattr(self, name)(x)
            branches.append(x)
        x = self.dropout(torch.cat(branches, dim=1), generator)
        return self.projection(x)
