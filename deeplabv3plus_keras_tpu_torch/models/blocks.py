"""NN primitive blocks (port of ``deeplabv3plus_keras_tpu/models/blocks.py:32-284``).

Tensors are NCHW in ``channels_last`` memory.  Each module's parameter
names follow the flax tree, so ``utils/jax_weights.py`` maps one onto the
other mechanically:

- conv weights are torch's OIHW; depthwise weights (C, 1, k, k);
- ``BatchNorm`` holds ``weight`` (absent when ``scale=False``: fixed at 1),
  ``bias``, ``running_mean``, ``running_var``.

Numerics mirrored from the Keras reference:

- Keras ``BatchNormalization``: eps **1e-3** (torch's default is 1e-5);
  Keras momentum m is torch momentum 1 − m.
- Conv init glorot_uniform; the ASPP split-separable blocks use
  TruncatedNormal(σ=0.05) cut at ±2σ.  Both draw from an explicit
  ``torch.Generator``.  Fans are computed as flax computes them on the
  HWIO kernel, so the bounds match the JAX package's.
- Only the float path of ``QuantConv``: int8 serving is a later slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import depthwise_conv, same_pads


def glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Keras/flax glorot_uniform on an OIHW weight (fans of the HWIO kernel:
    fan_in = kh·kw·I, fan_out = kh·kw·O)."""
    rf = w.shape[2] * w.shape[3]
    limit = math.sqrt(6.0 / (rf * w.shape[1] + rf * w.shape[0]))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def truncated_normal_05_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``truncated_normal(stddev=0.05, lower=-2, upper=2)``: a standard
    normal cut at ±2, times 0.05 (no variance correction)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, 0.05, -0.1, 0.1, generator=generator)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def avg_pool_valid(x: torch.Tensor, pool_size: int) -> torch.Tensor:
    """Keras ``AveragePooling2D(pool_size, padding='valid')``: stride equal to
    the pool size, ragged edge dropped (sizes floor)."""
    return F.avg_pool2d(x, pool_size, stride=pool_size, padding=0, ceil_mode=False)


def tf_same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero-pad for TF ``SAME`` (asymmetric at stride 2: the extra row and
    column go after), so a following ``padding=0`` conv matches XLA."""
    _, pt, pb = same_pads(x.shape[-2], k, stride, 1)
    _, pl, pr = same_pads(x.shape[-1], k, stride, 1)
    return F.pad(x, (pl, pr, pt, pb))


class _Init:
    """Mixin: ``init_weights(generator)`` draws ``weight`` with ``init_fn``."""

    def init_weights(self, generator: torch.Generator) -> None:
        self.init_fn(self.weight, generator)


class Conv(_Init, nn.Module):
    """Bias-free k×k conv with TF ``SAME`` padding: flax ``nn.Conv(use_bias=
    False)`` and the float path of the JAX package's ``QuantConv``."""

    def __init__(self, cin: int, features: int, kernel: int = 1, strides: int = 1,
                 init_fn=glorot_uniform_):
        super().__init__()
        self.kernel, self.strides = kernel, strides
        self.init_fn = init_fn
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))

    def forward(self, x):
        if self.strides == 1:  # odd k: SAME is symmetric
            return F.conv2d(x, self.weight, padding=self.kernel // 2)
        return F.conv2d(tf_same_pad(x, self.kernel, self.strides), self.weight,
                        stride=self.strides)


class DepthwiseConv(_Init, nn.Module):
    """Depthwise k×k conv, no bias, TF ``SAME`` padding, routed through the
    hand-written kernel (``kernels/depthwise.py``) on the card."""

    def __init__(self, channels: int, kernel: int = 3, strides: int = 1,
                 dilation=(1, 1), init_fn=glorot_uniform_):
        super().__init__()
        self.strides = strides
        self.dilation = (int(dilation[0]), int(dilation[1]))
        self.init_fn = init_fn
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel, kernel))

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)  # no-op in the model
        return depthwise_conv(x, self.weight, self.strides, self.dilation)


class BatchNorm(nn.Module):
    """Keras-compatible BatchNormalization (eps 1e-3; ``scale=False`` leaves
    out the multiplicative weight, as Keras ``scale=False`` does)."""

    def __init__(self, channels: int, momentum: float = 0.99, epsilon: float = 1e-3,
                 scale: bool = True):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.register_parameter(
            "weight", nn.Parameter(torch.ones(channels)) if scale else None
        )
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            self.training, 1.0 - self.momentum, self.epsilon,
        )


class ConvBNReLU(nn.Module):
    """Conv(k, no bias) → BN → ReLU; ``l2`` names the conv ``conv_l2``."""

    def __init__(self, cin: int, features: int, kernel: int = 1, l2: bool = True,
                 bn_momentum: float = 0.99, bn_scale: bool = True):
        super().__init__()
        self.conv_name = "conv_l2" if l2 else "conv"
        self.add_module(self.conv_name, Conv(cin, features, kernel))
        self.bn = BatchNorm(features, bn_momentum, scale=bn_scale)

    def forward(self, x):
        return F.relu(self.bn(getattr(self, self.conv_name)(x)))


class SeparableConv(nn.Module):
    """Keras ``SeparableConv2D``: depthwise(k, dilation) → pointwise 1×1."""

    def __init__(self, cin: int, features: int, kernel: int = 3, dilation=(1, 1),
                 init_fn=glorot_uniform_):
        super().__init__()
        self.depthwise = DepthwiseConv(cin, kernel, 1, dilation, init_fn)
        self.pointwise = Conv(cin, features, 1, init_fn=init_fn)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class SplitSepConvBlock(nn.Module):
    """Encoder-middle 'conv' op with kernel > 1 (reference :823-840):
    SeparableConv(C, k, dilation)+BN+ReLU → 1×1 Conv(C, l2)+BN+ReLU, all
    kernels TruncatedNormal(0.05)."""

    def __init__(self, cin: int, features: int, kernel: int, dilation,
                 bn_momentum: float, bn_scale: bool):
        super().__init__()
        self.sepconv = SeparableConv(cin, features, kernel, dilation=dilation,
                                     init_fn=truncated_normal_05_)
        self.bn1 = BatchNorm(features, bn_momentum, scale=bn_scale)
        self.conv_l2 = Conv(features, features, 1, init_fn=truncated_normal_05_)
        self.bn2 = BatchNorm(features, bn_momentum, scale=bn_scale)

    def forward(self, x):
        x = F.relu(self.bn1(self.sepconv(x)))
        return F.relu(self.bn2(self.conv_l2(x)))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv weight of ``module`` in registration order."""
    for m in module.modules():
        if isinstance(m, _Init):
            m.init_weights(generator)
