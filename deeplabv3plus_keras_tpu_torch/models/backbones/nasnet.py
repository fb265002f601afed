"""NASNet-A Mobile and Large backbones, truncated at the reference's cut
points (port of ``deeplabv3plus_keras_tpu/models/backbones/nasnet.py:1-260``).

Keras ``NASNetMobile``/``NASNetLarge`` cut at ``activation_73``/``_132``
(Mobile) and ``activation_97``/``_180`` (Large): the ReLU at the head of
the ``reduction_right1`` branch of the reduction cell ``reduce_N`` (output
stride 8) or ``reduce_2N`` (16), i.e. relu of that cell's adjusted
previous-path tensor, with 2·f or 4·f channels.

Wiring: stem 3×3 stride 2 ``VALID`` conv + BN (momentum 0.9997, eps
1e-3); two stem reduction cells at f/4 and f/2 filters; N normal cells
(f), a reduction (2f), N normal cells (2f), the cut in the last
reduction (4f).  Mobile: stem 32, f = 1056/24 = 44, N = 4; Large: stem 96,
f = 4032/24 = 168, N = 6, and after ``reduce_N`` it keeps the previous
path from before the reduction (``skip_reduction``).  A separable block is
[relu → depthwise k (stride) → pointwise 1×1 → BN] twice, the second at
stride 1; depthwise sites k = 3, 5, 7 at strides 1 and 2, on channel
counts (11, 22 in Mobile's stem cells) that are not multiples of 4.

Which adjustment a cell's previous path gets (a strided pair of 1×1 convs
when it is at twice the resolution, a 1×1 projection when its width is
not the cell's, none) follows from the wiring, so each cell is built
knowing (level, channels) of its two inputs.  The strided path's
one-pixel subsample is a 1×1 conv at stride 2, and its one-pixel shift a
slice and a zero pad before it, which keeps every tensor ``channels_last``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import spatial
from ..blocks import (
    BatchNorm,
    Conv,
    DepthwiseConv,
    QuantConv,
    avg_pool_same_s1,
    he_normal_,
    pool_s2_keras,
)

_BN_MOM = 0.9997
_BN_EPS = 1e-3


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, _BN_MOM, _BN_EPS)


def _conv1x1(cin: int, features: int, strides: int = 1, cls=Conv) -> Conv:
    return cls(cin, features, 1, strides=strides, init_fn=he_normal_, padding="VALID")


class _SepBlock(nn.Module):
    """[relu → depthwise(k, stride) → pointwise 1×1 → BN] ×2, the second at
    stride 1 (Keras ``_separable_conv_block``)."""

    def __init__(self, cin: int, filters: int, kernel: int = 3, strides: int = 1):
        super().__init__()
        for i, (c, s) in ((1, (cin, strides)), (2, (filters, 1))):
            self.add_module(f"separable_conv_{i}_depthwise",
                            DepthwiseConv(c, kernel, s, init_fn=he_normal_))
            self.add_module(f"separable_conv_{i}_pointwise", _conv1x1(c, filters, cls=QuantConv))
            self.add_module(f"separable_conv_{i}_bn", _bn(filters))

    def forward(self, x):
        for i in (1, 2):
            x = getattr(self, f"separable_conv_{i}_depthwise")(F.relu(x))
            x = getattr(self, f"separable_conv_{i}_bn")(getattr(self, f"separable_conv_{i}_pointwise")(x))
        return x


class _Adjust(nn.Module):
    """Match the previous path p to the cell input ip (Keras
    ``_adjust_block``).  ``p``, ``ip``: (level, channels) of each; a level
    is a halving of the resolution."""

    def __init__(self, filters: int, p, ip):
        super().__init__()
        if p is None:
            self.mode, self.out_channels = "none", ip[1]
        elif p[0] != ip[0]:
            self.mode, self.out_channels = "strided", filters // 2 * 2
            self.adjust_conv_1 = _conv1x1(p[1], filters // 2, strides=2)
            self.adjust_conv_2 = _conv1x1(p[1], filters // 2, strides=2)
            self.adjust_bn = _bn(self.out_channels)
        elif p[1] != filters:
            self.mode, self.out_channels = "project", filters
            self.adjust_conv_projection = _conv1x1(p[1], filters)
            self.adjust_bn = _bn(filters)
        else:
            self.mode, self.out_channels = "identity", p[1]

    def forward(self, p, ip):
        if self.mode == "none":
            return ip
        if self.mode == "strided":
            p = F.relu(p)
            # p[::2, ::2], and the same one pixel down and right (zero
            # past the edge), each through its 1×1 conv
            p1 = self.adjust_conv_1(p)
            return self.adjust_bn(torch.cat([p1, self._shifted(p)], 1))
        if self.mode == "project":
            return self.adjust_bn(self.adjust_conv_projection(F.relu(p)))
        return p

    def _shifted(self, p):
        """``adjust_conv_2`` of p one pixel down and right, zero past the
        edge.  Under ``mesh_space`` output row i reads global row 2i + 1:
        a 2-row window at stride 2 whose second row is the one taken (the
        first row of the next rank's, or zero below the image)."""
        def shift(t):
            return self.adjust_conv_2(F.pad(t[:, :, 1:, 1:], (0, 1, 0, 1)))

        if not spatial.active():
            return shift(p)
        w = self.adjust_conv_2.weight
        return spatial.window_op(p, shift, k=2, stride=2, pads_h=(0, 1),
                                 out_width=(p.shape[-1] + 1) // 2, out_channels=w.shape[0],
                                 deps=(w,))


class _NormalCell(nn.Module):
    def __init__(self, filters: int, x, p):
        super().__init__()
        self.adjust = _Adjust(filters, p, x)
        pc = self.adjust.out_channels
        self.normal_conv_1 = _conv1x1(x[1], filters)
        self.normal_bn_1 = _bn(filters)
        self.normal_left1 = _SepBlock(filters, filters, 5)
        self.normal_right1 = _SepBlock(pc, filters, 3)
        self.normal_left2 = _SepBlock(pc, filters, 5)
        self.normal_right2 = _SepBlock(pc, filters, 3)
        self.normal_left5 = _SepBlock(filters, filters, 3)
        self.out = (x[0], pc + 5 * filters)

    def forward(self, x, p):
        ip = x
        p = self.adjust(p, ip)
        h = self.normal_bn_1(self.normal_conv_1(F.relu(ip)))
        x1 = self.normal_left1(h) + self.normal_right1(p)
        x2 = self.normal_left2(p) + self.normal_right2(p)
        x3 = avg_pool_same_s1(h) + p
        avg_p = avg_pool_same_s1(p)
        x4 = avg_p + avg_p
        x5 = self.normal_left5(h) + h
        # x3, x4 are float32 in a 16-bit model (the pool's quotient), and so
        # is flax's concatenation until the next conv rounds it: rounded
        # here instead, which every consumer (relu → conv) leaves equal
        return torch.cat([p, x1, x2, x3, x4, x5], 1).to(ip.dtype), ip


class _ReductionCell(nn.Module):
    """``cut``: the reference's truncation, relu of the adjusted p (the
    ``reduction_right1`` branch's first ReLU); only the adjustment is
    built."""

    def __init__(self, filters: int, x, p, cut: bool = False):
        super().__init__()
        self.cut = cut
        self.adjust = _Adjust(filters, p, x)
        pc = self.adjust.out_channels
        if cut:
            self.out = (x[0], pc)
            return
        self.reduction_conv_1 = _conv1x1(x[1], filters)
        self.reduction_bn_1 = _bn(filters)
        self.reduction_left1 = _SepBlock(filters, filters, 5, 2)
        self.reduction_right1 = _SepBlock(pc, filters, 7, 2)
        self.reduction_right2 = _SepBlock(pc, filters, 7, 2)
        self.reduction_right3 = _SepBlock(pc, filters, 5, 2)
        self.reduction_left4 = _SepBlock(filters, filters, 3, 1)
        self.out = (x[0] + 1, 4 * filters)

    def forward(self, x, p):
        ip = x
        p = self.adjust(p, ip)
        if self.cut:
            return F.relu(p), ip
        h = self.reduction_bn_1(self.reduction_conv_1(F.relu(ip)))
        max_h = pool_s2_keras(h, 3, "max")
        x1 = self.reduction_left1(h) + self.reduction_right1(p)
        x2 = max_h + self.reduction_right2(p)
        x3 = pool_s2_keras(h, 3, "avg") + self.reduction_right3(p)
        x4 = avg_pool_same_s1(x1) + x2
        x5 = self.reduction_left4(x1) + max_h
        return torch.cat([x2, x3, x4, x5], 1).to(ip.dtype), ip  # as the normal cell


_VARIANTS = {
    "nasnetmobile": dict(stem_filters=32, penultimate=1056, num_blocks=4, skip_reduction=False),
    "nasnetlarge": dict(stem_filters=96, penultimate=4032, num_blocks=6, skip_reduction=True),
}


class NASNetBackbone(nn.Module):
    """Truncated NASNet-A, (B, 3, S, S) → (B, C, ~S/os, ~S/os)."""

    def __init__(self, variant: str = "nasnetmobile", output_stride: int = 16):
        super().__init__()
        cfg = _VARIANTS[variant]
        f, n = cfg["penultimate"] // 24, cfg["num_blocks"]
        self.stem_conv1 = Conv(3, cfg["stem_filters"], 3, strides=2, init_fn=he_normal_,
                               padding="VALID")
        self.stem_bn1 = _bn(cfg["stem_filters"])
        # (name, whether the cell's input becomes the next previous path)
        plan = [("stem_1", _ReductionCell, f // 4, True), ("stem_2", _ReductionCell, f // 2, True)]
        plan += [(f"cell_{i}", _NormalCell, f, True) for i in range(n)]
        if output_stride != 8:
            plan.append((f"reduce_{n}", _ReductionCell, 2 * f, not cfg["skip_reduction"]))
            plan += [(f"cell_{n + i + 1}", _NormalCell, 2 * f, True) for i in range(n)]
        self.cells = []
        x, p = (1, cfg["stem_filters"]), None
        for name, cls, filters, keep_p in plan:
            cell = cls(filters, x, p)
            self.add_module(name, cell)
            self.cells.append((name, keep_p))
            x, p = cell.out, (x if keep_p else p)
        last = n if output_stride == 8 else 2 * n
        self.cut_name = f"reduce_{last}"
        self.add_module(self.cut_name, _ReductionCell((2 if output_stride == 8 else 4) * f, x, p,
                                                      cut=True))
        self.out_channels = getattr(self, self.cut_name).out[1]

    def forward(self, x, generator: torch.Generator | None = None):
        x, p = self.stem_bn1(self.stem_conv1(x)), None
        *cells, (last, _) = self.cells
        for name, keep_p in cells:
            x, ip = getattr(self, name)(x, p)
            if keep_p:
                p = ip
        # The cut reads only the last normal cell's input.  The cell itself
        # runs in training, for its BN statistics, as in the JAX module; out
        # of training nothing reads it, and XLA drops it from a jitted
        # inference, so it is skipped.
        if self.training:
            getattr(self, last)(x, p)
        return getattr(self, self.cut_name)(None, x)[0]

    @staticmethod
    def feature_channels(variant: str, output_stride: int) -> int:
        f = _VARIANTS[variant]["penultimate"] // 24
        return 2 * f if output_stride == 8 else 4 * f


NASNET_VARIANTS = tuple(_VARIANTS)
