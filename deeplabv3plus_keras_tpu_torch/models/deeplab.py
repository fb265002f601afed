"""Full DeepLabV3+ model: backbone → encoder middle (ASPP DAG) → decoder
(port of ``deeplabv3plus_keras_tpu/models/deeplab.py:28-105``).

The public layout is the JAX package's: images (B, S, S, 3) NHWC in
(−1, 1) in, NHWC probabilities (B, S, S, classes) out (or NHWC
pre-upsample logits and the upsample factor).  Inside, tensors are NCHW
in ``channels_last`` memory, which is physically NHWC: the permutes at
the two ends are views, not copies.  The backbone runs once and feeds
both the encoder and the boundary refinement, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from .backbones import get_backbone
from .blocks import init_weights
from .decoder import Decoder
from .encoder import EncoderMiddle


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Model outputs are ≥fp32: bf16/f16 compute upcasts, f64 passes through."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class DeepLabV3Plus(nn.Module):
    """conf: the full Config (hps + nn_arch drive every knob)."""

    def __init__(self, conf: Config):
        super().__init__()
        arch, hps = conf.nn_arch, conf.hps
        self.base = get_backbone(conf.base_model, arch.output_stride)
        self.encoder = EncoderMiddle(
            self.base.out_channels,
            arch.encoder_middle_conf,
            reduction_size=arch.reduction_size,
            concat_channels=arch.concat_channels,
            conv_rate_multiplier=arch.conv_rate_multiplier,
            dropout_rate=arch.dropout_rate,
            bn_momentum=hps.bn_momentum,
            bn_scale=hps.bn_scale,
        )
        self.decoder = Decoder(
            self.base.out_channels,
            arch.concat_channels,
            num_classes=arch.num_classes,
            output_stride=arch.output_stride,
            boundary_refinement=arch.boundary_refinement,
            bn_momentum=hps.bn_momentum,
            bn_scale=hps.bn_scale,
            fused_upconv=bool(conf.extra.get("fused_upconv", True)),
        )

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every conv weight from ``generator``; BN starts at identity."""
        init_weights(self, generator)

    def forward(self, images: torch.Tensor, return_presample: bool = False,
                generator: torch.Generator | None = None):
        """``generator`` draws the dropout mask in training (required there
        when the dropout rate is above 0)."""
        dtype = next(self.parameters()).dtype
        x = images.to(dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view
        x = x.contiguous(memory_format=torch.channels_last)
        base_features = self.base(x)
        encoder_features = self.encoder(base_features, generator)
        if return_presample:
            logits, up = self.decoder(base_features, encoder_features, return_presample=True)
            return _at_least_f32(logits.permute(0, 2, 3, 1)), up
        probs = self.decoder(base_features, encoder_features)
        return _at_least_f32(probs.permute(0, 2, 3, 1))
