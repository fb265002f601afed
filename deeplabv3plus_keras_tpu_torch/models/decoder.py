"""Decoder + boundary refinement (port of
``deeplabv3plus_keras_tpu/models/decoder.py:35-164``).

Boundary refinement: backbone features → 1×1 Conv(48, l2)+BN+ReLU; the
reference upsamples both streams ×(os/2), concatenates, and convolves
3×3 into the classes.  Here, as in the JAX package, the concat is taken at
low resolution and the ×(os/2) upsample is fused into the classifier conv
(``ops/fused_upconv``).  The classifier's single weight keeps the
reference's shape, (classes, 48 + C_enc, 3, 3).

Then bilinear ×os (×2 after refinement) and softmax over classes; or,
with ``return_presample``, the low-resolution logits and the factor, for
the fused upsample+argmax label kernel; or, with ``float32_tail``, the
upsample and softmax of 16-bit logits in float32, for the losses of the
train and eval steps (``parallel/step.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_upconv import upsample_conv3
from ..ops.resize import tf_resize_images, tf_resize_images_matmul
from .blocks import Conv, ConvBNReLU, _Init, conv2d_same, glorot_uniform_


class _RefinedClassifier(_Init, nn.Module):
    """upsample×half + 3×3 classifier over the CONCAT of the two refinement
    streams, as one composed transposed conv on the low-res concat
    (``fused``) or per stream, upsample then conv (the reference's
    two-step arithmetic, distributed over the concat)."""

    def __init__(self, c_low: int, c_enc: int, features: int, half: int, fused: bool = True):
        super().__init__()
        self.c_low, self.half, self.fused = c_low, half, fused
        self.init_fn = glorot_uniform_
        self.weight = nn.Parameter(torch.empty(features, c_low + c_enc, 3, 3))

    def forward(self, low, enc):
        w = self.weight.to(low.dtype)  # flax promote_dtype: the compute dtype
        if self.fused:
            x = torch.cat([low, enc], dim=1)
            return upsample_conv3(x, w, self.half)
        f = self.half
        out = conv2d_same(tf_resize_images(low, f, f), w[:, : self.c_low])
        return out + conv2d_same(tf_resize_images(enc, f, f), w[:, self.c_low :])


class Decoder(nn.Module):
    def __init__(self, base_channels: int, encoder_channels: int, num_classes: int,
                 output_stride: int, boundary_refinement: bool, bn_momentum: float,
                 bn_scale: bool, fused_upconv: bool = True):
        super().__init__()
        self.output_stride = output_stride
        self.boundary_refinement = boundary_refinement
        if boundary_refinement:
            self.refine_conv48 = ConvBNReLU(
                base_channels, 48, 1, bn_momentum=bn_momentum, bn_scale=bn_scale
            )
            self.classifier_l2 = _RefinedClassifier(
                48, encoder_channels, num_classes, output_stride // 2, fused_upconv
            )
        else:
            self.classifier_l2 = Conv(encoder_channels, num_classes, 3)

    def forward(self, base_features, encoder_features, return_presample: bool = False,
                float32_tail: bool = False):
        x = encoder_features
        if self.boundary_refinement:
            low = self.refine_conv48(base_features)
            x = self.classifier_l2(low, x)
        else:
            x = self.classifier_l2(x)

        up = self.output_stride
        if self.boundary_refinement:
            up = up // 8 if up == 16 else up // 4  # → ×2 either way (reference :899-902)
        if return_presample:
            return x, up
        if float32_tail and x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        # the JAX package's per-dtype choice of the final upsample form: the
        # matmul form in float32/float64, ``tf_resize_images`` in
        # bfloat16/float16 (whose roundings are the matmul form's there)
        if x.dtype in (torch.float32, torch.float64):
            x = tf_resize_images_matmul(x, up, up)
        else:
            x = tf_resize_images(x, up, up)
        return softmax(x, dim=1)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``: in bfloat16/float16, exp(x − max) in the dtype,
    its sum accumulated in float32 and cast back (``jnp.sum`` upcasts half
    types), the division in the dtype; ``torch.softmax`` otherwise.  The
    max carries no gradient, as JAX stops it: its gradient, zero in exact
    arithmetic, is a 16-bit rounding residual that would land on the
    leading class."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True, dtype=torch.float32).to(x.dtype)
