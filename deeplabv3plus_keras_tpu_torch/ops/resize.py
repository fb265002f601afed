"""In-model bilinear resizes (port of ``deeplabv3plus_keras_tpu/ops/resize.py:160-234``).

Tensors are NCHW (any memory format).  Only integer upscales occur in the
model, and for those TF2's half-pixel bilinear resize (``jax.image.resize``
with ``method='linear'``, ``antialias=False``) and
``F.interpolate(mode='bilinear', align_corners=False)`` take the same taps
and weights, edges clamped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tf_resize_images(x: torch.Tensor, height_factor: int, width_factor: int) -> torch.Tensor:
    """``K.resize_images(..., 'bilinear')`` for integer factors."""
    return F.interpolate(
        x, scale_factor=(int(height_factor), int(width_factor)),
        mode="bilinear", align_corners=False, antialias=False,
    )


def interpolation_matrix(n: int, factor: int, dtype, device) -> torch.Tensor:
    """(n·factor, n) operator of a ×factor half-pixel bilinear resize: row i
    holds the ≤2 weights of output tap i (the resize of an identity)."""
    eye = torch.eye(n, dtype=torch.float32, device=device)[None, None]
    a = F.interpolate(
        eye, size=(n * int(factor), n), mode="bilinear", align_corners=False
    )
    return a[0, 0].to(dtype)


def tf_resize_images_matmul(x: torch.Tensor, height_factor: int, width_factor: int) -> torch.Tensor:
    """:func:`tf_resize_images` as two interpolation-matrix contractions
    (the JAX package's form for the pyramid-pooling branch and the fp32
    final upsample); the same ≤2-tap sums, operators built in fp32."""
    h, w = x.shape[-2:]
    ah = interpolation_matrix(h, height_factor, x.dtype, x.device)
    aw = interpolation_matrix(w, width_factor, x.dtype, x.device)
    y = torch.einsum("Hh,bchw->bcHw", ah, x)
    return torch.einsum("Ww,bcHw->bcHW", aw, y)
