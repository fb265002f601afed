"""Fused bilinear upsample (×f) + 3×3 SAME conv
(port of ``deeplabv3plus_keras_tpu/ops/fused_upconv.py:40-96``).

``conv3×3(resize_×f(x))`` is the decoder's classifier over the refinement
concat.  Done in two steps it materialises (B, C, f·H, f·W): at the
flagship, (16, 304, 256, 256) float32, 1.27 GB.  Half-pixel bilinear ×f is
a transposed convolution with a triangle kernel, so the composition is ONE
transposed convolution with the composed (2f+2)² kernel

    K[u, v, c, o] = Σ_{dh,dw} W[dh, dw, c, o] · A[u, dh] · A[v, dw],

and the upsampled tensor never exists.  The edge clamp of the resize
breaks that structure on the outer f/2+1 output rows and columns; those
strips are recomputed exactly through the two-step path on 3-row/column
slabs and patched in, so the result equals the two-step computation to
float rounding.

This is plain convolution work, which the JAX package leaves to XLA; here
it goes to torch's convolutions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial
from .resize import tf_resize_images


def _compose_matrix(f: int) -> np.ndarray:
    """A[u, d]: weight of conv tap d ∈ {0,1,2} at transposed-kernel
    position u ∈ [0, 2f+2), for a correlation (as the JAX package)."""
    L = 2 * f + 2
    m_max = 3 * f // 2
    A = np.zeros((L, 3), np.float32)
    for u in range(L):
        for d in range(3):
            z = m_max - u + d - 1
            A[u, d] = max(0.0, 1.0 - abs(z - f / 2 + 0.5) / f)
    return A


def upsample_conv3_plain(x: torch.Tensor, w: torch.Tensor, f: int) -> torch.Tensor:
    """Two-step reference: conv3×3 SAME of the ×f bilinear upsample."""
    return F.conv2d(tf_resize_images(x, f, f), w, padding=1)


def upsample_conv3(x: torch.Tensor, w: torch.Tensor, f: int) -> torch.Tensor:
    """``conv3×3_SAME(bilinear_×f(x), w)`` without the upsampled tensor.

    x: (B, C, H, W); w: (O, C, 3, 3); f: even integer ≥ 2.
    Result: (B, O, f·H, f·W).  Under ``mesh_space`` a rank's output rows
    come from the source rows they need, the result's rows kept
    (``parallel/spatial.py`` ``resize_rows`` with a one-row halo)."""
    if spatial.active():
        return spatial.resize_rows(x, f, lambda b: _upsample_conv3(b, w, f), halo=1,
                                   out_width=f * x.shape[-1], out_channels=w.shape[0], deps=(w,))
    return _upsample_conv3(x, w, f)


def _upsample_conv3(x: torch.Tensor, w: torch.Tensor, f: int) -> torch.Tensor:
    n_h, n_w = x.shape[-2:]
    if f < 2 or f % 2 or min(n_h, n_w) < 3:
        return upsample_conv3_plain(x, w, f)  # tiny inputs: strips would overlap

    A = torch.as_tensor(_compose_matrix(f), dtype=w.dtype, device=w.device)
    # correlation kernel (O, C, L, L) as the JAX package composes it ...
    k = torch.einsum("ocij,ui,vj->ocuv", w, A, A)
    # ... applied as a transposed conv: that convolves, so flip it, and
    # its weight is (C_in, C_out, L, L).  JAX pads 3f/2 around the
    # f-dilated input; the transposed conv's equivalent crop is L-1-3f/2.
    kt = k.flip(-1, -2).transpose(0, 1)
    y = F.conv_transpose2d(x, kt, stride=f, padding=f // 2 + 1)

    P = f // 2 + 1
    top = upsample_conv3_plain(x[:, :, :3], w, f)[:, :, :P]
    bot = upsample_conv3_plain(x[:, :, -3:], w, f)[:, :, -P:]
    left = upsample_conv3_plain(x[:, :, :, :3], w, f)[:, :, :, :P]
    right = upsample_conv3_plain(x[:, :, :, -3:], w, f)[:, :, :, -P:]
    # left/right strips last, so the corners take their values
    y = torch.cat([top, y[:, :, P:-P], bot], dim=2)
    return torch.cat([left, y[:, :, :, P:-P], right], dim=3)
