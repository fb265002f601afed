"""Fused bilinear upsample (×s) + channel argmax: logits → class labels.

Port of the Pallas TPU kernel ``upsample_argmax``
(``deeplabv3plus_keras_tpu/kernels/upsample_argmax.py:88``, body
``_kernel`` :58).  Softmax is monotone per pixel, so
``argmax(softmax(up(x))) == argmax(up(x))``: labels come straight from the
decoder's low-resolution logits, and the (B, h·s, w·s, C) upsampled tensor
never exists.

On the card: ``csrc/upsample_argmax.cu``, one thread per output pixel,
blending in the JAX kernel's order.  Its bound is memory: the logits read
once (B·h·w·C·4 bytes) and the labels written once (B·h·s·w·s·4 bytes).

A CPU tensor takes :func:`upsample_argmax_plain`
(``F.interpolate(bilinear, align_corners=False)`` then ``argmax``, which,
like the kernel, keeps the first maximum).  A CUDA tensor launches the
kernel or raises.  The two agree except where two classes' upsampled
logits tie to within float rounding.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# Launches of the CUDA kernel; the wrapper adds one per launch.
launches = {"upsample_argmax": 0}


def upsample_argmax_plain(logits: torch.Tensor, scale: int) -> torch.Tensor:
    """Plain PyTorch version: (B, h, w, C) → (B, h·s, w·s) int32."""
    up = F.interpolate(
        logits.permute(0, 3, 1, 2).float(), scale_factor=int(scale),
        mode="bilinear", align_corners=False, antialias=False,
    )
    return up.argmax(dim=1).to(torch.int32)


def upsample_argmax(logits: torch.Tensor, scale: int) -> torch.Tensor:
    """logits (B, h, w, C) float32, C contiguous → labels (B, h·s, w·s) int32.

    Matches ``argmax(tf_resize_images(logits, s, s), -1)`` of the JAX
    package."""
    s = int(scale)
    if logits.dim() != 4 or s < 1:
        raise ValueError(f"upsample_argmax: logits {tuple(logits.shape)}, scale {s}")
    if logits.device.type == "cpu":
        return upsample_argmax_plain(logits, s)
    if logits.device.type != "cuda":
        raise ValueError(f"upsample_argmax: logits on {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"upsample_argmax: CUDA kernel takes float32, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("upsample_argmax: logits must be contiguous (B, h, w, C)")
    B, h, w, C = logits.shape
    if B > 65535 or h * s > 65535 or logits.numel() >= 2**31 or B * h * w * s * s >= 2**31:
        raise ValueError(f"upsample_argmax: shape {tuple(logits.shape)} x{s} too large for the kernel's grid")
    out = torch.empty((B, h * s, w * s), dtype=torch.int32, device=logits.device)
    fn = _build.function(
        "upsample_argmax", "upsample_argmax",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    with torch.cuda.device(logits.device):
        rc = fn(
            logits.data_ptr(), out.data_ptr(), B, h, w, C, s,
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"upsample_argmax launch failed: CUDA error {rc}")
    launches["upsample_argmax"] += 1
    return out
