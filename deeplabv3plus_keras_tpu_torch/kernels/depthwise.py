"""Depthwise k×k convolution forward with TF ``SAME`` padding, NHWC memory.

Port of the Pallas TPU depthwise stencils of
``deeplabv3plus_keras_tpu/kernels/depthwise3.py``:

- stride 1, any dilation: ``_dw_fwd_nhwc`` (:318, body
  ``_fwd_kernel_nhwc`` :267);
- stride 2: ``_dw_fwd_s2`` (:684, body :630, geometry ``_s2_geometry``
  :565), which the TPU computes over four parity planes;
- the dispatcher ``depthwise_conv`` (:1257).

On the card both are one hand-written CUDA kernel,
``csrc/depthwise_fwd.cu``, templated on the stride: one thread per output
element, channel fastest, every tap bounds-checked.  Its bound is memory:
the input read once and the output written once (see the source's note).

Tensors are torch's NCHW logical shape held in ``channels_last`` memory —
physically NHWC, the layout the kernel indexes and the one cuDNN's convs
around it produce — so no permute or copy is made around a launch.
The weight is torch's grouped-conv layout ``(C, 1, k, k)``.

A CPU tensor takes :func:`depthwise_conv_plain` (``F.pad`` with the TF
``SAME`` pads, then ``F.conv2d(groups=C)``).  A CUDA tensor launches the
kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# Launches of the CUDA kernel, per stride; the wrapper adds one per launch.
launches = {"depthwise_fwd_s1": 0, "depthwise_fwd_s2": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def same_pads(n: int, k: int, stride: int, dilation: int) -> tuple[int, int, int]:
    """TF ``SAME`` along one axis: (out size, pad before, pad after).

    Stride 2 on an even size pads ``(0, 1)`` for k=3: the extra row goes
    after, not before, so torch's symmetric ``padding=1`` is off by one."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return out, total // 2, total - total // 2


def depthwise_conv_plain(
    x: torch.Tensor, weight: torch.Tensor, stride: int = 1, dilation=(1, 1)
) -> torch.Tensor:
    """Plain PyTorch version: explicit TF-SAME ``F.pad`` + grouped conv."""
    k = weight.shape[-1]
    H, W = x.shape[-2:]
    dh, dw = dilation
    _, pt, pb = same_pads(H, k, stride, dh)
    _, pl, pr = same_pads(W, k, stride, dw)
    xp = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(
        xp, weight.to(x.dtype), stride=stride, dilation=(dh, dw),
        groups=x.shape[1],
    )


def _launch(x: torch.Tensor, weight: torch.Tensor, stride: int, dilation):
    B, C, H, W = x.shape
    k = weight.shape[-1]
    dh, dw = int(dilation[0]), int(dilation[1])
    Ho, pt, _ = same_pads(H, k, stride, dh)
    Wo, pl, _ = same_pads(W, k, stride, dw)
    if max(x.numel(), B * C * Ho * Wo) >= 2**31 or Ho > 65535 or B > 65535:
        raise ValueError(f"depthwise_conv: shape {tuple(x.shape)} too large for the kernel's grid")
    # (C, 1, k, k) → (k*k, C) float32 tap table, tap t = ky*k + kx; taps
    # are rounded to x's dtype first, as the plain version's conv sees them
    taps = weight.detach().to(x.dtype).reshape(C, k * k).t().float().contiguous()
    y = torch.empty(
        (B, C, Ho, Wo), dtype=x.dtype, device=x.device,
        memory_format=torch.channels_last,
    )
    fn = _build.function(
        "depthwise_fwd", "dw_fwd",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
    )
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), taps.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
            B, H, W, C, Ho, Wo, k, stride, dh, dw, pt, pl,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"depthwise_fwd launch failed: CUDA error {rc}")
    launches[f"depthwise_fwd_s{stride}"] += 1
    return y


def depthwise_conv(
    x: torch.Tensor, weight: torch.Tensor, stride: int = 1, dilation=(1, 1)
) -> torch.Tensor:
    """Depthwise conv, TF ``SAME`` padding.

    x: (B, C, H, W), ``channels_last`` memory on CUDA; weight (C, 1, k, k)
    with odd k ∈ {3, 5, 7}; stride 1 (any dilation) or 2 (dilation 1).
    Returns (B, C, ⌈H/stride⌉, ⌈W/stride⌉) in ``channels_last``."""
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError("depthwise_conv: x and weight must be 4-D")
    C = x.shape[1]
    k = weight.shape[-1]
    if tuple(weight.shape) != (C, 1, k, k) or k not in (3, 5, 7):
        raise ValueError(
            f"depthwise_conv: weight {tuple(weight.shape)} is not (C={C}, 1, k, k) with k in (3, 5, 7)"
        )
    if stride not in (1, 2) or (stride == 2 and tuple(dilation) != (1, 1)):
        raise ValueError(f"depthwise_conv: stride {stride} dilation {tuple(dilation)} unsupported")
    if min(int(dilation[0]), int(dilation[1])) < 1:
        raise ValueError(f"depthwise_conv: dilation {tuple(dilation)} must be >= 1")
    if x.device.type == "cpu":
        return depthwise_conv_plain(x, weight, stride, dilation)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"depthwise_conv: x on {x.device}, weight on {weight.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"depthwise_conv: CUDA kernel takes float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("depthwise_conv: x must be contiguous in channels_last memory")
    return _launch(x, weight, stride, dilation)
