"""Depthwise k×k convolution with TF ``SAME`` padding, NHWC memory,
forward and backward.

Port of the Pallas TPU depthwise stencils of
``deeplabv3plus_keras_tpu/kernels/depthwise3.py``:

- forward, stride 1, any dilation: ``_dw_fwd_nhwc`` (:318, body
  ``_fwd_kernel_nhwc`` :267);
- forward, stride 2: ``_dw_fwd_s2`` (:684, body :630, geometry
  ``_s2_geometry`` :565), which the TPU computes over four parity planes;
- backward, stride 1: ``_dw_bwd_nhwc`` (:422, body :346, VJP ``_vjp_bwd``
  :499-518);
- backward, stride 2: ``_dw_bwd_s2`` (:798, body :719, VJP
  ``_vjp_bwd_s2`` :884-895);
- the dispatcher ``depthwise_conv`` (:1257).

On the card the forward is one hand-written CUDA kernel,
``csrc/depthwise_fwd.cu``, and the backward another,
``csrc/depthwise_bwd.cu`` (dx, and dk as a deterministic two-pass
reduction), both templated on the stride and joined by a
``torch.autograd.Function``.  Both are bound by memory (see the sources'
notes).  The forward's work is laid out by :func:`_fwd_plan`, a pure
function of the shape: the variant (``tile``: a zero-filled halo window
per tile in shared memory, one TMA copy each; ``gather``: taps read from
global memory, for dilated sites), the vector width (16 bytes of channels, or 1 where C
or a pointer does not allow it), the tile and the grid.  Each call is one
launch.
:func:`depthwise_conv_tiled_emulation` walks the same tiles in PyTorch for
the CPU tests.

Tensors are torch's NCHW logical shape held in ``channels_last`` memory —
physically NHWC, the layout the kernel indexes and the one cuDNN's convs
around it produce — so no permute or copy is made around a launch.
The weight is torch's grouped-conv layout ``(C, 1, k, k)``.

A CPU tensor takes :func:`depthwise_conv_plain` (``F.pad`` with the TF
``SAME`` pads, then ``F.conv2d(groups=C)``) and its autograd; the plain
backward is :func:`depthwise_conv_backward_plain`.  A CUDA tensor launches
the kernels or raises; nothing falls back.

The channels-first route (port of ``depthwise3.py:465-521`` and
``_to_bhcw_padded`` :216): with ``DLV3_DW_LAYOUT=bhcw``, read on every call
as the JAX package reads it at trace time, a site with k = 3, stride 1 and
dilation (1, 1) makes x NCHW-contiguous, runs ``csrc/depthwise_cf.cu``
(K6 forward, ``_dw_fwd_padded`` :105; K7 backward, ``_dw_bwd_padded``
:185) on it, and returns the result to ``channels_last`` memory.  Every
other site, and every site under ``nhwc`` (the default), keeps the NHWC
kernels.  :func:`depthwise_route` names the route a site takes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build

# Launches of the CUDA kernels, per direction and stride; each wrapper adds
# one per launch (a backward launch computes dx, dk or both).
launches = {
    "depthwise_fwd_s1": 0, "depthwise_fwd_s2": 0,
    "depthwise_bwd_s1": 0, "depthwise_bwd_s2": 0,
    "depthwise_fwd_cf": 0, "depthwise_bwd_cf": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"tile": 0, "gather": 1}
# dk's first pass aims at this many blocks of 256 threads: 8 on each of
# the H100's 132 SMs.  A constant, so the row tiles (and with them the
# order of dk's float sums) depend on the shape alone.
_DK_CHANNELS, _DK_BLOCKS = 32, 132 * 8


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


def depthwise_conv_backward_plain(
    x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, stride: int = 1,
    dilation=(1, 1),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of :func:`depthwise_conv_plain`: the
    gradients (dx, dweight) for the output gradient ``g``, as the grouped
    conv's input and weight gradients on the same ``SAME``-padded input."""
    k = weight.shape[-1]
    C, H, W = x.shape[1:]
    dh, dw = int(dilation[0]), int(dilation[1])
    _, pt, pb = same_pads(H, k, stride, dh)
    _, pl, pr = same_pads(W, k, stride, dw)
    xp = F.pad(x, (pl, pr, pt, pb))
    w = weight.to(x.dtype)
    g = g.to(x.dtype)
    dxp = torch.nn.grad.conv2d_input(xp.shape, w, g, stride, 0, (dh, dw), C)
    dweight = torch.nn.grad.conv2d_weight(xp, w.shape, g, stride, 0, (dh, dw), C)
    return dxp[:, :, pt:pt + H, pl:pl + W], dweight.to(weight.dtype)


def _geometry(x: torch.Tensor, k: int, stride: int, dilation):
    """(B, C, H, W, Ho, Wo, dh, dw, pad top, pad left), checked against
    the kernels' 32-bit indexing and grid limits."""
    B, C, H, W = x.shape
    dh, dw = int(dilation[0]), int(dilation[1])
    Ho, pt, _ = same_pads(H, k, stride, dh)
    Wo, pl, _ = same_pads(W, k, stride, dw)
    if max(x.numel(), B * C * Ho * Wo) >= 2**31 or max(H, Ho, B) > 65535:
        raise ValueError(f"depthwise_conv: shape {tuple(x.shape)} too large for the kernel's grid")
    return B, C, H, W, Ho, Wo, dh, dw, pt, pl


_R = 4  # outputs per thread along W (csrc/depthwise_fwd.cu R)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How ``csrc/depthwise_fwd.cu`` computes one forward call.

    ``variant`` ``"tile"`` stages each tile's zero-filled input window in
    shared memory; ``"gather"`` (stride 1, dilated) reads every tap from
    global memory.  A block computes one tile of ``th`` output rows × ``tw =
    strips * r`` columns × ``cb = nv * vec`` channels; thread (row, strip,
    vector) computes ``r`` outputs along W of ``vec`` channels.  ``grid``
    is (tiles along W × channel blocks, tiles along H, B)."""

    variant: str
    vec: int
    nv: int
    r: int
    strips: int
    th: int
    cblocks: int
    grid: tuple[int, int, int]
    smem: int
    k: int
    stride: int
    dilation: tuple[int, int]
    pads: tuple[int, int]
    out_hw: tuple[int, int]

    @property
    def tw(self) -> int:
        return self.strips * self.r

    @property
    def cb(self) -> int:
        return self.nv * self.vec

    @property
    def threads(self) -> int:
        return self.nv * self.strips * self.th

    @property
    def window(self) -> tuple[int, int]:
        """(rows, columns) of a tile's staged window (tile variant)."""
        s, (dh, dw) = self.stride, self.dilation
        return ((self.th - 1) * s + (self.k - 1) * dh + 1,
                (self.tw - 1) * s + (self.k - 1) * dw + 1)

    def tiles(self):
        """(b, first channel, first output row, first output column) of every
        tile, in the kernel's block order: block (x, y, b) decodes
        ``x = tile_w * cblocks + channel block`` and computes row tile y."""
        gx, gy, B = self.grid
        for b in range(B):
            for y in range(gy):
                for x in range(gx):
                    yield b, (x % self.cblocks) * self.cb, y * self.th, (x // self.cblocks) * self.tw


def _buf_bytes(rows: int, cols: int, cb: int, itemsize: int) -> int:
    """Shared bytes of one window buffer, rounded up to 128."""
    return -(-rows * cols * cb * itemsize // 128) * 128


@functools.lru_cache(maxsize=512)
def _fwd_plan(B: int, C: int, H: int, W: int, k: int, stride: int, dilation,
              dtype: torch.dtype, ptr_align: int) -> FwdPlan:
    """The forward kernel's plan for one call, from the shape alone.

    - Variant: ``gather`` at a dilated site (its window would be mostly
      padding, or re-read (k−1)·d halo rows per tile), else ``tile``.
    - Vector width: 16 bytes of channels (4 float32, 8 bfloat16) when C is
      a multiple of it and x and y are 16-byte aligned (``ptr_align``, the
      largest power of two dividing both pointers), else 1 (the narrow
      instantiation).
    - Lanes: 8 channel vectors (one 128-byte line per pixel) or, narrow, up
      to 32 channels; 2 strips of ``r`` = 4 columns and 8 rows, the tile
      chosen from those tried at the flagship's sites on the H100
      (PERF.md §6)."""
    dh, dw = int(dilation[0]), int(dilation[1])
    Ho, pt, _ = same_pads(H, k, stride, dh)
    Wo, pl, _ = same_pads(W, k, stride, dw)
    itemsize = dtype.itemsize
    full = 16 // itemsize
    vec = full if C % full == 0 and ptr_align % 16 == 0 else 1
    nvec = -(-C // vec)
    nv = min(nvec, 8 if vec > 1 else 32)
    cblocks = -(-nvec // nv)
    variant = "tile" if (dh, dw) == (1, 1) else "gather"
    strips = max(1, min(2, -(-Wo // _R)))
    th = min(8, 256 // (nv * strips))  # at most 256 threads a block
    smem = 0
    if variant == "tile":
        rows, cols = (th - 1) * stride + k, (strips * _R - 1) * stride + k
        # the window, a 16-byte slot for the barrier, the taps when k > 3
        smem = (_buf_bytes(rows, cols, nv * vec, itemsize) + 16
                + (k * k * nv * vec * 4 if k > 3 else 0))
    grid = (-(-Wo // (strips * _R)) * cblocks, -(-Ho // th), B)
    if grid[0] >= 2**31 or grid[1] > 65535 or B > 65535:
        raise ValueError(f"depthwise plan: grid {grid} too large")
    return FwdPlan(variant, vec, nv, _R, strips, th, cblocks, grid, smem, k, stride,
                   (dh, dw), (pt, pl), (Ho, Wo))


def _ptr_align(*ts: torch.Tensor) -> int:
    """The largest power of two (≤ 16) dividing every tensor's address."""
    p = 16
    for t in ts:
        p = math.gcd(p, t.data_ptr())
    return p


def depthwise_conv_tiled_emulation(
    x: torch.Tensor, weight: torch.Tensor, stride: int, dilation, plan: FwdPlan
) -> torch.Tensor:
    """The forward kernel's decomposition in PyTorch, for tests: walks the
    plan's tiles in the kernel's order and computes each tile's outputs
    from what the kernel gives that tile alone.

    - ``tile``: the zero-filled window ``plan.window`` whose top-left input
      pixel is (ho0·S − pad_t, wo0·S − pad_l), channels [c0, c0 + cb);
    - ``gather``: the k row bands and k column bands the taps reach, each
      element zero where it falls outside the image.
    Outputs past the map or past C are computed and dropped, as the kernel
    masks its stores."""
    B, C, H, W = x.shape
    k = weight.shape[-1]
    s = stride
    dh, dw = int(dilation[0]), int(dilation[1])
    (Ho, Wo), (pt, pl) = plan.out_hw, plan.pads
    xs = x.permute(0, 2, 3, 1)  # NHWC, as the kernel indexes memory
    taps = weight.reshape(C, k, k).permute(1, 2, 0).to(x.dtype)  # (ky, kx, C)
    y = torch.full((B, Ho, Wo, C), float("nan"), dtype=x.dtype)
    th, tw, cb = plan.th, plan.tw, plan.cb

    def gathered(idx, n):  # clamp and a mask: zero outside [0, n)
        idx = torch.as_tensor(idx)
        return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)

    for b, c0, ho0, wo0 in plan.tiles():
        cs = torch.arange(c0, c0 + cb)
        cin = cs < C
        cc = cs.clamp(max=C - 1)
        tap = taps[:, :, cc] * cin
        if plan.variant == "tile":
            rows, cols = plan.window
            ry, my = gathered(range(ho0 * s - pt, ho0 * s - pt + rows), H)
            rx, mx = gathered(range(wo0 * s - pl, wo0 * s - pl + cols), W)
            win = xs[b][ry][:, rx][:, :, cc] * (my[:, None, None] & mx[None, :, None] & cin)
            out = sum(win[ky * dh: ky * dh + (th - 1) * s + 1: s,
                          kx * dw: kx * dw + (tw - 1) * s + 1: s] * tap[ky, kx]
                      for ky in range(k) for kx in range(k))
        else:  # gather: row band ky holds input rows ho·S − pad_t + ky·dh
            out = 0
            for ky in range(k):
                ry, my = gathered([(ho0 + i) * s - pt + ky * dh for i in range(th)], H)
                for kx in range(k):
                    rx, mx = gathered([(wo0 + j) * s - pl + kx * dw for j in range(tw)], W)
                    band = xs[b][ry][:, rx][:, :, cc] * (my[:, None, None] & mx[None, :, None])
                    out = out + band * tap[ky, kx]
        hn, wn, cn = min(th, Ho - ho0), min(tw, Wo - wo0), min(cb, C - c0)
        y[b, ho0:ho0 + hn, wo0:wo0 + wn, c0:c0 + cn] = out[:hn, :wn, :cn]
    return y.permute(0, 3, 1, 2)


def _taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(C, 1, k, k) → (k*k, C) float32 tap table, tap t = ky*k + kx; taps
    are rounded to the activations' dtype first, as the plain version's
    conv sees them."""
    C, k = weight.shape[0], weight.shape[-1]
    return weight.detach().to(dtype).reshape(C, k * k).t().float().contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x: torch.Tensor, weight: torch.Tensor, stride: int, dilation):
    """One launch of the forward kernel, by :func:`_fwd_plan`'s plan."""
    k = weight.shape[-1]
    B, C, H, W, Ho, Wo, dh, dw, pt, pl = _geometry(x, k, stride, dilation)
    taps = _taps(weight, x.dtype)
    y = torch.empty(
        (B, C, Ho, Wo), dtype=x.dtype, device=x.device,
        memory_format=torch.channels_last,
    )
    plan = _fwd_plan(B, C, H, W, k, stride, (dh, dw), x.dtype, _ptr_align(x, y))
    fn = _build.function(
        "depthwise_fwd", "dw_fwd",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 23 + [ctypes.c_void_p],
    )
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), taps.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
            B, H, W, C, Ho, Wo, k, stride, dh, dw, pt, pl,
            _VARIANT_CODE[plan.variant], plan.vec, plan.nv, plan.r, plan.strips, plan.th,
            plan.cblocks, plan.grid[0], plan.grid[1], plan.smem, _stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"depthwise_fwd launch failed: CUDA error {rc}")
    launches[f"depthwise_fwd_s{stride}"] += 1
    return y


def _launch_backward(x, weight, g, stride: int, dilation, want_dx: bool, want_dk: bool):
    """(dx or None, dweight or None) from the CUDA backward kernel."""
    k = weight.shape[-1]
    B, C, H, W, Ho, Wo, dh, dw, pt, pl = _geometry(x, k, stride, dilation)
    if tuple(g.shape) != (B, C, Ho, Wo) or g.dtype != x.dtype:
        raise ValueError(f"depthwise_conv backward: g {tuple(g.shape)} {g.dtype} for x {tuple(x.shape)} {x.dtype}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("depthwise_conv backward: g must be contiguous in channels_last memory")
    dx = taps = dk = partial = None
    rows = tiles = 1
    if want_dx:
        taps = _taps(weight, x.dtype)
        dx = torch.empty_like(x, memory_format=torch.channels_last)
    if want_dk:
        groups = -(-C // _DK_CHANNELS)
        rows = max(1, -(-B * Ho * groups // _DK_BLOCKS))
        tiles = -(-B * Ho // rows)
        f32 = dict(dtype=torch.float32, device=x.device)
        partial = torch.empty((tiles, k * k, C), **f32)
        dk = torch.empty((C, 1, k, k), **f32)
    fn = _build.function(
        "depthwise_bwd", "dw_bwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p],
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), g.data_ptr(), ptr(taps), ptr(dx), ptr(dk), ptr(partial),
            _DTYPE_CODE[x.dtype], B, H, W, C, Ho, Wo, k, stride, dh, dw, pt, pl,
            rows, tiles, _stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"depthwise_bwd launch failed: CUDA error {rc}")
    launches[f"depthwise_bwd_s{stride}"] += 1
    return dx, (None if dk is None else dk.to(weight.dtype))


class _DepthwiseConv(torch.autograd.Function):
    """The CUDA forward, and the CUDA backward as its gradient.  Saves x
    and the weight (no padded copies); a frozen weight or input skips its
    half of the backward."""

    @staticmethod
    def forward(ctx, x, weight, stride, dilation):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.dilation = stride, dilation
        return _launch(x, weight, stride, dilation)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx, dweight = _launch_backward(
            x, weight, g, ctx.stride, ctx.dilation, *ctx.needs_input_grad[:2]
        )
        return dx, dweight, None, None


_LAYOUTS = ("nhwc", "bhcw")


def _layout() -> str:
    """``DLV3_DW_LAYOUT``: ``nhwc`` (the default) or ``bhcw``; anything else
    raises rather than being taken as ``nhwc``."""
    layout = os.environ.get("DLV3_DW_LAYOUT", "nhwc")
    if layout not in _LAYOUTS:
        raise ValueError(f"DLV3_DW_LAYOUT={layout!r}: expected one of {_LAYOUTS}")
    return layout


def depthwise_route(weight: torch.Tensor, stride: int = 1, dilation=(1, 1)) -> str:
    """``"cf"`` where the channels-first kernels K6/K7 take the site (k = 3,
    stride 1, dilation (1, 1), under ``DLV3_DW_LAYOUT=bhcw``), else
    ``"nhwc"`` (K2-K5)."""
    cf = (weight.shape[-1] == 3 and stride == 1
          and (int(dilation[0]), int(dilation[1])) == (1, 1))
    return "cf" if _layout() == "bhcw" and cf else "nhwc"


def _check_cf(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dim() != 4 or tuple(weight.shape) != (x.shape[1], 1, 3, 3):
        raise ValueError(f"depthwise_cf: x {tuple(x.shape)}, weight {tuple(weight.shape)}: "
                         "want (B, C, H, W) and (C, 1, 3, 3)")
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"depthwise_cf: x on {x.device}, weight on {weight.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"depthwise_cf: CUDA kernel takes float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("depthwise_cf: x must be NCHW-contiguous")
    if x.numel() >= 2**31 or max(x.shape[:2]) > 65535:
        raise ValueError(f"depthwise_cf: shape {tuple(x.shape)} too large for the kernel's grid")


def depthwise_cf(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K6 alone: the 3×3 stride-1 SAME depthwise conv of an NCHW-contiguous
    x, NCHW-contiguous out.  The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return depthwise_conv_plain(x, weight)
    _check_cf(x, weight)
    B, C, H, W = x.shape
    taps = _taps(weight, x.dtype)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    fn = _build.function("depthwise_cf", "dw_cf_fwd",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), taps.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
                B, C, H, W, _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise_cf launch failed: CUDA error {rc}")
    launches["depthwise_fwd_cf"] += 1
    return y


def depthwise_cf_backward(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                          want_dx: bool = True, want_dk: bool = True):
    """K7 alone: (dx or None, dweight or None) of :func:`depthwise_cf` for
    the output gradient ``g``, all NCHW-contiguous.  The plain backward on
    CPU tensors."""
    if x.device.type == "cpu":
        dx, dk = depthwise_conv_backward_plain(x, weight, g)
        return (dx if want_dx else None), (dk if want_dk else None)
    _check_cf(x, weight)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"depthwise_cf backward: g {tuple(g.shape)} {g.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}, NCHW-contiguous")
    if not (want_dx or want_dk):
        return None, None
    B, C, H, W = x.shape
    slots = _build.function("depthwise_cf", "dw_cf_slots", [ctypes.c_int] * 3)(B, H, W)
    f32 = dict(dtype=torch.float32, device=x.device)
    taps = _taps(weight, x.dtype) if want_dx else None
    dx = torch.empty_like(x, memory_format=torch.contiguous_format) if want_dx else None
    dk = torch.empty((C, 1, 3, 3), **f32) if want_dk else None
    partial = torch.empty((slots, 9, C), **f32) if want_dk else None
    fn = _build.function("depthwise_cf", "dw_cf_bwd",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), g.data_ptr(), ptr(taps), ptr(dx), ptr(dk), ptr(partial),
                _DTYPE_CODE[x.dtype], B, C, H, W, _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise_cf_backward launch failed: CUDA error {rc}")
    launches["depthwise_bwd_cf"] += 1
    return dx, (None if dk is None else dk.to(weight.dtype))


class _DepthwiseConvCF(torch.autograd.Function):
    """The channels-first route: x made NCHW-contiguous, K6, the result back
    in ``channels_last``; K7 as its gradient.  Saves x and the weight (no
    padded or transposed copies); the backward makes x and g NCHW-contiguous,
    as the JAX ``_vjp_bwd`` re-transposes them, and returns dx in
    ``channels_last``."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return depthwise_cf(x.contiguous(), weight).contiguous(memory_format=torch.channels_last)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dweight = depthwise_cf_backward(
            x.contiguous(), weight, g.to(x.dtype).contiguous(), *ctx.needs_input_grad[:2]
        )
        if dx is not None:
            dx = dx.contiguous(memory_format=torch.channels_last)
        return dx, dweight


def _on_card(x: torch.Tensor, weight: torch.Tensor, stride: int, dilation) -> bool:
    """Validate a depthwise call; True for CUDA tensors (the kernels), False
    for CPU tensors (the plain versions)."""
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
        return False
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"depthwise_conv: x on {x.device}, weight on {weight.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"depthwise_conv: CUDA kernel takes float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("depthwise_conv: x must be contiguous in channels_last memory")
    return True


def depthwise_conv(
    x: torch.Tensor, weight: torch.Tensor, stride: int = 1, dilation=(1, 1)
) -> torch.Tensor:
    """Depthwise conv, TF ``SAME`` padding.

    x: (B, C, H, W), ``channels_last`` memory on CUDA; weight (C, 1, k, k)
    with odd k ∈ {3, 5, 7}; stride 1 (any dilation) or 2 (dilation 1).
    Returns (B, C, ⌈H/stride⌉, ⌈W/stride⌉) in ``channels_last``,
    differentiable in x and weight on both devices, through the route
    :func:`depthwise_route` names."""
    card = _on_card(x, weight, stride, dilation)
    if depthwise_route(weight, stride, dilation) == "cf":
        if not card:
            return depthwise_cf(x.contiguous(), weight).contiguous(memory_format=torch.channels_last)
        return _DepthwiseConvCF.apply(x, weight)
    if not card:
        return depthwise_conv_plain(x, weight, stride, dilation)
    return _DepthwiseConv.apply(x, weight, stride, (int(dilation[0]), int(dilation[1])))


def depthwise_conv_backward(
    x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, stride: int = 1,
    dilation=(1, 1),
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward alone: (dx, dweight) of :func:`depthwise_conv` at
    (x, weight) for the output gradient ``g``, on the same route.  The
    backward kernel on CUDA (dx in ``channels_last``), the plain backward
    on the CPU."""
    card = _on_card(x, weight, stride, dilation)
    if depthwise_route(weight, stride, dilation) == "cf":
        dx, dk = depthwise_cf_backward(x.contiguous(), weight, g.to(x.dtype).contiguous())
        return dx.contiguous(memory_format=torch.channels_last), dk
    if not card:
        return depthwise_conv_backward_plain(x, weight, g, stride, dilation)
    g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
    return _launch_backward(x, weight, g, stride, dilation, True, True)
