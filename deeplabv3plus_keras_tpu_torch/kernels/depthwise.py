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
reduction), both templated on the stride, in float32, bfloat16 or
float16 with float32 accumulation.  The forward launch is the custom
operator ``dlv3_port::depthwise_fwd`` (so ``torch.export`` records it) and
the backward its registered gradient.  Both are bound by memory (see the
sources' notes).  The forward's work is laid out by :func:`_fwd_plan`, a pure
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

Row windows (``mesh_space``, ``parallel/spatial.py``): with ``window`` =
(Ho, pad_t) x holds the rows of one rank's window of a row-sharded
activation, and the call computes Ho output rows, output row o reading x
rows o·S − pad_t + ky·d (zero outside x); W keeps TF ``SAME``.  This is
not SAME recomputed on the window's height: at stride 2 a window of odd or
extended height would shift the taps by one row.  The kernels take (Ho,
pad_t) as they are (their geometry always carried both); the backward's
dx covers every row of the window, its halo rows included, which the
exchange's backward sends home.  Ho = 0 launches nothing.

The channels-first route (port of ``depthwise3.py:465-521`` and
``_to_bhcw_padded`` :216): with ``DLV3_DW_LAYOUT=bhcw``, read on every call
as the JAX package reads it at trace time, a site with k = 3, stride 1 and
dilation (1, 1) makes x NCHW-contiguous, runs ``csrc/depthwise_cf.cu``
(K6 forward, ``_dw_fwd_padded`` :105, laid out by :func:`_cf_fwd_plan`,
emulated on the CPU by :func:`depthwise_cf_forward_emulation`; K7
backward, ``_dw_bwd_padded`` :185, laid out by :func:`_cf_bwd_plan`,
emulated by :func:`depthwise_cf_backward_emulation`) on it, and returns
the result to ``channels_last`` memory.  Every
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

from ..utils.profiling import span
from . import _build

# Launches of the CUDA kernels, per direction and stride; each wrapper adds
# one per launch (a backward launch computes dx, dk or both).
launches = {
    "depthwise_fwd_s1": 0, "depthwise_fwd_s2": 0,
    "depthwise_bwd_s1": 0, "depthwise_bwd_s2": 0,
    "depthwise_fwd_cf": 0, "depthwise_bwd_cf": 0,
}

# The same launches by dtype, "<kernel>/<dtype>" (float32, bfloat16, float16).
launches_by_dtype: dict[str, int] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _count(name: str, dtype: torch.dtype) -> None:
    launches[name] += 1
    key = f"{name}/{str(dtype).removeprefix('torch.')}"
    launches_by_dtype[key] = launches_by_dtype.get(key, 0) + 1
_VARIANT_CODE = {"tile": 0, "gather": 1}


def same_pads(n: int, k: int, stride: int, dilation: int) -> tuple[int, int, int]:
    """TF ``SAME`` along one axis: (out size, pad before, pad after).

    Stride 2 on an even size pads ``(0, 1)`` for k=3: the extra row goes
    after, not before, so torch's symmetric ``padding=1`` is off by one."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return out, total // 2, total - total // 2


def _row_pads(H: int, k: int, stride: int, dh: int, window) -> tuple[int, int, int]:
    """(output rows, pad top, pad bottom) along H: TF ``SAME``, or the
    ``window`` (Ho, pad_t) with as many bottom rows as its last output
    reaches past x (rows of x past that are not read)."""
    if window is None:
        return same_pads(H, k, stride, dh)
    Ho, pt = int(window[0]), int(window[1])
    return Ho, pt, max(0, (Ho - 1) * stride - pt + (k - 1) * dh + 1 - H)


def depthwise_conv_plain(
    x: torch.Tensor, weight: torch.Tensor, stride: int = 1, dilation=(1, 1), window=None
) -> torch.Tensor:
    """Plain PyTorch version: explicit TF-SAME ``F.pad`` + grouped conv
    (along H, the ``window``'s rows where one is given)."""
    k = weight.shape[-1]
    H, W = x.shape[-2:]
    dh, dw = dilation
    Ho, pt, pb = _row_pads(H, k, stride, dh, window)
    _, pl, pr = same_pads(W, k, stride, dw)
    if Ho == 0:
        return x.new_zeros((x.shape[0], x.shape[1], 0, -(-W // stride)))
    xp = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(
        xp, weight.to(x.dtype), stride=stride, dilation=(dh, dw),
        groups=x.shape[1],
    )[:, :, :Ho]


def depthwise_conv_backward_plain(
    x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, stride: int = 1,
    dilation=(1, 1), window=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of :func:`depthwise_conv_plain`: the
    gradients (dx, dweight) for the output gradient ``g``, as the grouped
    conv's input and weight gradients on the same ``SAME``-padded input
    (or the ``window``'s)."""
    k = weight.shape[-1]
    C, H, W = x.shape[1:]
    dh, dw = int(dilation[0]), int(dilation[1])
    Ho, pt, pb = _row_pads(H, k, stride, dh, window)
    _, pl, pr = same_pads(W, k, stride, dw)
    if Ho == 0:
        return torch.zeros_like(x), torch.zeros_like(weight)
    xp = F.pad(x, (pl, pr, pt, pb))
    # the window's padded x may hold rows past the last output's taps
    xp = xp[:, :, :(Ho - 1) * stride + (k - 1) * dh + 1]
    w = weight.to(x.dtype)
    g = g.to(x.dtype)
    dxp = torch.nn.grad.conv2d_input(xp.shape, w, g, stride, 0, (dh, dw), C)
    dweight = torch.nn.grad.conv2d_weight(xp, w.shape, g, stride, 0, (dh, dw), C)
    dx = dxp[:, :, pt:pt + H, pl:pl + W]
    if dx.shape[2] < H:  # rows of x no output reads
        dx = F.pad(dx, (0, 0, 0, H - dx.shape[2]))
    return dx, dweight.to(weight.dtype)


def _geometry(x: torch.Tensor, k: int, stride: int, dilation, window=None):
    """(B, C, H, W, Ho, Wo, dh, dw, pad top, pad left), checked against
    the kernels' 32-bit indexing and grid limits; along H the ``window``'s
    (Ho, pad_t) where one is given."""
    B, C, H, W = x.shape
    dh, dw = int(dilation[0]), int(dilation[1])
    Ho, pt, _ = _row_pads(H, k, stride, dh, window)
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


def _lanes(C: int, Wo: int, itemsize: int, ptr_align: int):
    """(vec, nv, cblocks, strips, th), shared by both plans: 16-byte channel
    vectors when C and the pointers allow them, else 1; 8 vectors (one
    128-byte line per pixel) or, narrow, up to 32 channels a block; 2
    strips of ``r`` = 4 columns (1 on a map narrower than a strip) and 8
    rows, or fewer rows to stay within 256 threads a block."""
    full = 16 // itemsize
    vec = full if C % full == 0 and ptr_align % 16 == 0 else 1
    nvec = -(-C // vec)
    nv = min(nvec, 8 if vec > 1 else 32)
    strips = max(1, min(2, -(-Wo // _R)))
    return vec, nv, -(-nvec // nv), strips, min(8, 256 // (nv * strips))


@functools.lru_cache(maxsize=512)
def _fwd_plan(B: int, C: int, H: int, W: int, k: int, stride: int, dilation,
              dtype: torch.dtype, ptr_align: int, window=None) -> FwdPlan:
    """The forward kernel's plan for one call, from the shape alone.

    - Variant: ``gather`` at a dilated site (its window would be mostly
      padding, or re-read (k−1)·d halo rows per tile), else ``tile``.
    - Vector width: 16 bytes of channels (4 float32, 8 bfloat16 or float16) when C is
      a multiple of it and x and y are 16-byte aligned (``ptr_align``, the
      largest power of two dividing both pointers), else 1 (the narrow
      instantiation).
    - Lanes: 8 channel vectors (one 128-byte line per pixel) or, narrow, up
      to 32 channels; 2 strips of ``r`` = 4 columns and 8 rows, the tile
      chosen from those tried at the flagship's sites on the H100
      (PERF.md §6).
    - ``window`` (Ho, pad_t): the output rows and the padding rows above x
      of a row window (``mesh_space``), else TF ``SAME``'s."""
    dh, dw = int(dilation[0]), int(dilation[1])
    Ho, pt, _ = _row_pads(H, k, stride, dh, window)
    Wo, pl, _ = same_pads(W, k, stride, dw)
    itemsize = dtype.itemsize
    vec, nv, cblocks, strips, th = _lanes(C, Wo, itemsize, ptr_align)
    variant = "tile" if (dh, dw) == (1, 1) else "gather"
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


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How ``csrc/depthwise_bwd.cu`` computes one backward call.

    The lanes (``vec``, ``nv``, ``strips``, ``th``, ``cblocks``) are the
    forward's.  A block owns one column of tiles (``th`` × ``tw`` outputs ×
    ``cb`` channels) and walks ``walk`` consecutive row tiles of the
    flattened (image, row tile) index, ``nty`` row tiles an image; ``grid``
    is (``tiles_w`` × channel blocks, ⌈B·nty / walk⌉).  Variant ``tile``
    stages each tile's x window and g window in shared memory; ``gather``
    (stride 1, dilated) reads both from global memory, one half of its
    threads computing dx and the other dk.  With ``stages`` = 2 a tile
    block copies the next tile's windows while it computes on the current
    ones.  Each block writes one (k², ``cb``) row of the partial buffer
    ``dk_buffer``; a final pass sums its rows."""

    variant: str
    vec: int
    nv: int
    r: int
    strips: int
    th: int
    cblocks: int
    tiles_w: int
    nty: int
    walk: int
    stages: int
    grid: tuple[int, int]
    smem: int
    k: int
    stride: int
    dilation: tuple[int, int]
    pads: tuple[int, int]
    out_hw: tuple[int, int]
    batch: int
    channels: int

    @property
    def tw(self) -> int:
        return self.strips * self.r

    @property
    def cb(self) -> int:
        return self.nv * self.vec

    @property
    def threads(self) -> int:
        """Threads a block: ``gather`` runs dx and dk in two roles."""
        return (2 if self.variant == "gather" else 1) * self.nv * self.strips * self.th

    @property
    def dk_buffer(self) -> tuple[int, int, int]:
        """(rows, k², C) of the float32 partial buffer: a row per block
        column and block row."""
        return self.grid[1] * self.tiles_w, self.k * self.k, self.channels

    @property
    def x_window(self) -> tuple[int, int]:
        """(rows, columns) of a tile's x window (tile variant): the
        forward's window."""
        s = self.stride
        return (self.th - 1) * s + self.k, (self.tw - 1) * s + self.k

    @property
    def g_window(self) -> tuple[int, int]:
        """(rows, columns) of a tile's g window (tile variant): the g tile
        and a halo of k − 1 at stride 1, (k − 1)/2 before it at stride 2."""
        if self.stride == 1:
            return self.th + self.k - 1, self.tw + self.k - 1
        p = (self.k - 1) // 2
        return self.th + p, self.tw + p

    @property
    def g_tile(self) -> tuple[int, int]:
        """(row, column) of the g tile inside its g window: (k − 1)/2 under
        ``SAME``; at stride 1, k − 1 − pad (a row window's pad_t may be 0)."""
        if self.stride == 1:
            (pt, pl), k = self.pads, self.k
            return k - 1 - pt, k - 1 - pl
        p = (self.k - 1) // 2
        return p, p

    def g_origin(self, ho0: int, wo0: int) -> tuple[int, int]:
        """Top-left g pixel of the g window of the tile at (ho0, wo0)."""
        if self.stride == 1:
            (pt, pl), k = self.pads, self.k
            return ho0 + pt - (k - 1), wo0 + pl - (k - 1)
        p = (self.k - 1) // 2
        return ho0 - p, wo0 - p

    @property
    def dx_tile(self) -> tuple[int, int]:
        return self.stride * self.th, self.stride * self.tw

    def dx_origin(self, ho0: int, wo0: int) -> tuple[int, int]:
        """Top-left input pixel of the dx tile of the tile at (ho0, wo0):
        the output tile at stride 1; (2·ho0 − pad_t, 2·wo0 − pad_l) at
        stride 2, so the dx tiles partition the input."""
        if self.stride == 1:
            return ho0, wo0
        pt, pl = self.pads
        return 2 * ho0 - pt, 2 * wo0 - pl

    def blocks(self):
        """(partial row, first channel, first output column, [(b, first
        output row), ...] of its walk) of every block, in the kernel's block
        order: block (x, y) decodes ``x = tile_w * cblocks + channel block``
        and walks row tiles y·walk … of the flattened (b, row tile) index."""
        gx, gy = self.grid
        n = self.batch * self.nty
        for y in range(gy):
            for x in range(gx):
                twi = x // self.cblocks
                walk = [(rt // self.nty, rt % self.nty * self.th)
                        for rt in range(y * self.walk, min((y + 1) * self.walk, n))]
                yield y * self.tiles_w + twi, (x % self.cblocks) * self.cb, twi * self.tw, walk


@functools.lru_cache(maxsize=512)
def _bwd_plan(B: int, C: int, H: int, W: int, k: int, stride: int, dilation,
              dtype: torch.dtype, ptr_align: int, window=None) -> BwdPlan:
    """The backward kernel's plan for one call, from the shape alone (so the
    order of dk's float sums depends on the shape alone).

    - Variant: ``tile`` at dilation 1, both strides; ``gather`` at dilated
      stride-1 sites.
    - Lanes, vector width and tile: the forward's (:func:`_lanes`);
      ``gather`` runs two roles of threads over the same strips (dx and
      dk), so its tile has at most 128 threads' rows; ``ptr_align``
      covers x, g and dx.
    - Row tiles: enough that the output tiles cover the map and that the
      dx tiles reach the last input row and column: at stride 1 they are
      the output tiles (a row window has more input rows than output
      rows), at stride 2 2·th rows from 2·ho0 − pad_t.
    - ``window`` (Ho, pad_t): a row window's, as :func:`_fwd_plan`.
    - Walk: the fewest row tiles a block walks for its partial row (k²·cb
      float32) to be at most 1/64 of the x it covers (th·tw·S²·cb
      elements), at most all of them.
    - Stages: two window buffers (the next tile's copy in flight during
      the current tile) where the vector tile walks and both fit in 96 KiB,
      else one.
    - Shared memory: ``csrc/depthwise_bwd.cu`` ``bwd_smem``."""
    dh, dw = int(dilation[0]), int(dilation[1])
    Ho, pt, _ = _row_pads(H, k, stride, dh, window)
    Wo, pl, _ = same_pads(W, k, stride, dw)
    itemsize = dtype.itemsize
    vec, nv, cblocks, strips, th = _lanes(C, Wo, itemsize, ptr_align)
    variant = "tile" if (dh, dw) == (1, 1) else "gather"
    if variant == "gather":  # two roles (dx, dk) of nv * strips * th threads each
        th = min(th, 128 // (nv * strips))
    tw = strips * _R
    nty, tiles_w = -(-max(Ho, H if stride == 1 else 0) // th), -(-Wo // tw)
    if stride == 2:
        nty = max(nty, -(-(H + pt) // (2 * th)))
        tiles_w = max(tiles_w, -(-(W + pl) // (2 * tw)))
    walk = min(B * nty, -(-256 * k * k // (th * tw * stride * stride * itemsize)))
    grid = (tiles_w * cblocks, -(-B * nty // walk))
    if grid[0] >= 2**31 or grid[1] > 65535:
        raise ValueError(f"depthwise backward plan: grid {grid} too large")
    cb, threads = nv * vec, nv * strips * th  # the threads that sum dk
    # the per-thread dk sums' reduction buffer (k = 3), which overlays the
    # windows after the walk; two barriers; the taps unless in registers;
    # the (tap, vector) entries' running sums (k > 3)
    red = _buf_bytes(threads, k * k * vec + 1, 1, 4) if k == 3 else 0
    ent = 0 if k == 3 else k * k * cb * 4
    stages = 1
    if variant == "gather":
        smem = red + ent
    else:
        p = (k - 1) // 2
        xw = _buf_bytes((th - 1) * stride + k, (tw - 1) * stride + k, cb, itemsize)
        gw = (_buf_bytes(th + k - 1, tw + k - 1, cb, itemsize) if stride == 1
              else _buf_bytes(th + p, tw + p, cb, itemsize))
        if vec > 1 and walk > 1 and 2 * (xw + gw) <= 96 * 1024:
            stages = 2
        reg_taps = k == 3 and vec <= 4
        smem = (max(stages * (xw + gw), red) + 16 * stages
                + (0 if reg_taps else k * k * cb * 4) + ent)
    return BwdPlan(variant, vec, nv, _R, strips, th, cblocks, tiles_w, nty, walk, stages, grid,
                   smem, k, stride, (dh, dw), (pt, pl), (Ho, Wo), B, C)


def depthwise_conv_backward_tiled_emulation(
    x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, stride: int, dilation,
    plan: BwdPlan,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's decomposition in PyTorch, for tests: walks the
    plan's blocks in the kernel's order and returns (dx, dweight).

    - ``tile``: each tile's dx comes only from its zero-filled g window
      (the stencil with the taps reversed; at stride 2 each dx row and
      column takes the taps of its parity), its dk only from its x window
      and the g tile inside the g window;
    - ``gather``: dx and dk from the row and column bands the taps reach,
      zero outside the image or the map.
    dk is summed per block over its walk into one partial row, then the
    rows are summed as the final pass does: lane l takes rows l, l + 32, …
    in order, then the lanes in order.  dx pixels outside the image and
    channels past C are computed and dropped, as the kernel masks its
    stores."""
    B, C, H, W = x.shape
    k = weight.shape[-1]
    s = stride
    dh, dw = int(dilation[0]), int(dilation[1])
    (Ho, Wo), (pt, pl) = plan.out_hw, plan.pads
    p = (k - 1) // 2
    xs, gs = x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1)  # NHWC, as the kernel indexes memory
    taps = weight.reshape(C, k, k).permute(1, 2, 0).to(x.dtype)  # (ky, kx, C)
    dx = torch.full((B, H, W, C), float("nan"), dtype=x.dtype)
    partial = torch.full(plan.dk_buffer, float("nan"), dtype=x.dtype)
    th, tw, cb = plan.th, plan.tw, plan.cb

    def gathered(idx, n):  # clamp and a mask: zero outside [0, n)
        idx = torch.as_tensor(list(idx))
        return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)

    def band(t, b, rows, cols, n_h, n_w, cc, cin):  # t[b, rows, cols, cc], zero outside
        ry, my = gathered(rows, n_h)
        rx, mx = gathered(cols, n_w)
        return t[b][ry][:, rx][:, :, cc] * (my[:, None, None] & mx[None, :, None] & cin)

    for slot, c0, wo0, walk in plan.blocks():
        cs = torch.arange(c0, c0 + cb)
        cin = cs < C
        cc = cs.clamp(max=C - 1)
        tap = taps[:, :, cc] * cin
        rev = tap.flip(0, 1)
        acc = torch.zeros(k, k, cb, dtype=x.dtype)
        for b, ho0 in walk:
            if plan.variant == "tile":
                (gy0, gx0), (gr, gc) = plan.g_origin(ho0, wo0), plan.g_window
                gwin = band(gs, b, range(gy0, gy0 + gr), range(gx0, gx0 + gc), Ho, Wo, cc, cin)
                if s == 1:
                    dxt = sum(gwin[ky:ky + th, kx:kx + tw] * rev[ky, kx]
                              for ky in range(k) for kx in range(k))
                else:  # dx row rho takes g row (rho + ky')/2 where rho + ky' is even
                    dxt = torch.zeros(2 * th, 2 * tw, cb, dtype=x.dtype)
                    for ky in range(k):
                        for kx in range(k):
                            r0, q0 = ky % 2, kx % 2
                            u, w = (r0 + ky) // 2, (q0 + kx) // 2
                            dxt[r0::2, q0::2] += gwin[u:u + th, w:w + tw] * rev[ky, kx]
                xr, xc = plan.x_window
                xwin = band(xs, b, range(ho0 * s - pt, ho0 * s - pt + xr),
                            range(wo0 * s - pl, wo0 * s - pl + xc), H, W, cc, cin)
                ty, tx = plan.g_tile
                gt = gwin[ty:ty + th, tx:tx + tw]
                for ky in range(k):
                    for kx in range(k):
                        xsh = xwin[ky:ky + (th - 1) * s + 1:s, kx:kx + (tw - 1) * s + 1:s]
                        acc[ky, kx] += (xsh * gt).sum((0, 1))
            else:  # gather, stride 1: dx row i takes g row i + pad_t − ky·dh
                dxt = 0
                gt = band(gs, b, range(ho0, ho0 + th), range(wo0, wo0 + tw), Ho, Wo, cc, cin)
                for ky in range(k):
                    for kx in range(k):
                        gb = band(gs, b, [ho0 + i + pt - ky * dh for i in range(th)],
                                  [wo0 + j + pl - kx * dw for j in range(tw)], Ho, Wo, cc, cin)
                        dxt = dxt + gb * tap[ky, kx]
                        xb = band(xs, b, [ho0 + i - pt + ky * dh for i in range(th)],
                                  [wo0 + j - pl + kx * dw for j in range(tw)], H, W, cc, cin)
                        acc[ky, kx] += (xb * gt).sum((0, 1))
            (dy0, dx0), (dr, dc) = plan.dx_origin(ho0, wo0), plan.dx_tile
            lo_h, hi_h = max(dy0, 0), min(dy0 + dr, H)
            lo_w, hi_w = max(dx0, 0), min(dx0 + dc, W)
            cn = min(cb, C - c0)
            if lo_h < hi_h and lo_w < hi_w:
                dx[b, lo_h:hi_h, lo_w:hi_w, c0:c0 + cn] = \
                    dxt[lo_h - dy0:hi_h - dy0, lo_w - dx0:hi_w - dx0, :cn]
        partial[slot, :, c0:c0 + min(cb, C - c0)] = acc.reshape(k * k, cb)[:, :C - c0]
    lanes = []
    for lane in range(32):
        sl = torch.zeros(k * k, C, dtype=x.dtype)
        for i in range(lane, partial.shape[0], 32):
            sl = sl + partial[i]
        lanes.append(sl)
    dk = lanes[0]
    for sl in lanes[1:]:
        dk = dk + sl
    return dx.permute(0, 3, 1, 2), dk.t().reshape(C, 1, k, k).to(weight.dtype)


def _taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(C, 1, k, k) → (k*k, C) float32 tap table, tap t = ky*k + kx; taps
    are rounded to the activations' dtype first, as the plain version's
    conv sees them."""
    C, k = weight.shape[0], weight.shape[-1]
    return weight.detach().to(dtype).reshape(C, k * k).t().float().contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x: torch.Tensor, weight: torch.Tensor, stride: int, dilation, window=None):
    """One launch of the forward kernel, by :func:`_fwd_plan`'s plan (none
    for a window of no output rows)."""
    _check_channels_last(x)
    k = weight.shape[-1]
    B, C, H, W, Ho, Wo, dh, dw, pt, pl = _geometry(x, k, stride, dilation, window)
    y = torch.empty(
        (B, C, Ho, Wo), dtype=x.dtype, device=x.device,
        memory_format=torch.channels_last,
    )
    if y.numel() == 0:
        return y
    taps = _taps(weight, x.dtype)
    plan = _fwd_plan(B, C, H, W, k, stride, (dh, dw), x.dtype, _ptr_align(x, y), window)
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
    _count(f"depthwise_fwd_s{stride}", x.dtype)
    return y


def _launch_backward(x, weight, g, stride: int, dilation, want_dx: bool, want_dk: bool,
                     window=None):
    """(dx or None, dweight or None) from one launch of the CUDA backward,
    by :func:`_bwd_plan`'s plan; dk's final sum is a second, small kernel
    of the same call.  A window of no output rows launches nothing."""
    _check_channels_last(x)
    k = weight.shape[-1]
    B, C, H, W, Ho, Wo, dh, dw, pt, pl = _geometry(x, k, stride, dilation, window)
    if tuple(g.shape) != (B, C, Ho, Wo) or g.dtype != x.dtype:
        raise ValueError(f"depthwise_conv backward: g {tuple(g.shape)} {g.dtype} for x {tuple(x.shape)} {x.dtype}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("depthwise_conv backward: g must be contiguous in channels_last memory")
    if not (want_dx or want_dk):
        return None, None
    if g.numel() == 0 or x.numel() == 0:
        return (torch.zeros_like(x, memory_format=torch.channels_last) if want_dx else None,
                torch.zeros_like(weight) if want_dk else None)
    taps = dx = dk = partial = None
    if want_dx:
        taps = _taps(weight, x.dtype)
        dx = torch.empty_like(x, memory_format=torch.channels_last)
    plan = _bwd_plan(B, C, H, W, k, stride, (dh, dw), x.dtype,
                     _ptr_align(*(t for t in (x, g, dx) if t is not None)), window)
    if want_dk:
        f32 = dict(dtype=torch.float32, device=x.device)
        partial = torch.empty(plan.dk_buffer, **f32)
        dk = torch.empty((C, 1, k, k), **f32)
    fn = _build.function(
        "depthwise_bwd", "dw_bwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 27 + [ctypes.c_void_p],
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), g.data_ptr(), ptr(taps), ptr(dx), ptr(dk), ptr(partial),
            _DTYPE_CODE[x.dtype], B, H, W, C, Ho, Wo, k, stride, dh, dw, pt, pl,
            _VARIANT_CODE[plan.variant], plan.vec, plan.nv, plan.r, plan.strips, plan.th,
            plan.cblocks, plan.tiles_w, plan.nty, plan.walk, plan.stages, plan.grid[0],
            plan.grid[1], plan.smem, _stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"depthwise_bwd launch failed: CUDA error {rc}")
    _count(f"depthwise_bwd_s{stride}", x.dtype)
    return dx, (None if dk is None else dk.to(weight.dtype))


# The forward launches are custom operators (``torch.library``), so that
# ``torch.export`` records them as one node each with the fake kernel's
# shape, dtype and strides (it cannot trace through the ctypes launch); a
# process that loads an exported program imports this module first.  Their
# gradients are the backward kernels (``register_autograd``).

def _op_window(ho: int, pad_t: int):
    """The operators' (ho, pad_t) arguments as a window (−1: TF ``SAME``)."""
    return None if ho < 0 else (ho, pad_t)


@torch.library.custom_op("dlv3_port::depthwise_fwd", mutates_args=())
def _depthwise_fwd_op(x: torch.Tensor, weight: torch.Tensor, stride: int, dh: int,
                      dw: int, ho: int = -1, pad_t: int = -1) -> torch.Tensor:
    """K2/K3: one launch of the NHWC forward kernel; ``ho`` ≥ 0 with
    ``pad_t``: a row window's output rows and top padding."""
    return _launch(x, weight, stride, (dh, dw), _op_window(ho, pad_t))


@_depthwise_fwd_op.register_fake
def _(x, weight, stride, dh, dw, ho=-1, pad_t=-1):
    B, C, H, W = x.shape
    return torch.empty((B, C, -(-H // stride) if ho < 0 else ho, -(-W // stride)), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


def _depthwise_fwd_setup(ctx, inputs, output):
    x, weight, stride, dh, dw, ho, pad_t = inputs
    ctx.save_for_backward(x, weight)
    ctx.stride, ctx.dilation, ctx.window = stride, (dh, dw), _op_window(ho, pad_t)


def _depthwise_fwd_backward(ctx, g):
    """K4/K5 as the gradient: saves x and the weight (no padded copies); a
    frozen weight or input skips its half of the backward."""
    x, weight = ctx.saved_tensors
    g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
    dx, dweight = _launch_backward(
        x, weight, g, ctx.stride, ctx.dilation, *ctx.needs_input_grad[:2], window=ctx.window
    )
    return dx, dweight, None, None, None, None, None


torch.library.register_autograd("dlv3_port::depthwise_fwd", _depthwise_fwd_backward,
                                setup_context=_depthwise_fwd_setup)


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
        raise TypeError(f"depthwise_cf: CUDA kernel takes float32/bfloat16/float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("depthwise_cf: x must be NCHW-contiguous")
    if x.numel() >= 2**31 or max(x.shape[:2]) > 65535:
        raise ValueError(f"depthwise_cf: shape {tuple(x.shape)} too large for the kernel's grid")


# K6's plan constants, each the best, or within the spread of the best,
# of the rows a thread and walks timed at Xception's sites on an H100
# (PERF.md §6)
_CF_FWD_THREADS = 256     # threads a block at most
_CF_FWD_VEC_ELEMS = 32    # outputs a vec thread computes a tile: 8 rows of 4 float32, 4 of 8 16-bit
_CF_FWD_FLAT_BYTES = 64   # bytes of a flat thread's column a tile: 16 float32 rows, 32 16-bit
_CF_FWD_VEC_WALK_BYTES = 65536  # input bytes a vec block walks
_CF_FWD_FLAT_WALK = 2     # tiles a flat block walks
_CF_FWD_WALK = 8          # most tiles a block walks
_SMS = 132                # the H100's streaming multiprocessors


@dataclasses.dataclass(frozen=True)
class CfFwdPlan:
    """How ``csrc/depthwise_cf.cu`` ``dw_cf_fwd`` (K6) computes one call.

    The B·C planes are one image of B·C·H rows in memory.  A tile is ``th``
    whole rows of it: ``planes`` whole planes (``th`` = planes·H), or with
    ``planes`` 1, ``tiles`` tiles of one plane.  ``mode`` says how a window
    (the tile and one row above and below) reaches shared memory: ``vec``
    (each row by 16-byte copies into a padded row) or ``flat`` (the window's
    rows as the one contiguous run they are, whatever W and the alignment),
    and how outputs leave: ``vec``, thread (tx, ty) computes the 16-byte
    strip at column V·tx of rows ty·r … ty·r + r − 1, one vector store a
    row; ``flat``, thread tx computes columns tx, tx + ncx, … into a shared
    copy of the tile's output run, copied out by 16-byte chunks.  A block of
    ``ncx`` × ``nry`` threads walks ``walk`` consecutive tiles, the next
    tile's window copied while it computes on the current one."""

    mode: str
    ncx: int
    nry: int
    r: int
    planes: int
    tiles: int
    walk: int
    smem: int
    batch: int
    channels: int
    height: int

    @property
    def th(self) -> int:
        return self.nry * self.r

    @property
    def threads(self) -> int:
        return self.ncx * self.nry

    @property
    def positions(self) -> int:
        n = self.batch * self.channels
        return -(-n // self.planes) if self.planes > 1 else n * self.tiles

    @property
    def grid(self) -> tuple[int]:
        return (-(-self.positions // self.walk),)

    def tile(self, n: int) -> tuple[int, int]:
        """(first row of the B·C·H, rows) of tile n."""
        H = self.height
        if self.planes > 1:
            t0 = n * self.th
            return t0, min(self.th, self.batch * self.channels * H - t0)
        p, t = divmod(n, self.tiles)
        return p * H + t * self.th, min(self.th, H - t * self.th)

    def blocks(self):
        """(block, [(first row, rows), ...] of its walk), in the kernel's
        order."""
        for blk in range(self.grid[0]):
            yield blk, [self.tile(n) for n in range(blk * self.walk,
                                                     min((blk + 1) * self.walk, self.positions))]


def _cf_fwd_smem(mode: str, W: int, th: int, itemsize: int) -> int:
    """``dw_cf_fwd``'s shared bytes: two windows, and for ``flat`` the
    tile's output run with a 16-byte chunk of slack."""
    pad = 16 // itemsize
    if mode == "vec":  # the next row's pad columns are a row's right halo
        buf = (th + 2) * (W + pad) + pad
    else:  # a 16-byte chunk of slack on each side of the run, 16-byte aligned
        buf = -(-((th + 2) * W + 3 * pad) // pad) * pad
    out = (th * W + 2 * pad - 1) // pad * pad if mode == "flat" else 0
    return (_CF_STAGES * buf + out) * itemsize


def _cf_fwd_make(mode: str, B: int, C: int, H: int, W: int, itemsize: int, ncx: int,
                 nry: int, r: int, planes: int) -> CfFwdPlan | None:
    """The plan of that block and tile, a ``vec`` block walking
    ``_CF_FWD_VEC_WALK_BYTES`` of input (at most ``_CF_FWD_WALK`` tiles), a
    ``flat`` one ``_CF_FWD_FLAT_WALK`` tiles, fewer where the grid would
    keep less than two blocks for each of the 132 SMs; None where its
    shared memory passes the H100's 227 KB a block."""
    th = nry * r
    tiles = 1 if planes > 1 else -(-H // th)
    smem = _cf_fwd_smem(mode, W, th, itemsize)
    if smem > 227 * 1024:
        return None
    plan = CfFwdPlan(mode, ncx, nry, r, planes, tiles, 1, smem, B, C, H)
    walk = (_CF_FWD_VEC_WALK_BYTES // (min(th, H * planes) * W * itemsize) if mode == "vec"
            else _CF_FWD_FLAT_WALK)
    walk = min(_CF_FWD_WALK, walk, plan.positions // (2 * _SMS))
    return dataclasses.replace(plan, walk=max(1, walk))


@functools.lru_cache(maxsize=512)
def _cf_fwd_plan(B: int, C: int, H: int, W: int, dtype: torch.dtype, ptr_align: int) -> CfFwdPlan:
    """K6's plan for one call, from the shape alone.

    - Mode: ``vec`` where W is a multiple of 16 bytes, x and y are 16-byte
      aligned (``ptr_align``) and a row fits one block's strips (W ≤ 256
      vectors); else ``flat`` (W = 253 and 127, a misaligned view).
    - ``vec``: ⌈W/V⌉ strips of V = 16 bytes of outputs × up to 256 threads,
      r rows a thread (``_CF_FWD_VEC_ELEMS`` outputs: 8 rows in float32, 4
      in 16 bits).  Where two or more planes fit those rows and r divides H,
      a tile is that many whole planes (a 32² plane is 32 rows of 8 float32
      or 4 16-bit strips: 8 planes a tile), so every thread's rows lie in
      one plane; else the plane is cut into tiles of those rows.
    - ``flat``: the row's columns rounded up to a warp (at most 256
      threads) × one row of threads, ``_CF_FWD_FLAT_BYTES`` of a column a
      thread (16 float32 rows, 32 16-bit): tiles of those rows of one
      plane, shorter where the windows and the output run would pass
      227 KB.
    - Walk: ``_CF_FWD_VEC_WALK_BYTES`` of input a ``vec`` block,
      ``_CF_FWD_FLAT_WALK`` tiles a ``flat`` one, fewer where the grid
      would keep less than two blocks for each of the 132 SMs."""
    itemsize = dtype.itemsize
    V = 16 // itemsize
    if W % V == 0 and ptr_align % 16 == 0 and W <= V * _CF_FWD_THREADS:
        plan = _cf_fwd_vec(B, C, H, W, itemsize, _CF_FWD_VEC_ELEMS // V)
        if plan is not None:
            return plan
    r = min(_CF_FWD_FLAT_BYTES // itemsize, H)
    while True:
        plan = _cf_fwd_flat(B, C, H, W, itemsize, r)
        if plan is not None:
            return plan
        if r == 1:
            raise ValueError(f"depthwise_cf forward plan: W={W} fits no block's shared memory")
        r //= 2


def _cf_fwd_vec(B: int, C: int, H: int, W: int, itemsize: int, r: int) -> CfFwdPlan | None:
    """The ``vec`` plan with r rows a thread: W/V strips × as many rows of
    threads as 256 threads allow; whole planes a tile where two or more
    fit and r divides H, else tiles of those rows."""
    ncx = W // (16 // itemsize)
    rows = _CF_FWD_THREADS // ncx * r
    planes = min(rows // H, B * C) if H % r == 0 else 1
    if planes > 1:
        nry = planes * H // r
    else:
        planes, nry = 1, max(1, min(_CF_FWD_THREADS // ncx, -(-H // r)))
    return _cf_fwd_make("vec", B, C, H, W, itemsize, ncx, nry, r, planes)


def _cf_fwd_flat(B: int, C: int, H: int, W: int, itemsize: int, r: int) -> CfFwdPlan | None:
    """The ``flat`` plan of r-row tiles, a block of the row's columns
    rounded up to a warp (at most 256) × one row of threads."""
    ncx = min(_CF_FWD_THREADS, -(-W // 32) * 32)
    return _cf_fwd_make("flat", B, C, H, W, itemsize, ncx, 1, r, 1)


def depthwise_cf_forward_emulation(x: torch.Tensor, weight: torch.Tensor, plan: CfFwdPlan) -> torch.Tensor:
    """K6's decomposition in PyTorch, for tests: walks the plan's blocks and
    tiles in the kernel's order over the B·C·H-row image and computes each
    tile from its window alone (its rows and one row above and below, zero
    outside the tensor and at the columns' ends).  The row above an output
    counts only where the output is not its plane's first row, the row
    below only where it is not its plane's last, so the rows of a
    neighbouring plane in the window are masked.  Each thread's rows take
    the taps of the plane of its first row (rows ty·r …), as the kernel
    loads them.
    Rows past a tile's end are computed and dropped, as the kernel masks
    its stores."""
    B, C, H, W = x.shape
    th = plan.th
    img = F.pad(x.reshape(B * C * H, W), (1, 1, 1, th + 1))  # image row i at i + 1
    taps = weight.reshape(C, 9).to(x.dtype)
    y = torch.full_like(img[1:1 + B * C * H, 1:1 + W], float("nan"))
    q = torch.arange(th)
    first = q // plan.r * plan.r
    for _, walk in plan.blocks():
        for t0, rows in walk:
            win = img[t0:t0 + th + 2]  # window row k: image row t0 - 1 + k
            h = (t0 + q) % H
            tap = taps[(t0 + first) // H % C]  # (th, 9): each row's thread's plane's taps
            keep = (h > 0, torch.ones_like(h, dtype=torch.bool), h < H - 1)
            out = 0
            for dy in range(3):
                for dx in range(3):
                    v = torch.where(keep[dy][:, None], win[dy:dy + th, dx:dx + W], 0)
                    out = out + v * tap[:, 3 * dy + dx, None]
            y[t0:t0 + rows] = out[:rows]
    return y.reshape(B, C, H, W)


def depthwise_cf(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K6 alone: the 3×3 stride-1 SAME depthwise conv of an NCHW-contiguous
    x, NCHW-contiguous out, by :func:`_cf_fwd_plan`'s plan (one launch).
    The plain version on a CPU tensor.  A ``dlv3.dw_site`` profiler range."""
    with span("dlv3.dw_site"):
        return _cf_forward(x, weight)


def _cf_forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_conv_plain(x, weight)
    _check_cf(x, weight)
    B, C, H, W = x.shape
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    return _cf_fwd_launch(x, _cf_fwd_taps(weight), y, _cf_fwd_plan(B, C, H, W, x.dtype, _ptr_align(x, y)))


def _cf_fwd_taps(weight: torch.Tensor) -> torch.Tensor:
    """(C, 1, 3, 3) → the (9, C) float32 tap table, tap t = 3·dy + dx, in
    one copy; K6 rounds the taps to the activations' dtype itself."""
    C = weight.shape[0]
    return torch.empty((9, C), dtype=torch.float32, device=weight.device).copy_(
        weight.detach().reshape(C, 9).t())


def _cf_fwd_launch(x: torch.Tensor, taps: torch.Tensor, y: torch.Tensor, plan: CfFwdPlan) -> torch.Tensor:
    """One launch of K6 by ``plan`` into ``y``; raises where the kernel
    refuses the plan or the launch fails."""
    B, C, H, W = x.shape
    fn = _build.function("depthwise_cf", "dw_cf_fwd",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), taps.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype], B, C, H, W,
                _CF_MODE[plan.mode], plan.ncx, plan.nry, plan.r, plan.planes, plan.tiles,
                plan.walk, plan.smem, _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise_cf launch failed: CUDA error {rc} (plan {plan})")
    _count("depthwise_fwd_cf", x.dtype)
    return y


_CF_MODE = {"vec": 0, "flat": 1}
_CF_THREADS = 256   # threads a K7 block at most
_CF_VEC_R = 4       # rows a vec thread computes
_CF_VEC_NRY = 8     # rows of vec threads: a 32-row tile
_CF_FLAT_ROWS = 16  # rows of a flat tile
_CF_WALK = 2        # tiles a block walks
_CF_STAGES = 2      # csrc/depthwise_cf.cu STAGES: window pairs a block holds


@dataclasses.dataclass(frozen=True)
class CfBwdPlan:
    """How ``csrc/depthwise_cf.cu`` ``dw_cf_bwd`` (K7) computes one call.

    A tile is ``th`` whole rows of a plane, ``tiles`` tiles a plane.
    ``mode`` says how a window (the tile and a one-pixel halo) reaches
    shared memory: ``vec`` (each row by 16-byte copies into a padded row;
    thread (tx, ty) computes columns 4·tx … 4·tx + 3) or ``flat`` (the
    window's rows as the one contiguous run of the plane they are, by
    16-byte copies whatever the alignment; thread (tx, ty) computes columns
    tx, tx + ncx, …).  Either way it computes rows ty·r … ty·r + r − 1 of
    each tile.  A block of ``ncx`` × ``nry`` threads owns one channel and
    walks ``walk`` tiles of the flattened (image, tile) index, the next
    tile's x and g windows copied while it computes on the current one's.
    ``groups`` blocks share a
    channel's tiles; with more than one, each writes a row of a (groups, 9,
    C) buffer and a final pass adds the rows."""

    mode: str
    ncx: int
    nry: int
    r: int
    tiles: int
    walk: int
    groups: int
    smem: int
    batch: int
    channels: int

    @property
    def th(self) -> int:
        return self.nry * self.r

    @property
    def threads(self) -> int:
        return self.ncx * self.nry

    @property
    def grid(self) -> tuple[int, int]:
        return self.channels, self.groups

    def blocks(self):
        """(group, [(b, first row), ...] of its walk) of the blocks of any
        one channel, in the kernel's order."""
        n = self.batch * self.tiles
        for grp in range(self.groups):
            yield grp, [(pos // self.tiles, pos % self.tiles * self.th)
                        for pos in range(grp * self.walk, min((grp + 1) * self.walk, n))]


def _cf_smem(mode: str, W: int, th: int, threads: int, itemsize: int) -> int:
    """``dw_cf_bwd``'s shared bytes: two pairs of an x and a g window, or the (9, threads rounded up to a power of two) table of dk
    sums that overlays them after the walk."""
    pad = 16 // itemsize
    if mode == "vec":  # the next row's pad columns are a row's right halo
        buf = (th + 2) * (W + pad) + pad
    else:  # a 16-byte chunk of slack on each side of the run, 16-byte aligned
        buf = -(-((th + 2) * W + 3 * pad) // pad) * pad
    return max(2 * _CF_STAGES * buf * itemsize, 9 * 4 * (1 << (threads - 1).bit_length()))


def _cf_mode(W: int, itemsize: int, ptr_align: int) -> str:
    """``vec`` where W is a multiple of 16 bytes, x, g and dx are 16-byte
    aligned and a row fits one block's strips (W ≤ 1024), else ``flat``.
    ``flat`` computes any W too, but ``vec`` took 2–4 % less time at each
    of Xception's 64² and 32² sites on an H100 (PERF.md §6, PR 6)."""
    return "vec" if W % (16 // itemsize) == 0 and ptr_align % 16 == 0 and W <= 4 * _CF_THREADS else "flat"


def _cf_make(mode: str, B: int, C: int, H: int, W: int, itemsize: int, ncx: int, nry: int, r: int,
             walk: int):
    """The plan of that block and walk, or None where its shared memory
    passes the H100's 227 KB a block."""
    threads, th = ncx * nry, nry * r
    tiles = -(-H // th)
    walk = min(walk, B * tiles)
    groups = -(-B * tiles // walk)
    smem = _cf_smem(mode, W, th, threads, itemsize)
    if smem > 227 * 1024 or groups > 65535:
        return None
    return CfBwdPlan(mode, ncx, nry, r, tiles, walk, groups, smem, B, C)


@functools.lru_cache(maxsize=512)
def _cf_bwd_plan(B: int, C: int, H: int, W: int, dtype: torch.dtype, ptr_align: int) -> CfBwdPlan:
    """K7's plan for one call, from the shape alone (so the order of dk's
    float sums depends on the shape alone).

    - Mode: ``vec`` where W is a multiple of 16 bytes, x, g and dx are
      16-byte aligned (``ptr_align``) and W ≤ 1024; else ``flat`` (W =
      253 and 127: rows of 1012 and 508 float32 bytes).
    - Block: ``vec``, ⌈W/4⌉ strips × up to 8 rows of threads (at most 256
      threads), 4 rows a thread: a 32-row tile, so a 32² plane is one tile
      of 64 threads and a 64² plane two of 128.  ``flat``, the row's columns
      rounded up to a warp (at most 256 threads, each then taking columns
      tx, tx + 256, …) × one row of threads, 16 rows a thread: 16-row tiles.
      Shorter ones where two window pairs of the row would pass 227 KB.
    - Walk ``_CF_WALK`` tiles, so a channel has ⌈B·tiles/2⌉ groups of
      blocks, whose dk rows a final pass adds: a block's second tile's
      copies overlap its first tile's compute, and the grid keeps
      C·B·tiles/2 blocks to spread over the H100's 132 SMs."""
    itemsize = dtype.itemsize
    mode = _cf_mode(W, itemsize, ptr_align)
    if mode == "vec":
        ncx = -(-W // 4)
        nry = max(1, min(_CF_VEC_NRY, _CF_THREADS // ncx, -(-H // _CF_VEC_R)))
        r = _CF_VEC_R
    else:
        ncx = min(_CF_THREADS, -(-W // 32) * 32)
        nry, r = 1, min(_CF_FLAT_ROWS, H)
    while True:
        plan = _cf_make(mode, B, C, H, W, itemsize, ncx, nry, r, _CF_WALK)
        if plan is not None:
            return plan
        if r == 1:
            raise ValueError(f"depthwise_cf backward plan: W={W} fits no block's shared memory")
        r //= 2


def depthwise_cf_backward_emulation(
    x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, plan: CfBwdPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's decomposition in PyTorch, for tests: every channel at once,
    walks the plan's blocks in the kernel's order and returns (dx,
    dweight).  Each tile's dx comes only from its g window (the tile's
    rows and a one-pixel halo, zero outside the image) with the taps
    reversed, its dk only from its x window and the g tile; dk is summed per
    block over its walk, then, with several groups, as the final pass sums
    the rows: lane l takes rows l, l + 8, … in order, then the lanes in
    order.  dx outside the image is computed and dropped, as the kernel
    masks its stores."""
    B, C, H, W = x.shape
    th = plan.th
    rev = weight.reshape(C, 3, 3).to(x.dtype).flip(1, 2)[:, :, :, None, None]
    pad = (1, 1, 1, plan.tiles * th + 1 - H)
    xp, gp = F.pad(x, pad), F.pad(g, pad)
    dx = torch.full_like(x, float("nan"))
    partial = torch.zeros(plan.groups, C, 3, 3, dtype=x.dtype)
    for grp, walk in plan.blocks():
        for b, h0 in walk:
            xw = xp[b, :, h0:h0 + th + 2]
            gw = gp[b, :, h0:h0 + th + 2]
            dxt = sum(gw[:, ky:ky + th, kx:kx + W] * rev[:, ky, kx]
                      for ky in range(3) for kx in range(3))
            gt = gw[:, 1:1 + th, 1:1 + W]
            for ky in range(3):
                for kx in range(3):
                    partial[grp, :, ky, kx] += (xw[:, ky:ky + th, kx:kx + W] * gt).sum((1, 2))
            hn = min(th, H - h0)
            dx[b, :, h0:h0 + hn] = dxt[:, :hn]
    if plan.groups == 1:
        dk = partial[0]
    else:
        lanes = [sum((partial[i] for i in range(lane, plan.groups, 8)), torch.zeros_like(partial[0]))
                 for lane in range(8)]
        dk = lanes[0]
        for sl in lanes[1:]:
            dk = dk + sl
    return dx, dk.reshape(C, 1, 3, 3).to(weight.dtype)


def depthwise_cf_backward(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                          want_dx: bool = True, want_dk: bool = True):
    """K7 alone: (dx or None, dweight or None) of :func:`depthwise_cf` for
    the output gradient ``g``, all NCHW-contiguous, by :func:`_cf_bwd_plan`'s
    plan (one launch, and the final dk pass where the plan has several
    groups).  The plain backward on CPU tensors."""
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
    f32 = dict(dtype=torch.float32, device=x.device)
    taps = _taps(weight, x.dtype) if want_dx else None
    dx = torch.empty_like(x, memory_format=torch.contiguous_format) if want_dx else None
    plan = _cf_bwd_plan(B, C, H, W, x.dtype, _ptr_align(*(t for t in (x, g, dx) if t is not None)))
    dk = torch.empty((C, 1, 3, 3), **f32) if want_dk else None
    partial = torch.empty((plan.groups, 9, C), **f32) if want_dk and plan.groups > 1 else None
    fn = _build.function("depthwise_cf", "dw_cf_bwd",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), g.data_ptr(), ptr(taps), ptr(dx), ptr(dk), ptr(partial),
                _DTYPE_CODE[x.dtype], B, C, H, W, _CF_MODE[plan.mode], plan.ncx, plan.nry, plan.r,
                plan.tiles, plan.walk, plan.groups, plan.smem, _stream(x))
    if rc != 0:
        raise RuntimeError(f"depthwise_cf_backward launch failed: CUDA error {rc}")
    _count("depthwise_bwd_cf", x.dtype)
    return dx, (None if dk is None else dk.to(weight.dtype))


@torch.library.custom_op("dlv3_port::depthwise_cf_fwd", mutates_args=())
def _depthwise_cf_op(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The channels-first route: x made NCHW-contiguous, K6, the result
    back in ``channels_last``."""
    return _cf_forward(x.contiguous(), weight).contiguous(memory_format=torch.channels_last)


@_depthwise_cf_op.register_fake
def _(x, weight):
    return torch.empty_like(x, memory_format=torch.channels_last)


def _depthwise_cf_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _depthwise_cf_backward(ctx, g):
    """K7 as the gradient: saves x and the weight (no padded or transposed
    copies); x and g made NCHW-contiguous, as the JAX ``_vjp_bwd``
    re-transposes them, dx returned in ``channels_last``."""
    x, weight = ctx.saved_tensors
    dx, dweight = depthwise_cf_backward(
        x.contiguous(), weight, g.to(x.dtype).contiguous(), *ctx.needs_input_grad[:2]
    )
    if dx is not None:
        dx = dx.contiguous(memory_format=torch.channels_last)
    return dx, dweight


torch.library.register_autograd("dlv3_port::depthwise_cf_fwd", _depthwise_cf_backward,
                                setup_context=_depthwise_cf_setup)


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
        raise TypeError(f"depthwise_conv: CUDA kernel takes float32/bfloat16/float16, got {x.dtype}")
    return True


def _check_channels_last(x: torch.Tensor) -> None:
    """At the launch, not in :func:`_on_card`: ``torch.export`` traces the
    operators with a symbolic batch, whose strides cannot prove it."""
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("depthwise_conv: x must be contiguous in channels_last memory")


def _cf_window(x: torch.Tensor, window) -> tuple[torch.Tensor, int]:
    """A stride-1 3×3 row window (Ho, pad_t) as the symmetric one K6/K7
    take: x cut or zero-padded to rows [−1, Ho + 1) of the window's
    outputs (stride-1 ``SAME`` is symmetric, so ``SAME`` over them and a
    crop of one row each side is the window's result).  Returns (that x,
    the rows x gained at its top, negative where it lost them)."""
    Ho, pt = int(window[0]), int(window[1])
    return F.pad(x, (0, 0, pt, Ho + 2 - pt - x.shape[2])), pt


def depthwise_conv(
    x: torch.Tensor, weight: torch.Tensor, stride: int = 1, dilation=(1, 1), window=None
) -> torch.Tensor:
    """Depthwise conv, TF ``SAME`` padding.

    x: (B, C, H, W), ``channels_last`` memory on CUDA; weight (C, 1, k, k)
    with odd k ∈ {3, 5, 7}; stride 1 (any dilation) or 2 (dilation 1).
    Returns (B, C, ⌈H/stride⌉, ⌈W/stride⌉) in ``channels_last``,
    differentiable in x and weight on both devices, through the route
    :func:`depthwise_route` names.  ``window`` (Ho, pad_t): x is a row
    window and the result its Ho output rows (module docstring).  One
    ``dlv3.dw_site`` profiler range (``utils/profiling.py``) around the pass,
    the autograd node of its operator inside it."""
    with span("dlv3.dw_site"):
        return _depthwise_conv(x, weight, stride, dilation, window)


def _depthwise_conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, dilation=(1, 1),
                    window=None) -> torch.Tensor:
    card = _on_card(x, weight, stride, dilation)
    if depthwise_route(weight, stride, dilation) == "cf":
        if window is not None:
            if int(window[0]) == 0:
                return depthwise_conv_plain(x, weight, stride, dilation, window)
            xs, _ = _cf_window(x, window)
            y = _depthwise_conv(xs.contiguous(memory_format=torch.channels_last), weight)
            return y[:, :, 1:1 + int(window[0])]
        if not card:
            return _cf_forward(x.contiguous(), weight).contiguous(memory_format=torch.channels_last)
        return _depthwise_cf_op(x, weight)
    if not card:
        return depthwise_conv_plain(x, weight, stride, dilation, window)
    ho, pad_t = (-1, -1) if window is None else (int(window[0]), int(window[1]))
    return _depthwise_fwd_op(x, weight, stride, int(dilation[0]), int(dilation[1]), ho, pad_t)


def depthwise_conv_backward(
    x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, stride: int = 1,
    dilation=(1, 1), window=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward alone: (dx, dweight) of :func:`depthwise_conv` at
    (x, weight) for the output gradient ``g``, on the same route.  The
    backward kernel on CUDA (dx in ``channels_last``), the plain backward
    on the CPU."""
    card = _on_card(x, weight, stride, dilation)
    if depthwise_route(weight, stride, dilation) == "cf":
        if window is not None:
            xs, top = _cf_window(x, window)
            gs = F.pad(g, (0, 0, 1, 1))
            dx, dk = depthwise_conv_backward(xs.contiguous(memory_format=torch.channels_last),
                                             weight, gs.contiguous(memory_format=torch.channels_last))
            dx = F.pad(dx, (0, 0, -top, x.shape[2] + top - dx.shape[2]))
            return dx.contiguous(memory_format=torch.channels_last), dk
        dx, dk = depthwise_cf_backward(x.contiguous(), weight, g.to(x.dtype).contiguous())
        return dx.contiguous(memory_format=torch.channels_last), dk
    if not card:
        return depthwise_conv_backward_plain(x, weight, g, stride, dilation, window)
    g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
    return _launch_backward(x, weight, g, stride, dilation, True, True, window)
