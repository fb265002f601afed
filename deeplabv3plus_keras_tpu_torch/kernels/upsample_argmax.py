"""Fused bilinear upsample (×s) + channel argmax: logits → class labels.

Port of the Pallas TPU kernel ``upsample_argmax``
(``deeplabv3plus_keras_tpu/kernels/upsample_argmax.py:89``, body
``_kernel`` :58).  Softmax is monotone per pixel, so
``argmax(softmax(up(x))) == argmax(up(x))``: labels come straight from the
decoder's low-resolution logits, and the (B, h·s, w·s, C) upsampled tensor
never exists.

On the card: ``csrc/upsample_argmax.cu``, laid out by
:func:`_upsample_argmax_plan`: a block copies a band of source rows and
columns with a one-pixel clamped halo, all channels, into shared memory,
and each thread computes labels blending in the JAX kernel's order: at
s = 2 (the label step) a 2 × 4 block, blending each source column's rows
once for its column phases and taking each shared product once; else a
run of 4 adjacent labels of one output row.  Its bound is memory: the logits read
once (B·h·w·C·4 bytes) and the labels written once (B·h·s·w·s·4 bytes).
:func:`upsample_argmax_band_emulation` computes the same blocks in PyTorch
for the CPU tests.

A CPU tensor takes :func:`upsample_argmax_plain`
(``F.interpolate(bilinear, align_corners=False)`` then ``argmax``, which,
like the kernel, keeps the first maximum).  A CUDA tensor launches the
kernel or raises.  The two agree except where two classes' upsampled
logits tie to within float rounding.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

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


_SMEM = 64 * 1024      # shared bytes a block's window takes, where C allows
_SMEM_MAX = 227 * 1024  # the most a block may take on the H100


def _phase_weights(s: int) -> list[tuple[int, float]]:
    """(d, w) per phase p: output q·s + p blends source q + d and q + d + 1
    with weights 1 − w and w (the JAX kernel's ``_phase_weights``, in
    double)."""
    out = []
    for p in range(s):
        off = (p + 0.5) / s - 0.5
        d = math.floor(off)
        out.append((d, off - d))
    return out


@functools.lru_cache(maxsize=64)
def _phase_table(s: int, device: torch.device) -> torch.Tensor:
    """The kernel's (2, s) float32 table on ``device``: the weights 1 − w
    of the s phases, then w (:func:`_phase_weights`, rounded to float).
    Made by the first call at each scale; the kernel derives the offsets d
    from p and s."""
    ph = _phase_weights(s)
    return torch.tensor([[1.0 - w for _, w in ph], [w for _, w in ph]], dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class UpsampleArgmaxPlan:
    """How ``csrc/upsample_argmax.cu`` computes one call: a block takes
    ``bh`` source rows × ``bw`` source columns of one image and stages them
    with a one-pixel halo as ``bh + 2`` rows × C × ``wpad`` columns of
    float32 (``smem`` bytes); ``grid`` is (column tiles, row bands, B)."""

    bh: int
    bw: int
    wpad: int
    smem: int
    grid: tuple[int, int, int]

    def blocks(self):
        """(b, first source row, first source column) of every block."""
        gx, gy, B = self.grid
        for b in range(B):
            for y in range(gy):
                for x in range(gx):
                    yield b, y * self.bh, x * self.bw


def _upsample_argmax_make(B: int, h: int, w: int, C: int, bh: int, bw: int):
    """The plan of that band, or None where it passes 227 KB or the grid's
    limits."""
    bh = min(bh, h)
    smem = (bh + 2) * C * (bw + 2) * 4
    grid = (-(-w // bw), -(-h // bh), B)
    if smem > _SMEM_MAX or grid[1] > 65535 or B > 65535:
        return None
    return UpsampleArgmaxPlan(bh, bw, bw + 2, smem, grid)


@functools.lru_cache(maxsize=256)
def _upsample_argmax_plan(B: int, h: int, w: int, C: int, s: int) -> UpsampleArgmaxPlan:
    """The plan of one call, from the shape alone.

    - Columns: 64 source columns a block (fewer, a multiple of 4, on a
      narrower map), so a tile row is 16·s runs of 4 labels.
    - Rows: a band of 8 source rows (at s = 2, 8 × 32 tasks of 2 × 4
      labels: one for each of the 256 threads), halved to 4, 2 and 1 while
      the window ((bh + 2) · C · (bw + 2) floats) exceeds 64 KiB; then the
      columns are halved down to 16, and past that the window may take up
      to 227 KiB (down to 4 columns).  At the flagship's C = 21 a block
      takes 8 × 64 (55 KB); C = 150 takes 1 × 32 (61 KB); the widest C
      that fits at all is 3228 (1 × 4 columns).  The scale does not change
      the band: every s ≥ 1 is planned."""

    def smem(bh: int, bw: int) -> int:
        return (bh + 2) * C * (bw + 2) * 4

    bw = min(64, -(-w // 4) * 4)
    bh = 8
    while bh > 1 and smem(bh, bw) > _SMEM:
        bh //= 2
    while bw > 16 and smem(bh, bw) > _SMEM:
        bw = max(16, bw // 2 // 4 * 4)
    while bw > 4 and smem(bh, bw) > _SMEM_MAX:
        bw = max(4, bw // 2 // 4 * 4)
    if smem(bh, bw) > _SMEM_MAX:
        raise ValueError(f"upsample_argmax: C={C} does not fit a block's shared memory")
    plan = _upsample_argmax_make(B, h, w, C, bh, bw)
    if plan is None:
        raise ValueError(f"upsample_argmax: grid of {(B, h, w, C)} too large")
    return plan


def upsample_argmax_band_emulation(logits: torch.Tensor, scale: int,
                                   plan: UpsampleArgmaxPlan) -> torch.Tensor:
    """The kernel's decomposition in PyTorch, for tests: each block's labels
    from its clamped window alone, with the kernel's float32 operations in
    its order (row blend a·(1−w) + b·w, then the column blend; products and
    sums rounded one by one), first maximum over C."""
    s = int(scale)
    B, h, w, C = logits.shape
    x = logits.float()
    ph = _phase_weights(s)
    d = [p[0] for p in ph]
    w0 = torch.tensor([1.0 - p[1] for p in ph], dtype=torch.float32)
    w1 = torch.tensor([p[1] for p in ph], dtype=torch.float32)
    out = torch.full((B, h * s, w * s), -1, dtype=torch.int32)
    for b, q0, p0 in plan.blocks():
        rows = (torch.arange(q0 - 1, q0 + plan.bh + 1)).clamp(0, h - 1)
        cols = (torch.arange(p0 - 1, p0 - 1 + plan.wpad)).clamp(0, w - 1)
        win = x[b][rows][:, cols]  # (bh + 2, wpad, C)
        nr, nc = min(plan.bh, h - q0) * s, min(plan.bw, w - p0) * s
        o = torch.arange(p0 * s, p0 * s + nc)
        pc = o % s
        jc = o // s + torch.tensor(d)[pc] + 1 - p0
        for ry in range(nr):
            qy, pr = divmod(ry, s)
            k0 = qy + d[pr] + 1
            rb = win[k0] * w0[pr] + win[k0 + 1] * w1[pr]  # (wpad, C)
            v = rb[jc] * w0[pc, None] + rb[jc + 1] * w1[pc, None]
            out[b, q0 * s + ry, p0 * s:p0 * s + nc] = v.argmax(-1).to(torch.int32)
    return out


def upsample_argmax(logits: torch.Tensor, scale: int) -> torch.Tensor:
    """logits (B, h, w, C) float32, C contiguous → labels (B, h·s, w·s) int32,
    s ≥ 1.

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
    if logits.numel() >= 2**31 or B * h * w * s * s >= 2**31:
        raise ValueError(f"upsample_argmax: shape {tuple(logits.shape)} x{s} too large for the kernel")
    plan = _upsample_argmax_plan(B, h, w, C, s)
    out = torch.empty((B, h * s, w * s), dtype=torch.int32, device=logits.device)
    table = _phase_table(s, logits.device)
    fn = _build.function(
        "upsample_argmax", "upsample_argmax",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2,
    )
    with torch.cuda.device(logits.device):
        rc = fn(
            logits.data_ptr(), out.data_ptr(), B, h, w, C, s, plan.bh, plan.bw, plan.wpad,
            plan.smem, table.data_ptr(), torch.cuda.current_stream(logits.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"upsample_argmax launch failed: CUDA error {rc}")
    launches["upsample_argmax"] += 1
    return out
