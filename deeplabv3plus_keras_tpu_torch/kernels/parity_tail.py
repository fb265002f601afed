"""The parity-decomposed training tail as two CUDA kernels, T1 and T2.

Not a port of a Pallas kernel: the port's form of the jnp function
``tail_loss_cm`` (``deeplabv3plus_keras_tpu/ops/parity_tail.py:84``), which
XLA fuses on the TPU and eager PyTorch would not.  From the decoder's
half-resolution logits (B, H, W, C) and the full-resolution labels:

- T1 (:func:`parity_tail_forward`) forms, for each half-resolution site,
  the four parity values of every class (the ×2 half-pixel bilinear
  upsample, edges clamped), their softmax over C and the class-balanced
  loss of each full-resolution pixel, and writes a per-sample loss sum
  (B,) float32 and the (C, C) int32 confusion matrix of the samples with
  ``valid != 0``;
- T2 (:func:`parity_tail_backward`) writes dlogits (B, H, W, C) in the
  logits' dtype from the logits, the labels and a per-sample scale
  (``valid_b / denominator × ∂L``, what autograd hands the per-sample
  sums): each logit gathers its 4 × 4 full-resolution neighbourhood
  through the transposed lerp.

Nothing but the logits, the labels, dlogits, the (B,) sums and scales, the
(C, C) matrix and a (B, blocks) buffer of T1's block sums is read or
written: no plane, probability or gradient of the full resolution.  Both
are deterministic (fixed-order sums; integer atomics for the matrix).  For
C ≤ 32 a thread keeps its pixel's C values in registers and makes one pass
over them; the plan picks that instantiation, or the multi-pass one for
larger C, from C alone.

A row window (``window``, under ``mesh_space``): the logits' first and
last rows are context only, fetched from the neighbouring ranks.  Only the
sites of rows 1 .. H − 2 are computed and counted, the labels hold their
2(H − 2) rows, and T2's dlogits of the context rows are those rows' share
of the own sites' gradient (no pixel of theirs contributes), which the
fetch's transpose returns to their owners.  T1's tiles cover the own sites
alone; T2's cover every row, as it writes every row's dlogits.

``csrc/parity_tail.cu`` is laid out by :func:`_parity_tail_plan`; its
tiles are walked on the CPU by :func:`parity_tail_forward_emulation` and
:func:`parity_tail_backward_emulation` for the tests.  A CPU tensor takes
the plain versions (:func:`parity_tail_forward_plain`, the autograd of it
for :func:`parity_tail_backward_plain`); a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build

# Launches of the CUDA kernels; each wrapper adds one per call.
launches = {"parity_tail_fwd": 0, "parity_tail_bwd": 0}

_LOGIT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LABEL_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int64: 3, torch.int32: 4}

_SMEM_SOFT = 96 * 1024   # a block's shared memory, where C allows
_SMEM_MAX = 227 * 1024   # the most a block may take on the H100
_HIST_MAX = 32 * 1024    # T1's block confusion matrix in shared memory up to this
_CLASS_BOUNDS = (8, 16, 24, 32)  # the register instantiations' class bounds
_WALK = 4                # tiles a block walks down the rows


@dataclasses.dataclass(frozen=True)
class ParityTailPlan:
    """How ``csrc/parity_tail.cu`` cuts one call.  A tile is ``tr`` × ``tw``
    half-resolution sites of one image; a block of either kernel walks
    ``walk`` tiles down the rows (``grid`` = (column tiles, row-tile groups,
    B); ``rows`` row tiles in all).  The next tile's logits window (a
    one-site clamped halo) and one-hot label rows are copied as they are,
    by 16-byte asynchronous copies, into raw rows of shared memory while the
    current tile is computed; the window is then converted to (tr + 2) ×
    (tw + 2) × ``cp`` float32, ``cp`` odd so that neighbouring threads
    reading one class hit distinct banks.

    ``cmax`` is the instantiation: the least of 8, 16, 24, 32 that holds C,
    whose threads keep a pixel's C parity values in registers and make one
    branch-free pass over all ``cmax`` classes (``cp`` = cmax + 1, the
    classes past C padded; T1's probabilities then through a row a pixel of
    shared memory, for a rolled pass of logs), or 0 for C > 32 (``cp`` = C
    rounded up to odd, one tile a block): the values recomputed from the
    window in three (T1) or four (T2) passes, the labels read from device
    memory.  What bounds them is the per-class arithmetic of every
    full-resolution pixel, above the bytes even with one-hot labels.

    T1: a thread per full-resolution pixel of a tile (``fwd_threads``), its
    losses summed into one partial value a block and its matrix counted in
    shared memory (``hist``, else straight into the output) across the
    walk.  T2: a thread per pixel of the (2·tr + 2) × (2·tw + 2) region a
    tile's gradient reaches (``bwd_threads``), then a thread per (site
    column, class) down the tile's rows.  Float32 one-hot labels at an odd C
    are read from their raw rows in place (the stride C odd: no bank
    conflicts; double-buffered along the walk), other one-hot labels
    converted to the stride ``cp``.  A block's shared memory: ``*_smem``
    with one-hot labels converted, ``*_smem_direct`` read in place,
    ``*_smem_int`` with integer labels.

    T1's tiles cover site rows [``s0``, ``s1``) (a row window: [1, H − 1)),
    ``rows`` row tiles from ``s0``; T2's cover [0, H), ``bwd_rows`` row
    tiles in ``bwd_grid``."""

    tr: int
    tw: int
    cp: int
    cmax: int
    walk: int
    fwd_threads: int
    bwd_threads: int
    hist: bool
    fwd_smem: int
    fwd_smem_int: int
    fwd_smem_direct: int
    bwd_smem: int
    bwd_smem_int: int
    bwd_smem_direct: int
    grid: tuple[int, int, int]
    rows: int  # T1's row tiles
    s0: int
    s1: int
    bwd_grid: tuple[int, int, int]
    bwd_rows: int

    def blocks(self, kernel: str = "fwd"):
        """(b, [(first row, first column) of each tile it walks]) of every
        block of T1 (``"fwd"``, in its partial-sum order within an image)
        or T2 (``"bwd"``)."""
        fwd = kernel == "fwd"
        gx, gy, B = self.grid if fwd else self.bwd_grid
        rows, first = (self.rows, self.s0) if fwd else (self.bwd_rows, 0)
        for b in range(B):
            for y in range(gy):
                for x in range(gx):
                    yield b, [(first + t * self.tr, x * self.tw)
                              for t in range(y * self.walk, min((y + 1) * self.walk, rows))]


def _round_threads(n: int) -> int:
    return -(-n // 32) * 32


def _parity_tail_make(B: int, H: int, W: int, C: int, tr: int, tw: int,
                      walk: int | None = None, window: bool = False) -> ParityTailPlan:
    cmax = next((k for k in _CLASS_BOUNDS if C <= k), 0)
    cp = cmax + 1 if cmax else C | 1
    win = (tr + 2) * (tw + 2) * cp * 4
    region = (2 * tr + 2) * (2 * tw + 2) * cp * 4
    s0, s1 = (1, H - 1) if window else (0, H)
    rows, bwd_rows = -(-(s1 - s0) // tr), -(-H // tr)
    def raw(n_rows, n):  # raw rows of n elements: 16-byte chunks at any alignment, 4-byte elements
        return 16 * n_rows * ((n * 4 + 15) // 16 + 1)

    fwd_int = raw(tr + 2, (tw + 2) * C) + 4 * 32 + win
    bwd_int = raw(tr + 2, (tw + 2) * C) + win + region
    if cmax:
        hist, walk = True, walk or min(_WALK, rows)
        fwd_int += 4 * tr * tw * cp * 4  # the probabilities, a row a pixel
        # and the one-hot labels, raw and staged
        fwd = fwd_int + raw(2 * tr, 2 * tw * C) + 4 * tr * tw * cp * 4
        direct = fwd_int + 2 * raw(2 * tr, 2 * tw * C)
        bwd = bwd_int + raw(2 * tr + 2, (2 * tw + 2) * C)
        bwd_direct = bwd_int + 2 * raw(2 * tr + 2, (2 * tw + 2) * C)
    else:  # C > 32: the multi-pass kernels, one tile a block, the labels from device memory
        hist, walk = C * C * 4 <= _HIST_MAX, 1
        fwd = direct = fwd_int
        bwd = bwd_direct = bwd_int
    hist_bytes = C * C * 4 if hist else 0
    return ParityTailPlan(tr, tw, cp, cmax, walk, _round_threads(4 * tr * tw),
                          _round_threads((2 * tr + 2) * (2 * tw + 2)), hist, fwd + hist_bytes,
                          fwd_int + hist_bytes, direct + hist_bytes, bwd, bwd_int, bwd_direct,
                          (-(-W // tw), -(-rows // walk), B), rows, s0, s1,
                          (-(-W // tw), -(-bwd_rows // walk), B), bwd_rows)


@functools.lru_cache(maxsize=256)
def _parity_tail_plan(B: int, H: int, W: int, C: int, window: bool = False) -> ParityTailPlan:
    """The plan of one call, from the shape alone: tiles of 4 × 16 sites
    walked 4 at a time (T1 256 threads, T2 352; at the flagship's C = 21 the
    C ≤ 24 instantiation: T1 91 KB and T2 112 KB with float32 one-hot
    labels, 48 KB and 54 KB with integer ones), halving the columns and then
    the rows while a kernel's shared memory with converted one-hot labels
    passes 96 KB.  Raises ``ValueError`` where even one site a block passes
    227 KB.  ``window``: T1's tiles from site row 1 to H − 2 (module
    docstring)."""
    if window and H < 3:
        raise ValueError(f"parity_tail: a row window of {H} rows holds no site")
    tr, tw = 4, 16
    plan = _parity_tail_make(B, H, W, C, tr, tw, window=window)
    while max(plan.fwd_smem, plan.bwd_smem) > _SMEM_SOFT and (tr, tw) != (1, 1):
        if tw > 1:
            tw //= 2
        else:
            tr //= 2
        plan = _parity_tail_make(B, H, W, C, tr, tw, window=window)
    if max(plan.fwd_smem, plan.bwd_smem) > _SMEM_MAX:
        raise ValueError(f"parity_tail: C={C} does not fit a block's shared memory")
    if plan.bwd_grid[1] > 65535 or B > 65535:
        raise ValueError(f"parity_tail: grid of {(B, H, W, C)} too large")
    return plan


# --------------------------------------------------------------------------
# plain versions


def parity_tail_forward_plain(logits, label, pos_weights, neg_weights, valid=None,
                              epsilon: float = 1e-7, window: bool = False):
    """What T1 computes, in PyTorch: (per-sample loss sums (B,), cm)."""
    from ..ops.parity_tail import tail_per_pixel

    per_pixel, cm = tail_per_pixel(logits, label, pos_weights, neg_weights, logits.shape[-1],
                                   valid, epsilon, window)
    return per_pixel.sum((1, 2)), cm


def parity_tail_backward_plain(logits, label, pos_weights, neg_weights, scale,
                               epsilon: float = 1e-7, window: bool = False):
    """What T2 computes, in PyTorch: d(Σ_b scale_b · sums_b)/d logits."""
    with torch.enable_grad():
        x = logits.detach().requires_grad_(True)
        sums, _ = parity_tail_forward_plain(x, label, pos_weights, neg_weights, None, epsilon,
                                            window)
        (dx,) = torch.autograd.grad(sums, x, scale.to(sums.dtype))
    return dx


# --------------------------------------------------------------------------
# the kernels' decomposition on the CPU


def _taps(k: torch.Tensor, parity: torch.Tensor):
    """Window indices and weights of the two taps of a parity along one
    axis: parity 0 blends k − 1 (¼) and k (¾), parity 1 k (¾) and k + 1 (¼),
    k the parent site's window index."""
    a = torch.where(parity == 0, k - 1, k)
    wa = torch.where(parity == 0, 0.25, 0.75)
    return a, a + 1, wa, 1.0 - wa


def _window(xb: torch.Tensor, r0: int, c0: int, nr: int, nc: int) -> torch.Tensor:
    """Rows r0 .. r0 + nr − 1 and columns c0 .. of one image, each index
    clamped to the image: the kernels' staged window and its edge clamp."""
    H, W = xb.shape[:2]
    rows = torch.arange(r0, r0 + nr).clamp(0, H - 1)
    cols = torch.arange(c0, c0 + nc).clamp(0, W - 1)
    return xb[rows][:, cols]


def _tile_values(win: torch.Tensor, r: torch.Tensor, s: torch.Tensor, i0: int, j0: int):
    """The parity values (len(r), len(s), C) of full-resolution rows ``r``
    and columns ``s`` from a window whose index 0 is site (i0 − 1, j0 − 1),
    in the kernels' order: the row blend of each of the two columns, then
    the column blend, every product and sum rounded."""
    ra, rb, wra, wrb = _taps((r >> 1) - i0 + 1, r & 1)
    ca, cb, wca, wcb = _taps((s >> 1) - j0 + 1, s & 1)
    dt = win.dtype
    wra, wrb = wra.to(dt)[:, None, None], wrb.to(dt)[:, None, None]
    top = win[ra][:, ca] * wra + win[rb][:, ca] * wrb
    bot = win[ra][:, cb] * wra + win[rb][:, cb] * wrb
    return top * wca.to(dt)[None, :, None] + bot * wcb.to(dt)[None, :, None]


def _pixel_terms(u, y, pw, nw, eps, one_pass: bool):
    """(per-pixel loss, dℓ/du) of parity values ``u`` (..., C) and label
    values ``y`` (..., C) as the kernels compute them: a term whose label
    weight y or 1 − y is 0 is left out.  ``one_pass`` (the C ≤ 32
    instantiations): p from one reciprocal of the exponentials' sum, and one
    log or division a class, of p + ε where y ≠ 0, else of 1 − p + ε, plus
    the other term for a soft label; else (C > 32) both terms as written."""
    m = u.amax(-1, keepdim=True)
    e = torch.exp(u - m)
    zero = torch.zeros((), dtype=u.dtype)
    pos, neg = y != 0, y != 1
    if one_pass:
        p = e * (1 / e.sum(-1, keepdim=True))
        soft = pos & neg
        w = torch.where(pos, pw * y, nw * (1 - y))
        arg = torch.where(pos, p + eps, 1 - p + eps)
        loss = -(w * torch.log(arg)
                 + torch.where(soft, nw * (1 - y) * torch.log(1 - p + eps), zero)).sum(-1)
        a = (torch.where(pos, -pw * y, nw * (1 - y)) / arg
             + torch.where(soft, nw * (1 - y) / (1 - p + eps), zero))
    else:
        p = e / e.sum(-1, keepdim=True)
        loss = -(torch.where(pos, pw * y * torch.log(p + eps), zero)
                 + torch.where(neg, nw * (1 - y) * torch.log(1 - p + eps), zero)).sum(-1)
        a = (torch.where(pos, -pw * y / (p + eps), zero)
             + torch.where(neg, nw * (1 - y) / (1 - p + eps), zero))
    return loss, p * (a - (a * p).sum(-1, keepdim=True))


def _label_values(label, b, r, s, C, dtype):
    """(len(r), len(s), C) label values at full-resolution rows r, columns
    s of image b: the one-hot row, or 1 at the integer class."""
    lab = label[b][r][:, s]
    if lab.dim() == 3:
        return lab.to(dtype)
    return torch.nn.functional.one_hot(lab.long().clamp(0, C - 1), C).to(dtype) * (
        (lab >= 0) & (lab < C))[..., None].to(dtype)


def _true_class(label, b, r, s):
    lab = label[b][r][:, s]
    return lab.argmax(-1) if lab.dim() == 3 else lab.long()


def _emulation_inputs(logits, pos_weights, neg_weights):
    """The logits in the kernels' float32 (float64 stays float64, to pin
    the decomposition in the tests) and the class weights in that dtype."""
    dt = torch.promote_types(logits.dtype, torch.float32)
    pw = torch.as_tensor(np.asarray(pos_weights), dtype=dt)
    nw = torch.as_tensor(np.asarray(neg_weights), dtype=dt)
    return logits.to(dt), pw, nw


def parity_tail_forward_emulation(logits, label, pos_weights, neg_weights, valid=None,
                                  epsilon: float = 1e-7, plan: ParityTailPlan | None = None,
                                  window: bool = False):
    """T1's decomposition in PyTorch, for tests: each block walks its tiles,
    each tile's pixels from its clamped window alone, every thread's pixel
    losses summed across the tiles (the tile's pixel grid), then over the
    block, written to the (B, blocks) buffer in the plan's block order and
    summed per sample in float64; the matrix counted per block.  Returns
    (sums (B,) float32, cm).  ``window`` shapes the default plan; a given
    ``plan`` carries its own site rows (``s0``, ``s1``)."""
    B, H, W, C = logits.shape
    plan = plan or _parity_tail_plan(B, H, W, C, window)
    x, pw, nw = _emulation_inputs(logits, pos_weights, neg_weights)
    partial = torch.zeros(B, plan.grid[0] * plan.grid[1], dtype=x.dtype)
    cm = torch.zeros(C * C + 1, dtype=torch.int64)
    n = [0] * B
    for b, tiles in plan.blocks():
        per_thread = torch.zeros(2 * plan.tr, 2 * plan.tw, dtype=x.dtype)
        for i0, j0 in tiles:
            win = _window(x[b], i0 - 1, j0 - 1, plan.tr + 2, plan.tw + 2)
            r = torch.arange(2 * i0, min(2 * (i0 + plan.tr), 2 * plan.s1))
            s = torch.arange(2 * j0, min(2 * (j0 + plan.tw), 2 * W))
            u = _tile_values(win, r, s, i0, j0)
            lr = r - 2 * plan.s0  # the labels' rows
            loss, _ = _pixel_terms(u, _label_values(label, b, lr, s, C, u.dtype), pw, nw, epsilon,
                                   plan.cmax > 0)
            per_thread[:len(r), :len(s)] += loss
            if valid is None or int(valid[b]) != 0:
                t = _true_class(label, b, lr, s)
                idx = torch.where((t >= 0) & (t < C), t * C + u.argmax(-1), C * C)
                cm += torch.bincount(idx.reshape(-1), minlength=C * C + 1)
        partial[b, n[b]] = per_thread.sum()
        n[b] += 1
    return partial.double().sum(1).to(x.dtype), cm[:C * C].reshape(C, C).to(torch.int32)


def _row_weights(n0: int, nt: int, n: int) -> torch.Tensor:
    """(nt, 2·nt + 2): the weight of full-resolution row 2·n0 − 1 + a in the
    gradient of site n0 + l, along one axis of size n: rows 2i − 1 and
    2i + 2 take ¼ (where they exist), 2i and 2i + 1 take ¾, plus the ¼ the
    clamp adds at i = 0 and i = n − 1."""
    m = torch.zeros(nt, 2 * nt + 2, dtype=torch.float64)
    for li in range(nt):
        i = n0 + li
        if i >= n:
            continue
        m[li, 2 * li:2 * li + 4] = torch.tensor([
            0.25 if i >= 1 else 0.0, 1.0 if i == 0 else 0.75,
            1.0 if i == n - 1 else 0.75, 0.25 if i + 1 <= n - 1 else 0.0])
    return m


def parity_tail_backward_emulation(logits, label, pos_weights, neg_weights, scale,
                                   epsilon: float = 1e-7, plan: ParityTailPlan | None = None,
                                   window: bool = False):
    """T2's decomposition in PyTorch, for tests: per block, each tile of its
    walk in turn: the gradient of every full-resolution pixel in rows
    2·i0 − 1 .. 2·(i0 + tr) and columns likewise (zero outside the image)
    from the tile's clamped window, then each site's dlogits as the
    transposed lerp of its 4 × 4 pixels: each pixel row's pass over a site
    column's 4 pixels, weighted into the two sites it reaches.  Under a row
    window the pixels of the context rows' sites are zero; ``window`` and
    ``plan`` as T1's emulation's."""
    B, H, W, C = logits.shape
    plan = plan or _parity_tail_plan(B, H, W, C, window)
    x, pw, nw = _emulation_inputs(logits, pos_weights, neg_weights)
    dx = torch.zeros(B, H, W, C, dtype=x.dtype)
    for b, i0, j0 in ((b, i0, j0) for b, tiles in plan.blocks("bwd") for i0, j0 in tiles):
        sc = float(scale[b])
        if sc == 0.0:
            continue
        win = _window(x[b], i0 - 1, j0 - 1, plan.tr + 2, plan.tw + 2)
        r = torch.arange(2 * i0 - 1, 2 * (i0 + plan.tr) + 1)
        s = torch.arange(2 * j0 - 1, 2 * (j0 + plan.tw) + 1)
        rin = (r >= 2 * plan.s0) & (r < 2 * plan.s1)
        sin = (s >= 0) & (s < 2 * W)
        g = torch.zeros(len(r), len(s), C, dtype=x.dtype)
        rv, sv = r[rin], s[sin]
        u = _tile_values(win, rv, sv, i0, j0)
        _, grad = _pixel_terms(u, _label_values(label, b, rv - 2 * plan.s0, sv, C, u.dtype), pw,
                               nw, epsilon, plan.cmax > 0)
        g[rin.nonzero()[:, 0][:, None], sin.nonzero()[:, 0][None, :]] = grad * sc
        mr = _row_weights(i0, plan.tr, H).to(x.dtype)
        mc = _row_weights(j0, plan.tw, W).to(x.dtype)
        h = torch.einsum("jb,abc->ajc", mc, g)  # each pixel row's column pass
        tile = torch.einsum("ia,ajc->ijc", mr, h)
        hi, wi = min(plan.tr, H - i0), min(plan.tw, W - j0)
        dx[b, i0:i0 + hi, j0:j0 + wi] = tile[:hi, :wi]
    return dx.to(logits.dtype)


# --------------------------------------------------------------------------
# the kernels


@functools.lru_cache(maxsize=16)
def _weights_on(pw: bytes, nw: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.frombuffer(pw, np.float32),
                                      np.frombuffer(nw, np.float32)])).to(device)


def _device_weights(pos_weights, neg_weights, C: int, device) -> tuple[torch.Tensor, np.ndarray]:
    """(2, C) float32 [pw; nw] on ``device``, made once per weights and
    device (no host copy a step), and the same on the host (the register
    instantiations take it as a kernel parameter)."""
    pw = np.asarray(pos_weights.cpu() if torch.is_tensor(pos_weights) else pos_weights, np.float32)
    nw = np.asarray(neg_weights.cpu() if torch.is_tensor(neg_weights) else neg_weights, np.float32)
    if pw.shape != (C,) or nw.shape != (C,):
        raise ValueError(f"parity_tail: class weights {pw.shape}, {nw.shape} for C={C}")
    return _weights_on(pw.tobytes(), nw.tobytes(), torch.device(device)), np.concatenate([pw, nw])


def _check(logits: torch.Tensor, label: torch.Tensor, window: bool) -> None:
    if logits.device.type != "cuda":
        raise ValueError(f"parity_tail: logits on {logits.device}")
    if logits.dim() != 4 or logits.dtype not in _LOGIT_CODE:
        raise ValueError(f"parity_tail: logits {tuple(logits.shape)} {logits.dtype}; the kernels "
                         "take (B, H, W, C) float32, bfloat16 or float16")
    B, H, W, C = logits.shape
    dense = (B, 2 * (H - 2 if window else H), 2 * W, C)
    if label.device != logits.device or label.dtype not in _LABEL_CODE or tuple(label.shape) not in (
            dense, dense[:3]) or (label.dim() == 4) != label.is_floating_point():
        raise ValueError(f"parity_tail: label {tuple(label.shape)} {label.dtype} on {label.device} "
                         f"for logits {tuple(logits.shape)}: one-hot {dense} float or integer "
                         f"{dense[:3]}")
    if label.numel() >= 2**31 or B * 4 * H * W * (C + 1) >= 2**40:
        raise ValueError(f"parity_tail: shape {tuple(logits.shape)} too large for the kernels")


def _smem(plan: ParityTailPlan, label: torch.Tensor, kernel: str) -> int:
    """A block's shared memory for this label layout (the kernels read
    float32 one-hot labels at an odd C from their raw rows)."""
    if label.dim() != 4:
        return getattr(plan, f"{kernel}_smem_int")
    direct = label.shape[-1] % 2 and label.dtype == torch.float32
    return getattr(plan, f"{kernel}_smem_direct" if direct else f"{kernel}_smem")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def parity_tail_forward(logits, label, pos_weights, neg_weights, valid=None,
                        epsilon: float = 1e-7, window: bool = False):
    """T1: (per-sample loss sums (B,) float32, cm (C, C) int32) of logits
    (B, H, W, C) and labels (one-hot (B, 2H, 2W, C) float, or integer
    (B, 2H, 2W); under ``window`` 2(H − 2) rows, the module docstring's row
    window); ``valid`` (B,) leaves samples out of the matrix.  A CPU
    tensor takes :func:`parity_tail_forward_plain`."""
    if logits.device.type == "cpu":
        return parity_tail_forward_plain(logits, label, pos_weights, neg_weights, valid, epsilon,
                                         window)
    _check(logits, label, window)
    logits, label = logits.contiguous(), label.contiguous()
    B, H, W, C = logits.shape
    plan = _parity_tail_plan(B, H, W, C, window)
    wts, host = _device_weights(pos_weights, neg_weights, C, logits.device)
    v = None if valid is None else valid.to(device=logits.device, dtype=torch.int32).contiguous()
    if v is not None and v.shape != (B,):
        raise ValueError(f"parity_tail: valid {tuple(v.shape)} for B={B}")
    partial = torch.empty(B, plan.grid[0] * plan.grid[1], dtype=torch.float32, device=logits.device)
    sums = torch.empty(B, dtype=torch.float32, device=logits.device)
    cm = torch.zeros(C, C, dtype=torch.int32, device=logits.device)
    fn = _build.function("parity_tail", "parity_tail_fwd",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                         + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14
                         + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(logits.device):
        rc = fn(logits.data_ptr(), _LOGIT_CODE[logits.dtype], label.data_ptr(),
                _LABEL_CODE[label.dtype], wts.data_ptr(), host.ctypes.data,
                0 if v is None else v.data_ptr(),
                partial.data_ptr(), sums.data_ptr(), cm.data_ptr(),
                B, H, W, C, plan.s0, plan.s1, plan.cp, plan.tr, plan.tw, plan.walk, plan.cmax,
                plan.fwd_threads, _smem(plan, label, "fwd"), int(plan.hist),
                float(epsilon), _stream(logits.device))
    if rc != 0:
        raise RuntimeError(f"parity_tail_fwd launch failed: CUDA error {rc}")
    launches["parity_tail_fwd"] += 1
    return sums, cm


def parity_tail_backward(logits, label, pos_weights, neg_weights, scale, epsilon: float = 1e-7,
                         window: bool = False):
    """T2: dlogits (B, H, W, C) in the logits' dtype, the gradient of
    Σ_b scale_b · sums_b (``scale`` (B,), float32); ``window`` as T1's.  A
    CPU tensor takes :func:`parity_tail_backward_plain`."""
    if logits.device.type == "cpu":
        return parity_tail_backward_plain(logits, label, pos_weights, neg_weights, scale, epsilon,
                                          window)
    _check(logits, label, window)
    logits, label = logits.contiguous(), label.contiguous()
    B, H, W, C = logits.shape
    plan = _parity_tail_plan(B, H, W, C, window)
    wts, host = _device_weights(pos_weights, neg_weights, C, logits.device)
    scale = scale.to(device=logits.device, dtype=torch.float32).contiguous()
    if scale.shape != (B,):
        raise ValueError(f"parity_tail: scale {tuple(scale.shape)} for B={B}")
    dx = torch.empty_like(logits)
    fn = _build.function("parity_tail", "parity_tail_bwd",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                         + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                         + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(logits.device):
        rc = fn(logits.data_ptr(), _LOGIT_CODE[logits.dtype], label.data_ptr(),
                _LABEL_CODE[label.dtype], wts.data_ptr(), host.ctypes.data, scale.data_ptr(),
                dx.data_ptr(), B, H, W, C, plan.s0, plan.s1, plan.cp, plan.tr, plan.tw, plan.walk,
                plan.cmax, plan.bwd_threads, _smem(plan, label, "bwd"),
                float(epsilon), _stream(logits.device))
    if rc != 0:
        raise RuntimeError(f"parity_tail_bwd launch failed: CUDA error {rc}")
    launches["parity_tail_bwd"] += 1
    return dx


class _ParityTail(torch.autograd.Function):
    """T1 forward, T2 backward; the confusion matrix takes no gradient."""

    @staticmethod
    def forward(ctx, logits, label, pos_weights, neg_weights, valid, epsilon, window):
        sums, cm = parity_tail_forward(logits, label, pos_weights, neg_weights, valid, epsilon,
                                       window)
        ctx.save_for_backward(logits, label)
        ctx.weights, ctx.epsilon, ctx.window = (pos_weights, neg_weights), epsilon, window
        ctx.mark_non_differentiable(cm)
        return sums, cm

    @staticmethod
    def backward(ctx, dsums, _dcm):
        logits, label = ctx.saved_tensors
        dx = parity_tail_backward(logits, label, *ctx.weights, dsums, ctx.epsilon, ctx.window)
        return dx, None, None, None, None, None, None


def parity_tail_sums(logits, label, pos_weights, neg_weights, num_classes: int, valid=None,
                     epsilon: float = 1e-7, window: bool = False):
    """(per-sample loss sums (B,) with T2 as their gradient, cm) on a CUDA
    tensor; raises elsewhere (the CPU takes ``ops/parity_tail.py``'s plain
    version before it gets here)."""
    if logits.device.type != "cuda":
        raise ValueError(f"parity_tail: logits on {logits.device}; the kernels take CUDA tensors")
    if logits.shape[-1] != num_classes:
        raise ValueError(f"parity_tail: logits {tuple(logits.shape)} for {num_classes} classes")
    # labels the loss takes and the kernels do not read (uint8 ids, float64
    # or integer one-hot): ids as int32, one-hot as float32
    if label.dim() == 4 and not (label.is_floating_point() and label.dtype in _LABEL_CODE):
        label = label.float()
    elif label.dim() == 3 and label.dtype not in (torch.int32, torch.int64):
        label = label.int()
    return _ParityTail.apply(logits, label, pos_weights, neg_weights, valid, float(epsilon),
                             bool(window))
