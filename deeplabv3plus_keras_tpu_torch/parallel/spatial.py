"""Spatial sharding: the rows a spatial op needs from other ranks (the
halo exchanges GSPMD inserts into the JAX package's convolutions under
``mesh_space``, ``deeplabv3plus_keras_tpu/parallel/mesh.py:12-14``).

Under the (data, space) grid of ``mesh.init_grid`` every activation of
global height H is split by ``mesh.rows_of(H, S, s)``: rank s of a space
group holds rows [lo, hi) of each of its samples, all columns and all
channels.  An op whose output rows need input rows outside that range
(a k×k conv, a pool, a resize, a reduction over H) computes the rows it
needs from the global geometry, never from the shard's shape, and
:func:`fetch_rows` brings them: every rank computes every rank's request,
each owner writes the rows others asked for into their slots of one
buffer, and one ``all_reduce`` (sum, over the space group) delivers them.
The rows may come from any rank, not only a neighbour: a rate-18 ASPP
conv reaches past a whole shard at small maps.  Its backward is the
transpose: each rank writes the gradients of the rows it fetched into its
slot, one ``all_reduce``, and each owner adds the gradients of its rows.
``gloo`` carries ``all_reduce`` on CUDA tensors, so two ranks may share a
card.

Every rank enters every exchange in the same order, ranks that hold no
rows of an activation included: an op whose rank holds no output rows
still fetches (an empty request) and returns an empty tensor joined to
its inputs in the autograd graph, so its backward enters the transposed
exchange too.

A shard's own height does not determine its activation's global height
(⌈H/S⌉ rows fit several H), so every op reads it from a map of widths to
global heights (:func:`use_heights`): a step seeds it with its images'
{W: H}, and every op of this module adds its output's.  On the backbones
under ``mesh_space`` every layer maps the height and the width by the same
per-axis function, so the activations of one width share one global
height; a width met with two heights raises.

``counts`` holds the exchanges (forward and backward) and the bytes each
all-reduced since :func:`reset_counts`.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.nn.functional as F

from . import mesh

# exchanges made and the bytes of their buffers, since reset_counts()
counts = {"exchanges": 0, "exchange_bytes": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


_state = threading.local()


def active() -> mesh.Grid | None:
    """The grid when the image height is split over more than one rank,
    outside :func:`local`."""
    return None if getattr(_state, "local", 0) else mesh.grid()


@contextlib.contextmanager
def local():
    """Inside, ops compute on the rows they are given, as one process
    does: the block of fetched rows an op of this module hands its
    function."""
    depth = getattr(_state, "local", 0)
    _state.local = depth + 1
    try:
        yield
    finally:
        _state.local = depth


@contextlib.contextmanager
def use_heights(heights: dict | None):
    """Inside, an activation of width W has the global height
    ``heights[W]`` (:func:`global_height`), and the ops of this module add
    their outputs' widths and heights to the map: a step seeds it with
    ``{W: H}`` of its images (or of a test-time scale's), the remat
    recompute, which runs on the backward's thread, with its forward's
    whole map.  The map of the enclosing block is back afterwards."""
    prev = getattr(_state, "heights", None)
    _state.heights = heights
    try:
        yield
    finally:
        _state.heights = prev


def heights() -> dict | None:
    """The map of widths to global heights in force on this thread."""
    return getattr(_state, "heights", None)


def global_height(x: torch.Tensor) -> int:
    """The global height of a row-sharded NCHW activation, from its width
    (:func:`use_heights`); raises where the map has no such width."""
    W = int(x.shape[-1])
    known = heights()
    if not known or W not in known:
        raise ValueError(f"spatial: no global height for an activation of width {W} "
                         f"(known widths {sorted(known or {})}): run the model under "
                         "spatial.use_heights({W: H}) of its images")
    return known[W]


def _record(width: int, height: int) -> None:
    """An op's output: ``width`` has the global height ``height``."""
    known = heights()
    if known.setdefault(int(width), int(height)) != height:
        raise ValueError(f"spatial: activations of width {width} with global heights "
                         f"{known[width]} and {height}")


def _clip(lo: int, hi: int, H: int) -> tuple[int, int]:
    lo, hi = max(lo, 0), min(hi, H)
    return (lo, hi) if lo < hi else (0, 0)


def _parts(need: tuple[int, int], own: tuple[int, int]):
    """(rows before own, own rows, rows after own) of ``need``, each
    [g0, g1) (possibly empty)."""
    (l, h), (a, b) = need, own
    return (l, min(h, a)), (max(l, a), min(h, b)), (max(l, b), h)


def _layout(H: int, S: int, needs: list[tuple[int, int]]):
    """Buffer slots: for each rank q, [(offset, g0, g1), ...] of the rows it
    needs from others, and the buffer's total rows."""
    slots, off = [], 0
    for q in range(S):
        before, _, after = _parts(needs[q], mesh.rows_of(H, S, q))
        segs = []
        for g0, g1 in (before, after):
            if g0 < g1:
                segs.append((off, g0, g1))
                off += g1 - g0
        slots.append(segs)
    return slots, off


def _rows(t: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of an NCHW tensor as (rows, B, W, C) (the buffer's
    layout)."""
    return t[:, :, r0:r1].permute(2, 0, 3, 1)


def _all_reduce(buf: torch.Tensor, grid: mesh.Grid) -> None:
    mesh.all_reduce_group_(buf, grid.space_group)
    counts["exchanges"] += 1
    counts["exchange_bytes"] += buf.numel() * buf.element_size()


class _FetchRows(torch.autograd.Function):
    """Rows [l, h) (``needs[s]``, inside [0, H)) of a row-sharded x."""

    @staticmethod
    def forward(ctx, x, H: int, needs: list, grid: mesh.Grid):
        S, me = grid.n_space, grid.s
        own = mesh.rows_of(H, S, me)
        if x.shape[2] != own[1] - own[0]:
            raise ValueError(f"fetch_rows: a shard of {x.shape[2]} rows where rows {own} of "
                             f"{H} are this rank's")
        slots, total = _layout(H, S, needs)
        ctx.H, ctx.needs, ctx.grid, ctx.x_shape = H, needs, grid, x.shape
        buf = None
        if total:
            B, C, _, W = x.shape
            buf = x.new_zeros((total, B, W, C))
            for q in range(S):
                for off, g0, g1 in slots[q] if q != me else ():
                    i0, i1 = max(g0, own[0]), min(g1, own[1])
                    if i0 < i1:
                        buf[off + i0 - g0:off + i1 - g0] = _rows(x, i0 - own[0], i1 - own[0])
            _all_reduce(buf, grid)
        parts = []
        segs = iter(slots[me])
        for i, (g0, g1) in enumerate(_parts(needs[me], own)):
            if g0 >= g1:
                continue
            if i == 1:  # this rank's own rows
                parts.append(x[:, :, g0 - own[0]:g1 - own[0]])
            else:
                off, _, _ = next(segs)
                parts.append(buf[off:off + g1 - g0].permute(1, 3, 0, 2))
        if not parts:
            return x.new_zeros((x.shape[0], x.shape[1], 0, x.shape[3])).contiguous(
                memory_format=torch.channels_last)
        return torch.cat(parts, 2).contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        H, needs, grid = ctx.H, ctx.needs, ctx.grid
        S, me = grid.n_space, grid.s
        own = mesh.rows_of(H, S, me)
        l, _ = needs[me]
        gx = g.new_zeros(ctx.x_shape).contiguous(memory_format=torch.channels_last)
        _, (m0, m1), _ = _parts(needs[me], own)
        if m0 < m1:
            gx[:, :, m0 - own[0]:m1 - own[0]] += g[:, :, m0 - l:m1 - l]
        slots, total = _layout(H, S, needs)
        if total:
            B, C, _, W = ctx.x_shape
            buf = g.new_zeros((total, B, W, C))
            for off, g0, g1 in slots[me]:
                buf[off:off + g1 - g0] = _rows(g, g0 - l, g1 - l)
            _all_reduce(buf, grid)
            for q in range(S):
                for off, g0, g1 in slots[q] if q != me else ():
                    i0, i1 = max(g0, own[0]), min(g1, own[1])
                    if i0 < i1:
                        gx[:, :, i0 - own[0]:i1 - own[0]] += \
                            buf[off + i0 - g0:off + i1 - g0].permute(1, 3, 0, 2)
        return gx, None, None, None


def fetch_rows(x: torch.Tensor, lo, hi, H: int, edge="zero") -> torch.Tensor:
    """Global rows [lo[s], hi[s]) of the row-sharded NCHW ``x`` (height
    ``H``) on space rank s of the grid.  ``lo`` and ``hi`` hold every space
    rank's request (the same sequences on every rank); rows outside [0, H)
    are zeros (``edge="zero"``, convs), copies of the edge row
    (``"clamp"``, resizes) or the constant ``edge`` (a float: −inf for a
    max pool).  Differentiable; one exchange each way unless no rank asks
    for another's rows."""
    grid = active()
    needs = [_clip(a, b, H) for a, b in zip(lo, hi)]
    me = grid.s
    need = needs[me]
    if _layout(H, grid.n_space, needs)[1]:
        y = _FetchRows.apply(x, H, needs, grid)
    else:  # no rank needs another's rows: no exchange (alike on every rank)
        a = mesh.rows_of(H, grid.n_space, me)[0]
        y = x[:, :, need[0] - a:need[1] - a] if need[1] > need[0] else x[:, :, :0]
    top, bottom = need[0] - lo[me], hi[me] - need[1]
    if need == (0, 0):
        top, bottom = 0, hi[me] - lo[me]
    if top == 0 and bottom == 0:
        return y
    if edge != "clamp":
        return F.pad(y, (0, 0, top, bottom), value=0.0 if edge == "zero" else float(edge))
    if need == (0, 0):
        raise ValueError(f"fetch_rows: no row of [{lo[me]}, {hi[me]}) in [0, {H}) to clamp to")
    idx = torch.arange(lo[me], hi[me], device=x.device).clamp(need[0], need[1] - 1) - need[0]
    return y.index_select(2, idx)


def gather_rows(t: torch.Tensor, H: int, dim: int) -> torch.Tensor:
    """Every space rank's rows of ``t`` (this rank's ``rows_of(H)`` along
    ``dim``) as one tensor of height H on every rank: one all-reduce of a
    zero-filled full-height buffer.  Integer tensors travel as float64."""
    grid = active()
    if grid is None:
        return t
    a, b = grid.rows_of(H)
    shape = list(t.shape)
    shape[dim] = H
    buf = torch.zeros(shape, dtype=torch.float64 if not t.is_floating_point() else t.dtype,
                      device=t.device)
    buf.narrow(dim, a, b - a).copy_(t)
    _all_reduce(buf, grid)
    return buf.to(t.dtype)


class _MeanHW(torch.autograd.Function):
    """The (B, C, 1, 1) mean over H and W of a row-sharded x whose global
    height is H: the rank's row sums, one all-reduce over the space group,
    divided by H·W; every rank holds the mean.  Its backward is the same
    all-reduce of the mean's gradient (each rank's share of the loss
    reads it), spread over the rank's rows."""

    @staticmethod
    def forward(ctx, x, H: int, grid: mesh.Grid):
        s = x.to(torch.promote_types(x.dtype, torch.float32)).sum((2, 3), keepdim=True)
        _all_reduce(s, grid)
        ctx.shape, ctx.dtype, ctx.n, ctx.grid = x.shape, x.dtype, H * x.shape[-1], grid
        return (s / ctx.n).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.promote_types(g.dtype, torch.float32), copy=True).contiguous()
        _all_reduce(g, ctx.grid)
        gx = (g / ctx.n).to(ctx.dtype).expand(ctx.shape)
        return gx.contiguous(memory_format=torch.channels_last), None, None


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``x.mean((2, 3), keepdim=True)`` of the whole image under the grid
    (a global average such as EfficientNet's squeeze-excite), replicated on
    every rank of the space group, ranks with no rows included; the plain
    mean outside it."""
    grid = active()
    if grid is None:
        return x.mean((2, 3), keepdim=True)
    return _MeanHW.apply(x, global_height(x), grid)


def _connected_empty(shape, like: torch.Tensor, *deps: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``shape`` that depends on ``deps`` in the autograd
    graph (their gradients zero), so that a rank holding no output rows
    still runs the backward of what fed the op, its exchanges included."""
    out = like.new_zeros(shape).contiguous(memory_format=torch.channels_last)
    if torch.is_grad_enabled() and any(d.requires_grad for d in deps):
        out = out + sum(d.sum() for d in deps).to(out.dtype)
    return out


def window_op(x: torch.Tensor, op, *, k: int, stride: int, dilation: int = 1,
              pads_h: tuple[int, int], out_width: int, out_channels: int,
              fill: float = 0.0, clip: bool = False, deps=()) -> torch.Tensor:
    """This rank's output rows of a k-tap, ``dilation``, ``stride`` op along
    H whose global padding is ``pads_h`` (top, bottom): output rows [o0, o1)
    (``rows_of`` of the global output height) read input rows [o0·s − pt,
    (o1 − 1)·s − pt + d(k − 1)].  Those rows are fetched; with ``clip`` the
    op gets the rows inside the image and the count of padding rows above
    them, ``op(xw, pad_t, o1 − o0)``; otherwise the window, its rows off
    the image ``fill``, ``op(xw)``, which pads nothing along H.  A rank with no output
    rows gets an empty (B, ``out_channels``, 0, ``out_width``) tensor joined
    to ``deps``."""
    grid = active()
    H = global_height(x)
    pt, pb = pads_h
    Ho = (H + pt + pb - dilation * (k - 1) - 1) // stride + 1
    _record(out_width, Ho)
    lo, hi = [], []
    for q in range(grid.n_space):
        o0, o1 = mesh.rows_of(Ho, grid.n_space, q)
        if o0 == o1:
            lo.append(0)
            hi.append(0)
        else:
            lo.append(o0 * stride - pt)
            hi.append((o1 - 1) * stride - pt + dilation * (k - 1) + 1)
    me = grid.s
    o0, o1 = mesh.rows_of(Ho, grid.n_space, me)
    if clip:
        clipped = [_clip(a, b, H) for a, b in zip(lo, hi)]
        xw = fetch_rows(x, [c[0] for c in clipped], [c[1] for c in clipped], H)
    else:
        xw = fetch_rows(x, lo, hi, H, "zero" if fill == 0.0 else fill)
    if o0 == o1:
        return _connected_empty((x.shape[0], out_channels, 0, out_width), x, xw, *deps)
    with local():
        if clip:
            return op(xw, _clip(lo[me], hi[me], H)[0] - lo[me], o1 - o0)
        return op(xw)


def resize_rows(x: torch.Tensor, f: int, fn, *, out_width: int, out_channels: int,
                halo: int = 0, row_dim: int = 2, deps=()) -> torch.Tensor:
    """This rank's rows of ``fn(x)``, a ×f half-pixel resize along H
    (followed, with ``halo`` 1, by a 3-tap SAME op on the resized rows, as
    the fused upsample-conv): output rows [O0, O1) of the global f·h need
    resized rows [O0 − halo, O1 + halo) inside the image, and those need
    input rows [⌊(u0 + ½)/f − ½⌋, ⌊(u1 − ½)/f − ½⌋ + 2) (u1 exclusive),
    clipped to the image.  ``fn`` runs on those rows and its rows
    [O0 − lo·f, O1 − lo·f) are kept: the block's own edge clamp (and
    padding) acts only at the image's edges, where the global op's does,
    or outside the kept rows.  ``row_dim``: the output's row dimension."""
    grid = active()
    h = global_height(x)
    Hout = h * f
    _record(out_width, Hout)
    lo, hi = [], []
    for q in range(grid.n_space):
        O0, O1 = mesh.rows_of(Hout, grid.n_space, q)
        if O0 == O1:
            lo.append(0)
            hi.append(0)
            continue
        u0, u1 = max(O0 - halo, 0), min(O1 + halo, Hout)
        a, b = _clip((2 * u0 + 1 - f) // (2 * f), (2 * u1 - 1 - f) // (2 * f) + 2, h)
        lo.append(a)
        hi.append(b)
    me = grid.s
    O0, O1 = mesh.rows_of(Hout, grid.n_space, me)
    xb = fetch_rows(x, lo, hi, h)
    if O0 == O1:
        if row_dim == 2:
            return _connected_empty((x.shape[0], out_channels, 0, out_width), x, xb, *deps)
        return x.new_zeros((x.shape[0], 0, out_width))
    with local():
        return fn(xb).narrow(row_dim, O0 - lo[me] * f, O1 - O0)


@functools.lru_cache(maxsize=8)
def _linear_operator(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float64 operator of a half-pixel linear resize from
    n_in to n_out samples, antialiased (the triangle widened by the ratio)
    where it shrinks: ``F.interpolate`` of an identity, as ``jax.image.
    resize(..., "linear")`` and the step's ``_resize_linear`` resize."""
    eye = torch.eye(n_in, dtype=torch.float64)[None, None]
    return F.interpolate(eye, size=(n_out, n_in), mode="bilinear", align_corners=False,
                         antialias=n_out < n_in)[0, 0]


def resize_rows_linear(x: torch.Tensor, h: int, H: int, out_width: int) -> torch.Tensor:
    """This rank's rows (``rows_of(H)``) of the row-sharded NCHW ``x`` of
    global height ``h`` resized to H × ``out_width`` (half-pixel linear,
    antialiased where it shrinks; any ratio): each rank's rows of the H
    operator, their nonzero source span fetched, contracted along H, then
    the width resized.  No rank holds the whole map."""
    grid = active()
    A = _linear_operator(h, H)
    lo, hi = [], []
    for q in range(grid.n_space):
        O0, O1 = mesh.rows_of(H, grid.n_space, q)
        cols = A[O0:O1].ne(0).any(0).nonzero()[:, 0]
        lo.append(int(cols[0]) if O0 < O1 else 0)
        hi.append(int(cols[-1]) + 1 if O0 < O1 else 0)
    me = grid.s
    O0, O1 = mesh.rows_of(H, grid.n_space, me)
    xw = fetch_rows(x, lo, hi, h)
    if O0 == O1:
        return x.new_zeros((x.shape[0], x.shape[1], 0, out_width))
    y = torch.einsum("oh,bchw->bcow", A[O0:O1, lo[me]:hi[me]].to(x), xw)
    if out_width != x.shape[-1]:
        y = torch.einsum("vw,bcow->bcov", _linear_operator(x.shape[-1], out_width).to(x), y)
    return y
