"""The channels-first depthwise forward's plan and decomposition, on the CPU.

``csrc/depthwise_cf.cu`` ``dw_cf_fwd`` (K6) computes the 3×3 stride-1 SAME
depthwise conv of NCHW-contiguous tensors as ``kernels/depthwise.py``
``_cf_fwd_plan`` lays it out: the B·C planes are one image of B·C·H rows,
a tile is whole rows of it (several whole planes on small planes, a cut
of one plane on large ones) with one row of halo above and below, and a
block walks consecutive tiles.  The CUDA kernel runs only on the card;
here ``depthwise_cf_forward_emulation`` walks the same blocks and tiles in
PyTorch and is held against the plain version and the JAX package's
Pallas kernel ``_dw_fwd_padded`` (interpret mode, directly and as
``depthwise3x3`` under ``DLV3_DW_LAYOUT=bhcw``), and the plans are checked
against what they must cover and what the card takes.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_keras_tpu.kernels.depthwise3 import _dw_fwd_padded, _to_bhcw_padded, depthwise3x3
from deeplabv3plus_keras_tpu_torch.kernels.depthwise import (
    _cf_fwd_flat,
    _cf_fwd_plan,
    depthwise_cf_forward_emulation,
    depthwise_conv_plain,
)

torch.set_num_threads(1)

# (B, C, H, W): odd and even H and W, B = 1 and 3, planes many a tile and
# planes cut into tiles, C at, below and above the vector width, a plane of
# one pixel (the SHAPES of tests/test_torch_cf_bwd_plan.py), and a 32²
# float32 plane count that leaves the last tile two planes.
SHAPES = [
    (1, 8, 9, 13),
    (3, 5, 37, 45),
    (3, 16, 16, 16),
    (1, 4, 33, 32),
    (2, 12, 70, 131),
    (3, 24, 8, 8),
    (1, 3, 1, 1),
    (2, 700, 4, 4),
    (3, 50, 32, 32),
]
# (dtype the plan is made for, pointer alignment): 16-byte row copies
# (float32 and bfloat16) and the flat copies of a misaligned view.
PLAN_KINDS = [(torch.float32, 16), (torch.float32, 4), (torch.bfloat16, 16)]


def _plan(shape, dtype=torch.float32, align=16):
    return _cf_fwd_plan(*shape, dtype, align)


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(shape[1], 1, 3, 3))).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_plain(shape, kind, align, dtype):
    x, w = _inputs(sum(shape), shape, dtype)
    y = depthwise_cf_forward_emulation(x, w, _plan(shape, kind, align))
    ref = depthwise_conv_plain(x, w)
    assert y.shape == ref.shape and not y.isnan().any()
    # float32: sums of 9 products in another order than the plain conv's;
    # the bound is relative to the sum of their magnitudes
    scale = depthwise_conv_plain(x.abs(), w.abs())
    rel = 1e-6 if dtype == torch.float32 else 1e-14
    assert ((y - ref).abs() <= rel * scale + 1e-30).all()


@pytest.mark.parametrize("r", [8, 16])
@pytest.mark.parametrize("shape", [(3, 5, 37, 45), (2, 12, 70, 131), (1, 3, 1, 1)])
def test_flat_plans_of_other_tile_heights_emulate_plain(shape, r):
    """A flat plan of r-row tiles (the plan's own takes 16 float32 rows):
    every tile lies in one plane, each thread's rows take its plane's taps,
    so any r gives the plain version's outputs."""
    x, w = _inputs(7, shape, torch.float64)
    plan = _cf_fwd_flat(*shape, 4, r)
    assert plan.mode == "flat" and plan.r == r and plan.planes == 1
    y = depthwise_cf_forward_emulation(x, w, plan)
    torch.testing.assert_close(y, depthwise_conv_plain(x, w), atol=1e-12, rtol=0)


def _pallas_fwd(x, k):
    """``_dw_fwd_padded`` in interpret mode on NHWC ``x`` and HWIO ``k``."""
    C = x.shape[-1]
    out = _dw_fwd_padded(_to_bhcw_padded(jnp.asarray(x)), jnp.asarray(k).reshape(9, C, 1), True)
    return np.asarray(jnp.transpose(out, (0, 1, 3, 2)))


def _emulated(x, k, kind=torch.float32, align=16):
    """The emulation on numpy NHWC ``x`` and HWIO ``k``, NHWC out."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    y = depthwise_cf_forward_emulation(xt, w, _plan(tuple(xt.shape), kind, align))
    return y.permute(0, 2, 3, 1).numpy()


# (B, H, W, C) NHWC for the Pallas kernel: odd H and W, B = 1 and 3, planes
# many a tile (16², 8²) and cut into tiles (37 × 45)
JAX_SHAPES = [(1, 9, 13, 8), (3, 16, 16, 4), (1, 37, 45, 3), (3, 7, 33, 8), (2, 8, 8, 24)]


@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_emulation_matches_pallas_dw_fwd_padded(shape, kind, align):
    """5e-6 absolute: the JAX package's bound for its stencil
    (tests/test_kernels.py:117), on inputs of unit scale."""
    rng = np.random.default_rng(sum(shape) + align)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 1, shape[-1])) * 0.5).astype(np.float32)
    np.testing.assert_allclose(_emulated(x, k, kind, align), _pallas_fwd(x, k), atol=5e-6, rtol=0)


@pytest.mark.parametrize("shape", [(3, 11, 17, 8), (1, 32, 32, 16), (2, 32, 32, 8)])
def test_emulation_matches_depthwise3x3_under_bhcw(shape, monkeypatch):
    """``depthwise3x3`` under ``DLV3_DW_LAYOUT=bhcw``: the route by which
    the JAX package reaches ``_dw_fwd_padded``; 5e-6 absolute as above."""
    monkeypatch.setenv("DLV3_DW_LAYOUT", "bhcw")
    rng = np.random.default_rng(sum(shape) + 1)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 1, shape[-1])) * 0.5).astype(np.float32)
    ref = np.asarray(depthwise3x3(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(_emulated(x, k), ref, atol=5e-6, rtol=0)


@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_output_once(shape, kind, align):
    """The blocks walk every tile once, in order; the tiles (whole rows of
    the B·C·H-row image) cover every output row once; a tile of several
    planes starts at a plane's first row, holds whole planes, and every
    thread's rows lie in one plane (so one channel's taps serve them); a
    tile of one plane's rows stays in that plane."""
    B, C, H, W = shape
    plan = _plan(shape, kind, align)
    seen = torch.zeros(B * C * H, dtype=torch.int32)
    walked = []
    for blk, walk in plan.blocks():
        assert 1 <= len(walk) <= plan.walk
        walked += walk
        for t0, rows in walk:
            assert 1 <= rows <= plan.th
            seen[t0:t0 + rows] += 1
            if plan.planes > 1:
                assert t0 % H == 0 and rows % H == 0 and plan.th == plan.planes * H
                assert H % plan.r == 0  # a thread's r rows never cross a plane
            else:
                assert t0 // H == (t0 + rows - 1) // H
    assert blk == plan.grid[0] - 1 and len(walked) == plan.positions == len(set(walked))
    assert (seen == 1).all()
    assert plan.threads <= 256 and plan.smem <= 227 * 1024
    if plan.mode == "vec":
        V = 16 // kind.itemsize
        assert plan.ncx * V >= W and W % V == 0 and align % 16 == 0
    else:
        assert plan.planes == 1


def test_tiles_of_several_planes_mask_the_rows_between_them():
    """Eight 32² planes a tile: each plane's first and last outputs must not
    see the neighbouring plane's rows, which sit in the tile's window.
    Planes of constant values make any leak show: a plane's outputs on its
    edge rows equal those of the same plane alone."""
    shape = (1, 16, 32, 32)
    plan = _plan(shape)
    assert plan.planes == 8 and plan.positions == 2
    x = torch.arange(1.0, 17.0, dtype=torch.float64).reshape(1, 16, 1, 1).expand(shape).contiguous()
    w = torch.ones(16, 1, 3, 3, dtype=torch.float64)
    y = depthwise_cf_forward_emulation(x, w, plan)
    c = torch.arange(1.0, 17.0, dtype=torch.float64)
    # interior 9·v, edge rows 6·v, corners 4·v
    assert torch.equal(y[0, :, 0, 0], 4 * c) and torch.equal(y[0, :, 31, 16], 6 * c)
    assert torch.equal(y[0, :, 16, 16], 9 * c) and torch.equal(y[0, :, 0, 16], 6 * c)
    torch.testing.assert_close(y, depthwise_conv_plain(x, w), atol=0, rtol=0)


def test_a_thread_strip_across_planes_would_show():
    """The emulation takes each thread's taps from its first row's plane,
    as the kernel does: a plan whose strips crossed a plane (r not dividing
    H) would give wrong outputs, and the coverage test above refuses it."""
    shape = (1, 4, 6, 8)
    plan = _plan(shape)
    assert plan.planes == 1 and plan.r == 8  # 8 does not divide 6: no tile of several planes
    bad = dataclasses.replace(plan, planes=2, nry=3, r=4)  # 12 rows: rows 4-7 of a thread cross a plane
    x, w = _inputs(3, shape, torch.float64)
    y = depthwise_cf_forward_emulation(x, w, bad)
    assert not torch.allclose(y, depthwise_conv_plain(x, w))


# Xception's 8 distinct K6 sites at B=16, 512², os 16 (chip_smoke.py)
XCEPTION_SITES = [(16, 64, 253, 253), (16, 128, 253, 253), (16, 128, 127, 127),
                  (16, 256, 127, 127), (16, 256, 64, 64), (16, 728, 64, 64),
                  (16, 728, 32, 32), (16, 1024, 32, 32)]


@pytest.mark.parametrize("shape", XCEPTION_SITES)
def test_plan_fills_the_card_at_xception_sites(shape):
    """At least two waves of blocks on the 132 SMs (two blocks for each,
    as K7's plan keeps), every block walking at least two tiles (so the
    next tile's copies overlap the current one's compute), at most 227 KB
    of shared memory and 256 threads a block, flat copies at the odd planes
    (rows of 1012 and 508 float32 bytes) and 16-byte row copies elsewhere;
    32² planes eight a tile; a pure, cached plan."""
    B, C, H, W = shape
    for dtype in (torch.float32, torch.bfloat16):
        p = _plan(shape, dtype)
        assert p.grid[0] >= 2 * 132 and 2 <= p.walk <= 8
        assert p.smem <= 227 * 1024 and p.threads <= 256
        assert p.mode == ("vec" if W % 8 == 0 else "flat")
        if H == 32:
            assert p.planes == 8 and p.th == 256
        assert math.ceil(p.positions / p.walk) == p.grid[0]
    assert _plan(shape) is _plan(shape)


def test_wide_rows_take_shorter_tiles_and_too_wide_ones_raise():
    """A flat tile is whole rows, so W bounds it: rows up to 227 KB of two
    windows (and the output run) take 1-row tiles; wider ones raise rather
    than run."""
    p = _plan((1, 8, 9, 6000), torch.float32, 4)
    assert p.mode == "flat" and p.th <= 2 and p.smem <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        _plan((1, 8, 9, 20000), torch.float32, 4)
