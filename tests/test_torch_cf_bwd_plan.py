"""The channels-first depthwise backward's plan and decomposition, on the CPU.

``csrc/depthwise_cf.cu`` ``dw_cf_bwd`` (K7) computes dx and dk of the 3×3
stride-1 SAME depthwise conv of NCHW-contiguous tensors as
``kernels/depthwise.py`` ``_cf_bwd_plan`` lays it out: a block owns one
channel and walks tiles of the flattened (image, tile) index (a whole
plane at small sizes, so the block walks the batch), with a one-pixel
halo; dk is summed per block over its walk, and where the plan splits a
channel among groups of blocks, a final pass adds their rows in a fixed
order.  The CUDA kernel runs only on the card; here
``depthwise_cf_backward_emulation`` walks the same blocks in PyTorch and is
held against the plain backward and the JAX package's Pallas kernel
``_dw_bwd_padded`` (interpret mode, directly and as ``depthwise3x3``'s VJP
under ``DLV3_DW_LAYOUT=bhcw``), and the plans are checked against what
they must cover and what the card takes.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.kernels.depthwise3 import _dw_bwd_padded, _to_bhcw_padded, depthwise3x3
from deeplabv3plus_keras_tpu_torch.kernels.depthwise import (
    _cf_bwd_plan,
    depthwise_conv_backward_plain,
    depthwise_cf_backward_emulation,
)

torch.set_num_threads(1)

# (B, C, H, W): odd and even H and W, B = 1 and 3, planes that are one tile
# and planes cut on both axes, C at, below and above the vector width.
SHAPES = [
    (1, 8, 9, 13),
    (3, 5, 37, 45),
    (3, 16, 16, 16),
    (1, 4, 33, 32),
    (2, 12, 70, 131),
    (3, 24, 8, 8),
    (1, 3, 1, 1),
    (2, 700, 4, 4),
]
# (dtype the plan is made for, pointer alignment): the vector copies
# (float32 and bfloat16) and the element copies (a misaligned pointer).
PLAN_KINDS = [(torch.float32, 16), (torch.float32, 4), (torch.bfloat16, 16)]


def _plan(shape, dtype=torch.float32, align=16):
    return _cf_bwd_plan(*shape, dtype, align)


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    g = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(shape[1], 1, 3, 3))).to(dtype)
    return x, w, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_plain(shape, kind, align, dtype):
    x, w, g = _inputs(sum(shape), shape, dtype)
    dx, dk = depthwise_cf_backward_emulation(x, w, g, _plan(shape, kind, align))
    rdx, rdk = depthwise_conv_backward_plain(x, w, g)
    assert not dx.isnan().any() and dx.shape == rdx.shape and dk.shape == rdk.shape
    # float32: sums of 9 products (dx) and of B*H*W products (dk) in another
    # order than the plain version's
    f32 = dtype == torch.float32
    torch.testing.assert_close(dx, rdx, atol=5e-6 if f32 else 1e-12, rtol=0)
    _, dk_abs = depthwise_conv_backward_plain(x.abs(), w, g.abs())
    assert ((dk - rdk).abs() <= (1e-5 if f32 else 1e-13) * dk_abs + 1e-30).all()


def _pallas_bwd(x, k, g):
    """(dx NHWC, dk HWIO) of ``_dw_bwd_padded`` in interpret mode."""
    C = x.shape[-1]
    dx, dk9 = _dw_bwd_padded(_to_bhcw_padded(jnp.asarray(x)), _to_bhcw_padded(jnp.asarray(g)),
                             jnp.asarray(k).reshape(9, C, 1), True)
    return np.asarray(jnp.transpose(dx, (0, 1, 3, 2))), np.asarray(dk9).reshape(3, 3, 1, C)


def _emulated(x, k, g, kind=torch.float32, align=16):
    """(dx NHWC, dk HWIO) of the emulation on numpy NHWC inputs."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous()
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    dx, dk = depthwise_cf_backward_emulation(xt, w, gt, _plan(tuple(xt.shape), kind, align))
    return dx.permute(0, 2, 3, 1).numpy(), dk.numpy().transpose(2, 3, 1, 0)


def _assert_close_to_jax(port, ref, x, g):
    """dx 5e-6 absolute (the JAX package's bound for its stencil,
    tests/test_kernels.py:117); dk 1e-5 of Σ|x·g| per tap and channel."""
    (dx, dk), (rdx, rdk) = port, ref
    np.testing.assert_allclose(dx, rdx, atol=5e-6, rtol=0)
    _, dk_abs = depthwise_conv_backward_plain(
        torch.from_numpy(np.abs(x)).permute(0, 3, 1, 2), torch.ones(x.shape[-1], 1, 3, 3),
        torch.from_numpy(np.abs(g)).permute(0, 3, 1, 2))
    assert (np.abs(dk - rdk) <= 1e-5 * dk_abs.numpy().transpose(2, 3, 1, 0)).all()


# (B, H, W, C) NHWC for the Pallas kernel: odd H and W, B = 1 and 3
JAX_SHAPES = [(1, 9, 13, 8), (3, 16, 16, 4), (1, 37, 45, 3), (3, 7, 33, 8)]


@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_emulation_matches_pallas_dw_bwd_padded(shape, kind, align):
    rng = np.random.default_rng(sum(shape) + align)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 1, shape[-1])) * 0.5).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    _assert_close_to_jax(_emulated(x, k, g, kind, align), _pallas_bwd(x, k, g), x, g)


@pytest.mark.parametrize("shape", [(3, 11, 17, 8), (1, 32, 32, 16)])
def test_emulation_matches_depthwise3x3_vjp_under_bhcw(shape, monkeypatch):
    """``depthwise3x3``'s VJP under ``DLV3_DW_LAYOUT=bhcw``: the route by
    which the JAX package reaches ``_dw_bwd_padded``."""
    monkeypatch.setenv("DLV3_DW_LAYOUT", "bhcw")
    rng = np.random.default_rng(sum(shape) + 1)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 1, shape[-1])) * 0.5).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(depthwise3x3, jnp.asarray(x), jnp.asarray(k))
    rdx, rdk = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    _assert_close_to_jax(_emulated(x, k, g), (rdx, rdk), x, g)


@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_pixel_once(shape, kind, align):
    """Each channel's blocks walk every (image, tile) position once, in
    order, and the tiles (whole rows) cover every output pixel of every
    image once."""
    B, C, H, W = shape
    plan = _plan(shape, kind, align)
    seen = torch.zeros(B, H, dtype=torch.int32)
    walked = []
    for grp, walk in plan.blocks():
        assert 1 <= len(walk) <= plan.walk
        walked += walk
        for b, h0 in walk:
            seen[b, h0:h0 + plan.th] += 1
    assert len(walked) == B * plan.tiles == len(set(walked))
    assert grp == plan.groups - 1 and (seen == 1).all()
    assert plan.tiles * plan.th >= H and (plan.tiles - 1) * plan.th < H
    assert plan.threads <= 256 and plan.smem <= 227 * 1024
    if plan.mode == "vec":
        assert 4 * plan.ncx >= W and W % (16 // kind.itemsize) == 0 and align % 16 == 0


# Xception's 8 distinct K7 sites at B=16, 512², os 16 (chip_smoke.py)
XCEPTION_SITES = [(16, 64, 253, 253), (16, 128, 253, 253), (16, 128, 127, 127),
                  (16, 256, 127, 127), (16, 256, 64, 64), (16, 728, 64, 64),
                  (16, 728, 32, 32), (16, 1024, 32, 32)]


@pytest.mark.parametrize("shape", XCEPTION_SITES)
def test_plan_fills_the_card_at_xception_sites(shape):
    """At least 2 blocks for each of the H100's 132 SMs (at least 5 an SM
    here: blocks walk 2 tiles), no SM more than 10 % above an even share of
    the tiles, at most 227 KB of shared memory and 256 threads a block;
    16-byte row copies at the even planes, flat copies at the odd ones
    (rows of 1012 and 508 float32 bytes); a whole 32² plane a tile."""
    B, C, H, W = shape
    for dtype in (torch.float32, torch.bfloat16):
        p = _plan(shape, dtype)
        assert p.grid == (C, p.groups) and C * p.groups >= 2 * 132
        per_sm = math.ceil(C * p.groups / 132) * p.walk
        assert per_sm <= 1.1 * C * B * p.tiles / 132
        assert p.smem <= 227 * 1024 and p.threads <= 256 and p.walk == 2
        assert p.mode == ("vec" if W % 8 == 0 else "flat")
        assert p.tiles == -(-H // 32 if p.mode == "vec" else -H // 16)
        assert math.ceil(B * p.tiles / p.walk) == p.groups
    assert _plan(shape) is _plan(shape)  # pure and cached: the same plan every call


def test_wide_rows_take_shorter_tiles_and_too_wide_ones_raise():
    """A flat tile is whole rows, so W bounds it: up to 4838 float32
    columns take 1-row tiles in 227 KB; wider rows raise rather than run."""
    p = _plan((1, 8, 9, 4838), torch.float32, 4)
    assert p.mode == "flat" and p.th == 1 and p.smem <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        _plan((1, 8, 9, 4900), torch.float32, 4)


def test_groups_sum_in_the_final_pass_order():
    """With several groups, dk is the final pass's fixed-order sum of the
    groups' rows: lane l adds rows l, l + 8, ..., then the lanes in order."""
    shape = (32, 8, 8, 8)
    plan = _plan(shape)
    assert plan.groups > 8
    x, w, g = _inputs(5, shape, torch.float64)
    _, dk = depthwise_cf_backward_emulation(x, w, g, plan)
    _, rdk = depthwise_conv_backward_plain(x, w, g)
    torch.testing.assert_close(dk, rdk, atol=1e-12, rtol=0)
