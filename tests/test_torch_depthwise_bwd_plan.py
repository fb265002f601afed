"""The NHWC depthwise backward kernel's plan and decomposition, on the CPU.

``csrc/depthwise_bwd.cu`` (K4 stride 1, K5 stride 2) computes dx and dk in
one pass over each tile's zero-filled x and g windows staged in shared
memory (variant ``tile``) or over the bands its taps reach (``gather``),
as ``kernels/depthwise.py`` ``_bwd_plan`` lays them out, and sums dk per
block before a final pass over the blocks' partial rows.  The CUDA kernel
runs only on the card; here ``depthwise_conv_backward_tiled_emulation``
walks the same blocks in PyTorch and is held against the plain backward,
the JAX package's Pallas stencil VJPs (interpret mode) and lax, and the
plan's tiles and windows are checked against what they must cover.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.kernels.depthwise3 import depthwise_stencil, depthwise_stencil_s2
from deeplabv3plus_keras_tpu_torch.kernels.depthwise import (
    _bwd_plan,
    depthwise_conv_backward_plain,
    depthwise_conv_backward_tiled_emulation,
    same_pads,
)

torch.set_num_threads(1)

# (B, C, H, W), k, stride, dilation: k 3/5/7, both strides, even and odd
# sizes, C not a multiple of 4 or 8, tiny maps at the flagship's dilated
# ASPP rates (whole taps in the padding), tiles cut on both axes.
PLAN_CASES = [
    ((2, 40, 37, 45), 3, 1, (1, 1)),
    ((1, 21, 33, 31), 3, 2, (1, 1)),
    ((1, 24, 16, 16), 3, 2, (1, 1)),
    ((1, 3, 9, 11), 5, 1, (2, 2)),
    ((2, 16, 4, 4), 3, 1, (18, 15)),
    ((1, 8, 4, 4), 3, 1, (6, 21)),
    ((1, 40, 19, 23), 3, 1, (6, 3)),
    ((1, 12, 10, 13), 5, 2, (1, 1)),
    ((1, 8, 9, 9), 5, 2, (1, 1)),
    ((1, 8, 6, 6), 7, 2, (1, 1)),
    ((1, 40, 20, 21), 7, 1, (1, 1)),
    ((1, 24, 17, 16), 3, 2, (1, 1)),
]
# (dtype the plan is made for, pointer alignment): the vector instantiation
# (4 float32 or 8 bfloat16 channels per 16 bytes) and the narrow one.
PLAN_KINDS = [(torch.float32, 16), (torch.float32, 4), (torch.bfloat16, 16)]


def _plan(shape, k, stride, dil, dtype=torch.float32, align=16):
    B, C, H, W = shape
    return _bwd_plan(B, C, H, W, k, stride, dil, dtype, align)


def _inputs(seed, shape, k, stride, dil, dtype):
    rng = np.random.default_rng(seed)
    B, C, H, W = shape
    Ho, Wo = same_pads(H, k, stride, dil[0])[0], same_pads(W, k, stride, dil[1])[0]
    x = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(C, 1, k, k))).to(dtype)
    g = torch.from_numpy(rng.normal(size=(B, C, Ho, Wo))).to(dtype)
    cl = torch.channels_last
    return x.contiguous(memory_format=cl), w, g.contiguous(memory_format=cl)


def _check_against_plain(shape, k, stride, dil, plan, dtype, seed):
    x, w, g = _inputs(seed, shape, k, stride, dil, dtype)
    dx, dk = depthwise_conv_backward_tiled_emulation(x, w, g, stride, dil, plan)
    rdx, rdk = depthwise_conv_backward_plain(x, w, g, stride, dil)
    assert dx.shape == rdx.shape and dk.shape == rdk.shape
    assert not dx.isnan().any() and not dk.isnan().any()
    # float32: sums of <= k*k products (dx) and of B*Ho*Wo products (dk) in
    # another order than the plain version's
    atol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(dx, rdx, atol=atol, rtol=0)
    _, dk_abs = depthwise_conv_backward_plain(x.abs(), w, g.abs(), stride, dil)
    assert ((dk - rdk).abs() <= (1e-6 if dtype == torch.float32 else 1e-13) * dk_abs + 1e-30).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape,k,stride,dil", PLAN_CASES)
def test_emulation_matches_plain(shape, k, stride, dil, kind, align, dtype):
    plan = _plan(shape, k, stride, dil, kind, align)
    _check_against_plain(shape, k, stride, dil, plan, dtype, sum(shape) + k)


# Where the plan's own choices change: maps narrower than one strip or of
# one pixel, several channel blocks (72 float32 channels are 18 vectors in
# blocks of 8; 36 unaligned are 36 narrow lanes in blocks of 32), tiles
# taller than the map, walks that cross images (5 images of one row tile),
# and at stride 2 with k = 5 and 7 a row and a column of dx tiles past the
# output tiles (the dx tiles start at −pad_t and must reach H − 1).
EDGE_CASES = [
    ((1, 8, 3, 3), 3, 1, (1, 1)),
    ((1, 8, 3, 3), 3, 2, (1, 1)),
    ((1, 16, 1, 1), 3, 1, (1, 1)),
    ((1, 16, 1, 1), 3, 2, (1, 1)),
    ((2, 72, 6, 5), 3, 1, (1, 1)),
    ((1, 36, 9, 7), 3, 2, (1, 1)),
    ((5, 8, 8, 8), 3, 1, (1, 1)),
    ((3, 16, 6, 6), 5, 1, (3, 3)),
    ((1, 8, 16, 16), 5, 2, (1, 1)),
    ((1, 8, 16, 16), 7, 2, (1, 1)),
    ((1, 4, 12, 12), 7, 2, (1, 1)),
    ((1, 64, 8, 40), 3, 2, (1, 1)),
]


@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape,k,stride,dil", EDGE_CASES)
def test_emulation_matches_plain_at_plan_edges(shape, k, stride, dil, kind, align):
    plan = _plan(shape, k, stride, dil, kind, align)
    assert plan.threads <= 256 and plan.smem <= 227 * 1024
    _check_against_plain(shape, k, stride, dil, plan, torch.float64, sum(shape) * 7 + k)


def test_extra_dx_tiles_at_stride_2():
    """TF SAME pads (1, 2) at k = 5 on an even size: the output tiles' dx
    tiles would stop at H − 2, so the plan adds a row and a column of tiles."""
    p = _plan((1, 8, 16, 16), 5, 2, (1, 1))
    assert p.pads == (1, 1) and p.out_hw == (8, 8)
    assert p.nty * p.th == 16 and p.tiles_w * p.tw == 16
    assert _plan((1, 8, 16, 16), 3, 2, (1, 1)).nty == 1


@pytest.mark.parametrize("shape,dil", [((2, 16, 4, 4), (18, 15)), ((1, 8, 4, 4), (6, 21)),
                                       ((1, 8, 32, 32), (18, 15))])
def test_taps_wholly_in_the_padding_have_zero_dk(shape, dil):
    x, w, g = _inputs(3, shape, 3, 1, dil, torch.float32)
    dx, dk = depthwise_conv_backward_tiled_emulation(x, w, g, 1, dil, _plan(shape, 3, 1, dil))
    H, W = shape[2:]
    for ky in range(3):
        for kx in range(3):
            if abs(ky - 1) * dil[0] >= H or abs(kx - 1) * dil[1] >= W:
                assert (dk[:, 0, ky, kx] == 0).all()
            else:
                assert dk[:, 0, ky, kx].abs().min() > 0


def _emulate_nhwc(x, k_hwio, g, stride=1, dil=(1, 1)):
    """(dx NHWC, dk HWIO) of the emulation on numpy NHWC inputs."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    w = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    plan = _plan(tuple(xt.shape), k_hwio.shape[0], stride, dil)
    dx, dk = depthwise_conv_backward_tiled_emulation(xt, w, gt, stride, dil, plan)
    return dx.permute(0, 2, 3, 1).numpy(), dk.numpy().transpose(2, 3, 1, 0)


def _assert_bwd_close(port, ref):
    """The bounds of tests/test_torch_kernels.py (the JAX package's own for
    its stencil VJPs): dx 1e-5 absolute, dk 2e-6 of its max."""
    (dx, dk), (rdx, rdk) = port, ref
    np.testing.assert_allclose(dx, rdx, atol=1e-5, rtol=0)
    scale = float(np.abs(rdk).max())
    np.testing.assert_allclose(dk / scale, rdk / scale, atol=2e-6, rtol=0)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dil", [(1, 1), (2, 3)])
def test_emulation_matches_pallas_vjp(k, dil):
    """Against ``jax.vjp`` of the stride-1 Pallas stencil: its backward is
    K4's TPU kernel (``_dw_bwd_nhwc``), run in interpret mode."""
    rng = np.random.default_rng(k * 100 + dil[1])
    x, kern, g = _rand(rng, 1, 8, 16, 8), _rand(rng, k, k, 1, 8), _rand(rng, 1, 8, 16, 8)
    _, vjp = jax.vjp(lambda a, b: depthwise_stencil(a, b, dil), jnp.asarray(x), jnp.asarray(kern))
    rdx, rdk = vjp(jnp.asarray(g))
    _assert_bwd_close(_emulate_nhwc(x, kern, g, 1, dil), (np.asarray(rdx), np.asarray(rdk)))


@pytest.mark.parametrize("k", [3, 5])
def test_emulation_matches_pallas_vjp_s2(k):
    """Against ``jax.vjp`` of the stride-2 Pallas stencil: K5's TPU kernel
    (``_dw_bwd_s2``, parity planes merged), run in interpret mode."""
    rng = np.random.default_rng(k + 50)
    x, kern, g = _rand(rng, 1, 8, 16, 8), _rand(rng, k, k, 1, 8), _rand(rng, 1, 4, 8, 8)
    _, vjp = jax.vjp(depthwise_stencil_s2, jnp.asarray(x), jnp.asarray(kern))
    rdx, rdk = vjp(jnp.asarray(g))
    _assert_bwd_close(_emulate_nhwc(x, kern, g, 2), (np.asarray(rdx), np.asarray(rdk)))


# tests/test_torch_kernels.py LAX_CASES: shapes the Pallas stencils do not
# take (taps wholly in the padding; odd sizes at stride 2).
LAX_CASES = [
    ((2, 4, 4, 16), 3, 1, (18, 15)),
    ((1, 4, 4, 8), 3, 1, (6, 21)),
    ((1, 5, 7, 8), 5, 1, (3, 4)),
    ((1, 7, 9, 8), 3, 2, (1, 1)),
    ((1, 6, 6, 8), 7, 2, (1, 1)),
]


@pytest.mark.parametrize("shape,k,stride,dil", LAX_CASES)
def test_emulation_matches_lax_vjp(shape, k, stride, dil):
    rng = np.random.default_rng(sum(shape) + k + 7)
    x, kern = _rand(rng, *shape), _rand(rng, k, k, 1, shape[-1])

    def conv(a, b):
        return jax.lax.conv_general_dilated(
            a, b, (stride, stride), "SAME", rhs_dilation=dil,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=shape[-1],
            precision=jax.lax.Precision.HIGHEST)

    y, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(kern))
    g = _rand(rng, *y.shape)
    rdx, rdk = vjp(jnp.asarray(g))
    _assert_bwd_close(_emulate_nhwc(x, kern, g, stride, dil), (np.asarray(rdx), np.asarray(rdk)))


def _tiles(plan):
    """(b, c0, ho0, wo0) of every tile of every block's walk."""
    for _, c0, wo0, walk in plan.blocks():
        for b, ho0 in walk:
            yield b, c0, ho0, wo0


@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape,k,stride,dil", PLAN_CASES + EDGE_CASES)
def test_plan_tiles_cover_every_dx_pixel_and_output_once(shape, k, stride, dil, kind, align):
    plan = _plan(shape, k, stride, dil, kind, align)
    B, C, H, W = shape
    Ho, Wo = plan.out_hw
    dr, dc = plan.dx_tile
    seen_dx = torch.zeros(B, H, W, C, dtype=torch.int32)
    seen_dk = torch.zeros(B, Ho, Wo, C, dtype=torch.int32)
    rows = torch.zeros(plan.dk_buffer[0], C, dtype=torch.int32)
    for slot, c0, _, walk in plan.blocks():
        rows[slot, c0:c0 + plan.cb] += 1
    for b, c0, ho0, wo0 in _tiles(plan):
        seen_dk[b, ho0:ho0 + plan.th, wo0:wo0 + plan.tw, c0:c0 + plan.cb] += 1
        dy0, dx0 = plan.dx_origin(ho0, wo0)
        seen_dx[b, max(dy0, 0):max(dy0 + dr, 0), max(dx0, 0):max(dx0 + dc, 0), c0:c0 + plan.cb] += 1
    assert (seen_dk == 1).all() and (seen_dx == 1).all()
    # each partial row holds every channel once: one block per (row, channel block)
    assert (rows == 1).all()


@pytest.mark.parametrize("kind,align", PLAN_KINDS)
@pytest.mark.parametrize("shape,k,stride,dil", PLAN_CASES + EDGE_CASES)
def test_plan_windows_cover_every_in_image_tap_and_no_more(shape, k, stride, dil, kind, align):
    """Each tile's x window holds every input pixel its outputs' taps reach
    in the image, and its g window every g pixel that reaches its dx pixels
    in the map; each window is exactly the hull of those taps (edges
    included), so it holds no row or column that no tap uses.  Gathered,
    the bands hold every in-image tap."""
    plan = _plan(shape, k, stride, dil, kind, align)
    _, _, H, W = shape
    (Ho, Wo), (pt, pl), s = plan.out_hw, plan.pads, stride
    dh, dw = dil
    dr, dc = plan.dx_tile
    for _, _, ho0, wo0 in _tiles(plan):
        outs_h, outs_w = range(ho0, ho0 + plan.th), range(wo0, wo0 + plan.tw)
        x_h = {o * s - pt + ky * dh for o in outs_h for ky in range(k)}
        x_w = {o * s - pl + kx * dw for o in outs_w for kx in range(k)}
        dy0, dx0 = plan.dx_origin(ho0, wo0)
        # g pixel o reaches dx pixel i through tap t when o*S - pad + t*d == i
        g_h = {(i + pt - ky * dh) // s for i in range(dy0, dy0 + dr) for ky in range(k)
               if (i + pt - ky * dh) % s == 0}
        g_w = {(j + pl - kx * dw) // s for j in range(dx0, dx0 + dc) for kx in range(k)
               if (j + pl - kx * dw) % s == 0}
        if plan.variant == "tile":
            (xr, xc), (gr, gc) = plan.x_window, plan.g_window
            top, left = ho0 * s - pt, wo0 * s - pl
            assert (min(x_h), max(x_h), min(x_w), max(x_w)) == (top, top + xr - 1, left, left + xc - 1)
            gy0, gx0 = plan.g_origin(ho0, wo0)
            assert (min(g_h), max(g_h), min(g_w), max(g_w)) == (gy0, gy0 + gr - 1, gx0, gx0 + gc - 1)
        else:
            assert s == 1
            bands_x = {ho0 + i - pt + ky * dh for i in range(plan.th) for ky in range(k)}
            bands_g = {ho0 + i + pt - ky * dh for i in range(plan.th) for ky in range(k)}
            assert {i for i in x_h if 0 <= i < H} <= bands_x
            assert {o for o in g_h if 0 <= o < Ho} <= bands_g


# The flagship train step's K4/K5 sites (MobileNetV2 os 16 at B=16, 512²),
# and Xception's widest.
FLAGSHIP_SITES = [
    ((16, 32, 256, 256), 1, (1, 1)), ((16, 144, 128, 128), 1, (1, 1)),
    ((16, 192, 64, 64), 1, (1, 1)), ((16, 384, 32, 32), 1, (1, 1)),
    ((16, 576, 32, 32), 1, (1, 1)), ((16, 96, 32, 32), 1, (1, 1)),
    ((16, 256, 32, 32), 1, (1, 1)), ((16, 256, 32, 32), 1, (18, 15)),
    ((16, 256, 32, 32), 1, (6, 3)), ((16, 256, 32, 32), 1, (6, 21)),
    ((16, 96, 256, 256), 2, (1, 1)), ((16, 144, 128, 128), 2, (1, 1)),
    ((16, 192, 64, 64), 2, (1, 1)), ((16, 1024, 32, 32), 1, (1, 1)),
]


@pytest.mark.parametrize("shape,stride,dil", FLAGSHIP_SITES)
def test_plan_fits_the_card(shape, stride, dil):
    """Blocks of at most 256 threads, at most 227 KB of shared memory, a
    grid the card takes, and a partial buffer of at most 2 % of |x|."""
    B, C, H, W = shape
    for dtype in (torch.float32, torch.bfloat16):
        p = _plan(shape, 3, stride, dil, dtype)
        assert p.threads <= 256 and p.smem <= 227 * 1024 and p.grid[1] <= 65535
        assert p.variant == ("tile" if dil == (1, 1) else "gather")
        assert math.prod(p.dk_buffer) * 4 <= 0.02 * B * C * H * W * dtype.itemsize


@pytest.mark.parametrize("shape,k,stride", [((2, 40, 20, 21), 5, 1), ((2, 40, 20, 21), 7, 1),
                                            ((2, 64, 20, 21), 5, 2), ((2, 64, 20, 21), 7, 2),
                                            ((2, 36, 20, 21), 7, 2)])
def test_plan_fits_the_card_at_k5_k7(shape, k, stride):
    for kind, align in PLAN_KINDS:
        p = _plan(shape, k, stride, (1, 1), kind, align)
        assert p.threads <= 256 and p.smem <= 227 * 1024


def test_plan_variants_and_vector_widths():
    p = _plan((16, 32, 256, 256), 3, 1, (1, 1))
    assert (p.variant, p.vec, p.nv, p.cb, p.th, p.tw) == ("tile", 4, 8, 32, 8, 8)
    assert p.walk == 9 and p.grid == (32, -(-16 * 32 // 9)) and p.g_window == (10, 10)
    s2 = _plan((16, 96, 256, 256), 3, 2, (1, 1))
    assert (s2.variant, s2.x_window, s2.g_window, s2.dx_tile) == ("tile", (17, 17), (9, 9), (16, 16))
    g = _plan((16, 256, 32, 32), 3, 1, (18, 15))
    assert (g.variant, g.vec, g.th, g.threads, g.walk) == ("gather", 4, 8, 256, 9)
    assert _plan((16, 64, 32, 32), 3, 1, (1, 1), torch.bfloat16).vec == 8
    # the narrow instantiation: C not a multiple of the vector, or a pointer
    # (x, g or dx) that is not 16-byte aligned
    assert _plan((1, 21, 33, 31), 3, 2, (1, 1)).vec == 1
    assert _plan((1, 12, 8, 8), 3, 1, (1, 1), torch.bfloat16).vec == 1
    assert _plan((1, 40, 8, 8), 3, 1, (1, 1), torch.float32, 4).vec == 1
    # the plan is the shape's alone: the same object for the same call
    assert _plan((16, 32, 256, 256), 3, 1, (1, 1)) is p
