"""The NHWC depthwise forward kernel's plan and decomposition, on the CPU.

``csrc/depthwise_fwd.cu`` (K2 stride 1, K3 stride 2) computes each tile of
outputs from a zero-filled input window staged in shared memory (variant
``tile``) or from the row and column bands its taps reach (``gather``), as
``kernels/depthwise.py`` ``_fwd_plan`` lays them out.  The CUDA kernel runs
only on the card; here ``depthwise_conv_tiled_emulation`` walks the same
tiles in PyTorch and is held against the plain version, the JAX package's
Pallas stencils (interpret mode) and lax, and the plan's windows are
checked against the taps they must cover.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.kernels.depthwise3 import depthwise_stencil, depthwise_stencil_s2
from deeplabv3plus_keras_tpu_torch.kernels.depthwise import (
    _fwd_plan,
    depthwise_conv_plain,
    depthwise_conv_tiled_emulation,
)

torch.set_num_threads(1)

# (B, C, H, W), k, stride, dilation: tiles cut on both axes (odd H and W),
# C not a multiple of 4 or 8, dilations larger than the map, k 5 and 7.
PLAN_CASES = [
    ((2, 40, 37, 45), 3, 1, (1, 1)),
    ((1, 21, 33, 31), 3, 2, (1, 1)),
    ((1, 3, 9, 11), 5, 1, (2, 2)),
    ((2, 16, 4, 4), 3, 1, (18, 15)),
    ((1, 8, 4, 4), 3, 1, (6, 21)),
    ((1, 40, 19, 23), 3, 1, (6, 3)),
    ((1, 12, 10, 13), 5, 2, (1, 1)),
    ((1, 8, 6, 6), 7, 2, (1, 1)),
    ((1, 40, 20, 21), 7, 1, (1, 1)),
    ((1, 24, 17, 16), 3, 2, (1, 1)),
    # NASNet-Mobile's narrow sites: C = 11, k = 7, odd and even maps
    ((1, 11, 17, 17), 7, 2, (1, 1)),
    ((1, 11, 16, 16), 7, 1, (1, 1)),
]
# (dtype the plan is made for, pointer alignment): the vector instantiation
# (4 float32 or 8 bfloat16 channels per 16 bytes) and the narrow one.
PLAN_KINDS = [(torch.float32, 16), (torch.float32, 4), (torch.bfloat16, 16)]


def _plan(shape, k, stride, dil, dtype=torch.float32, align=16):
    B, C, H, W = shape
    return _fwd_plan(B, C, H, W, k, stride, dil, dtype, align)


def _inputs(seed, shape, k):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(shape[1], 1, k, k)).astype(np.float32))
    return x.contiguous(memory_format=torch.channels_last), w


@pytest.mark.parametrize("dtype,align", PLAN_KINDS)
@pytest.mark.parametrize("shape,k,stride,dil", PLAN_CASES)
def test_emulation_matches_plain(shape, k, stride, dil, dtype, align):
    x, w = _inputs(sum(shape) + k, shape, k)
    plan = _plan(shape, k, stride, dil, dtype, align)
    out = depthwise_conv_tiled_emulation(x, w, stride, dil, plan)
    ref = depthwise_conv_plain(x, w, stride, dil)
    assert out.shape == ref.shape and not out.isnan().any()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


# Where the plan's own choices change: maps narrower than one strip (one
# strip per tile) or of one pixel, several channel blocks (72 float32
# channels are 18 vectors in blocks of 8; 36 channels unaligned are 36 narrow
# lanes in blocks of 32), tiles taller than the map.
EDGE_CASES = [
    ((1, 8, 3, 3), 3, 1, (1, 1)),
    ((1, 8, 3, 3), 3, 2, (1, 1)),
    ((1, 16, 1, 1), 3, 1, (1, 1)),
    ((1, 16, 1, 1), 3, 2, (1, 1)),
    ((2, 72, 6, 5), 3, 1, (1, 1)),
    ((1, 36, 9, 7), 3, 2, (1, 1)),
    ((1, 4, 12, 12), 7, 2, (1, 1)),
    ((1, 48, 5, 9), 5, 1, (1, 1)),
    ((1, 24, 10, 10), 3, 1, (3, 3)),
    ((1, 64, 8, 40), 3, 2, (1, 1)),
]


@pytest.mark.parametrize("dtype,align", PLAN_KINDS)
@pytest.mark.parametrize("shape,k,stride,dil", EDGE_CASES)
def test_emulation_matches_plain_at_plan_edges(shape, k, stride, dil, dtype, align):
    x, w = _inputs(sum(shape) * 7 + k, shape, k)
    plan = _plan(shape, k, stride, dil, dtype, align)
    assert plan.threads <= 256 and plan.smem <= 227 * 1024
    torch.testing.assert_close(depthwise_conv_tiled_emulation(x, w, stride, dil, plan),
                               depthwise_conv_plain(x, w, stride, dil), atol=1e-5, rtol=0)


def _emulate_nhwc(x, k_hwio, stride=1, dil=(1, 1)):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    plan = _plan(tuple(xt.shape), k_hwio.shape[0], stride, dil)
    return depthwise_conv_tiled_emulation(xt, w, stride, dil, plan).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dil", [(1, 1), (2, 3)])
def test_emulation_matches_pallas_stencil(k, dil):
    """Against the JAX package's stride-1 Pallas stencil (``_dw_fwd_nhwc``),
    in interpret mode, as ``tests/test_torch_kernels.py`` runs it."""
    rng = np.random.default_rng(k * 10 + dil[1])
    x = rng.normal(size=(1, 8, 16, 8)).astype(np.float32)
    kern = rng.normal(size=(k, k, 1, 8)).astype(np.float32)
    ref = np.asarray(depthwise_stencil(jnp.asarray(x), jnp.asarray(kern), dil))
    np.testing.assert_allclose(_emulate_nhwc(x, kern, 1, dil), ref, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
def test_emulation_matches_pallas_stencil_s2(k):
    """Against the stride-2 Pallas stencil over parity planes (``_dw_fwd_s2``)."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(1, 8, 16, 8)).astype(np.float32)
    kern = rng.normal(size=(k, k, 1, 8)).astype(np.float32)
    ref = np.asarray(depthwise_stencil_s2(jnp.asarray(x), jnp.asarray(kern)))
    out = _emulate_nhwc(x, kern, 2)
    assert out.shape == (1, 4, 8, 8)
    np.testing.assert_allclose(out, ref, atol=1e-5)


# tests/test_torch_kernels.py LAX_CASES: shapes the Pallas stencil does not
# take (taps wholly in the padding; odd sizes at stride 2).
LAX_CASES = [
    ((2, 4, 4, 16), 3, 1, (18, 15)),
    ((1, 4, 4, 8), 3, 1, (6, 21)),
    ((1, 5, 7, 8), 5, 1, (3, 4)),
    ((1, 7, 9, 8), 3, 2, (1, 1)),
    ((1, 6, 6, 8), 7, 2, (1, 1)),
]


@pytest.mark.parametrize("shape,k,stride,dil", LAX_CASES)
def test_emulation_matches_lax(shape, k, stride, dil):
    rng = np.random.default_rng(sum(shape) + k)
    x = rng.normal(size=shape).astype(np.float32)
    kern = rng.normal(size=(k, k, 1, shape[-1])).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kern), (stride, stride), "SAME", rhs_dilation=dil,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=shape[-1],
        precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(_emulate_nhwc(x, kern, stride, dil), ref, atol=1e-5)


@pytest.mark.parametrize("dtype,align", PLAN_KINDS)
@pytest.mark.parametrize("shape,k,stride,dil", PLAN_CASES)
def test_plan_tiles_cover_every_output_once(shape, k, stride, dil, dtype, align):
    plan = _plan(shape, k, stride, dil, dtype, align)
    B, C = shape[:2]
    Ho, Wo = plan.out_hw
    seen = torch.zeros(B, Ho, Wo, C, dtype=torch.int32)
    for b, c0, ho0, wo0 in plan.tiles():
        seen[b, ho0:ho0 + plan.th, wo0:wo0 + plan.tw, c0:c0 + plan.cb] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype,align", PLAN_KINDS)
@pytest.mark.parametrize("shape,k,stride,dil", PLAN_CASES)
def test_plan_window_covers_every_in_image_tap_and_no_more(shape, k, stride, dil, dtype, align):
    """Each tile's staged window (or, gathered, its bands) holds every tap
    of its outputs that lies in the image, and is exactly the design's
    size: ((TH−1)·S + (k−1)·dh + 1) × ((TW−1)·S + (k−1)·dw + 1) for a
    window, TH·k rows × TW·k columns of bands."""
    plan = _plan(shape, k, stride, dil, dtype, align)
    _, _, H, W = shape
    (Ho, Wo), (pt, pl), s = plan.out_hw, plan.pads, stride
    dh, dw = dil
    rows_n, cols_n = plan.window
    assert (rows_n, cols_n) == ((plan.th - 1) * s + (k - 1) * dh + 1,
                                (plan.tw - 1) * s + (k - 1) * dw + 1)
    for _, _, ho0, wo0 in plan.tiles():
        outs_h = range(ho0, min(ho0 + plan.th, Ho))
        outs_w = range(wo0, min(wo0 + plan.tw, Wo))
        need_h = {o * s - pt + ky * dh for o in outs_h for ky in range(k)}
        need_w = {o * s - pl + kx * dw for o in outs_w for kx in range(k)}
        need_h = {i for i in need_h if 0 <= i < H}
        need_w = {i for i in need_w if 0 <= i < W}
        if plan.variant == "tile":
            top, left = ho0 * s - pt, wo0 * s - pl
            assert need_h <= set(range(top, top + rows_n))
            assert need_w <= set(range(left, left + cols_n))
            # the first and last row/column of the window are taps of the tile
            assert top + rows_n - 1 == (ho0 + plan.th - 1) * s - pt + (k - 1) * dh
            assert left + cols_n - 1 == (wo0 + plan.tw - 1) * s - pl + (k - 1) * dw
        else:
            bands_h = [(ho0 + i) * s - pt + ky * dh for ky in range(k) for i in range(plan.th)]
            bands_w = [(wo0 + j) * s - pl + kx * dw for kx in range(k) for j in range(plan.tw)]
            assert len(bands_h) == plan.th * k and len(bands_w) == plan.tw * k
            assert need_h <= set(bands_h) and need_w <= set(bands_w)


def test_plan_variants_and_vector_widths():
    # the flagship's undilated, stride-2 and dilated ASPP sites, float32
    p = _plan((16, 32, 256, 256), 3, 1, (1, 1))
    assert (p.variant, p.vec, p.nv, p.cb) == ("tile", 4, 8, 32)
    assert p.threads <= 256 and (p.th, p.tw) == (8, 8) and p.smem > 0
    assert p.grid == (256 // 8, 256 // 8, 16)
    assert _plan((16, 96, 256, 256), 3, 2, (1, 1)).variant == "tile"
    g = _plan((16, 256, 32, 32), 3, 1, (18, 15))
    assert (g.variant, g.vec, g.smem) == ("gather", 4, 0)
    # bfloat16: 8 channels per 16 bytes
    assert _plan((16, 64, 32, 32), 3, 1, (1, 1), torch.bfloat16).vec == 8
    # the narrow instantiation: C not a multiple of the vector, or a pointer
    # that is not 16-byte aligned
    assert _plan((1, 21, 33, 31), 3, 2, (1, 1)).vec == 1
    assert _plan((1, 12, 8, 8), 3, 1, (1, 1), torch.bfloat16).vec == 1
    assert _plan((1, 40, 8, 8), 3, 1, (1, 1), torch.float32, 4).vec == 1
    # Xception's 728 channels: 182 vectors in 23 blocks of 8
    assert _plan((16, 728, 32, 32), 3, 1, (1, 1)).cblocks == 23


@pytest.mark.parametrize("shape,k,stride", [
    ((16, 32, 256, 256), 3, 1), ((16, 96, 256, 256), 3, 2), ((16, 384, 32, 32), 3, 1),
    ((16, 1024, 32, 32), 3, 1), ((2, 40, 20, 21), 7, 1), ((2, 64, 20, 21), 7, 2),
    # EfficientNet-B7's widest k = 5 site, NASNet's k = 7 stride-2 sites
    ((16, 1344, 32, 32), 5, 1), ((16, 32, 255, 255), 7, 2), ((16, 11, 255, 255), 7, 2),
])
def test_plan_fits_the_card(shape, k, stride):
    """Blocks of at most 256 threads, at most 227 KB of shared memory (the
    window in a 128-byte multiple, the barrier's 16-byte slot, and for
    k > 3 the block's taps), and a grid the card takes."""
    for dtype in (torch.float32, torch.bfloat16):
        p = _plan(shape, k, stride, (1, 1), dtype)
        item = dtype.itemsize
        rows, cols = p.window
        buf = -(-rows * cols * p.cb * item // 128) * 128
        assert p.smem == buf + 16 + (k * k * p.cb * 4 if k > 3 else 0) <= 227 * 1024
        assert p.threads <= 256 and p.grid[1] <= 65535 and p.grid[2] == shape[0]
