"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA card is present.  This file
imports neither JAX nor the JAX package, so on a machine that has a card
but no JAX it runs without the suite's ``conftest.py``:

    python -m pytest tests/test_torch_on_card.py --noconftest -m cuda -q
"""

import dataclasses
import math

import pytest
import torch

from deeplabv3plus_keras_tpu_torch import kernels
from deeplabv3plus_keras_tpu_torch.models import blocks
from deeplabv3plus_keras_tpu_torch.kernels import (
    depthwise_cf,
    depthwise_cf_backward,
    depthwise_conv,
    depthwise_conv_backward,
    depthwise_conv_backward_plain,
    depthwise_conv_plain,
    upsample_argmax,
    upsample_argmax_plain,
)

# (B, H, W, C), k, stride, dilation: taps wholly in the padding, odd sizes
# at stride 2, k 5 and 7, one backbone-like stride-2 site, and for the
# forward plan (kernels/depthwise.py _fwd_plan): tiles cut on both axes at
# stride 1 (C = 40, 4-channel vectors), odd sizes and C = 21 at stride 2
# (the narrow instantiation), C = 3 at k 5 with dilation (the gather
# variant, narrow).
DEPTHWISE_CASES = [
    ((2, 4, 4, 16), 3, 1, (18, 15)),
    ((1, 4, 4, 8), 3, 1, (6, 21)),
    ((1, 5, 7, 8), 5, 1, (3, 4)),
    ((1, 7, 9, 8), 3, 2, (1, 1)),
    ((1, 6, 6, 8), 7, 2, (1, 1)),
    ((2, 64, 64, 96), 3, 2, (1, 1)),
    ((2, 37, 45, 40), 3, 1, (1, 1)),
    ((1, 33, 31, 21), 3, 2, (1, 1)),
    ((1, 9, 11, 3), 5, 1, (2, 2)),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same comparison there")
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,stride,dil", DEPTHWISE_CASES)
def test_depthwise_kernel_matches_plain(card, shape, k, stride, dil):
    B, H, W, C = shape
    x = torch.randn(B, C, H, W, device="cuda", generator=card).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(C, 1, k, k, device="cuda", generator=card)
    before = kernels.launch_counts()[f"depthwise_fwd_s{stride}"]
    y = depthwise_conv(x, w, stride, dil)
    assert kernels.launch_counts()[f"depthwise_fwd_s{stride}"] == before + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    # float32 sums of k² products in another order than cuDNN's
    torch.testing.assert_close(y, depthwise_conv_plain(x, w, stride, dil), atol=1e-5, rtol=1e-5)


# Bounds against float64 by dtype: float32 sums; bfloat16 and float16 add
# the output's rounding, 2^-8 and 2^-11 relative.
_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}

# (B, H, W, C), k, stride, dilation, dtype, storage offset in elements:
# bfloat16 and float16 with C = 12 (not a multiple of 8: narrow), 16-bit
# vectors at both strides and dilated, and an x whose data_ptr is not
# 16-byte aligned.
FWD_EDGE_CASES = [
    ((2, 13, 17, 12), 3, 1, (1, 1), torch.bfloat16, 0),
    ((2, 21, 19, 64), 3, 2, (1, 1), torch.bfloat16, 0),
    ((1, 16, 16, 64), 3, 1, (4, 2), torch.bfloat16, 0),
    ((2, 13, 17, 12), 3, 1, (1, 1), torch.float16, 0),
    ((2, 21, 19, 64), 3, 2, (1, 1), torch.float16, 0),
    ((1, 16, 16, 64), 3, 1, (4, 2), torch.float16, 0),
    ((1, 18, 20, 48), 5, 2, (1, 1), torch.float16, 1),
    ((2, 19, 23, 40), 3, 1, (1, 1), torch.float32, 1),
    ((1, 18, 20, 40), 5, 2, (1, 1), torch.float32, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,stride,dil,dtype,offset", FWD_EDGE_CASES)
def test_depthwise_kernel_edges_match_plain(card, shape, k, stride, dil, dtype, offset):
    """Against the plain version in float64 on the same (rounded) inputs
    and taps: 1e-5 of its max for float32, 1e-2 for bfloat16 and 1e-3 for
    float16 (the output's rounding).  ``offset`` shifts x's storage by that many elements, so the
    plan must take the narrow instantiation."""
    B, H, W, C = shape
    base = torch.randn(B * H * W * C + offset, device="cuda", generator=card).to(dtype)
    x = base[offset:].view(B, H, W, C).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert (x.data_ptr() % 16 != 0) == (offset != 0)
    w = torch.randn(C, 1, k, k, device="cuda", generator=card)
    name = f"depthwise_fwd_s{stride}"
    before = kernels.launch_counts()[name]
    y = depthwise_conv(x, w, stride, dil)
    assert kernels.launch_counts()[name] == before + 1
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    ref = depthwise_conv_plain(x.double(), w.to(dtype).double(), stride, dil)
    rel = _REL[dtype]
    assert (y.double() - ref).abs().max() <= rel * ref.abs().max()


def _dw_inputs(card, shape, k, stride, dtype):
    B, H, W, C = shape
    x = torch.randn(B, C, H, W, device="cuda", generator=card).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(C, 1, k, k, device="cuda", generator=card)
    Ho, Wo = -(-H // stride), -(-W // stride)
    g = torch.randn(B, C, Ho, Wo, device="cuda", generator=card).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return x, w, g


# Against the plain backward in float64 on the same (rounded) inputs and
# taps.  dx: float32 sums of <= k*k products, 1e-5 of its max; bfloat16
# adds the output's rounding, 2^-8 relative, so 1e-2 (float16: 2^-11, 1e-3).  dk: a float32 sum
# of up to B*H*W products in either dtype, 1e-4 of sum |x*g| per tap and
# channel.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                                       (torch.float16, 1e-3)])
@pytest.mark.parametrize("shape,k,stride,dil", DEPTHWISE_CASES)
def test_depthwise_backward_kernel_matches_plain(card, shape, k, stride, dil, dtype, rel):
    x, w, g = _dw_inputs(card, shape, k, stride, dtype)
    name = f"depthwise_bwd_s{stride}"
    before = kernels.launch_counts()[name]
    dx, dw = depthwise_conv_backward(x, w, g, stride, dil)
    assert kernels.launch_counts()[name] == before + 1
    wr = w.to(dtype).double()
    rdx, rdw = depthwise_conv_backward_plain(x.double(), wr, g.double(), stride, dil)
    assert dx.dtype == dtype and dx.is_contiguous(memory_format=torch.channels_last)
    assert dw.dtype == w.dtype and dw.shape == w.shape
    assert (dx.double() - rdx).abs().max() <= rel * rdx.abs().max()
    _, dw_abs = depthwise_conv_backward_plain(x.double().abs(), wr, g.double().abs(), stride, dil)
    assert ((dw.double() - rdw).abs() <= 1e-4 * dw_abs).all()
    # deterministic: no atomics, the same bits every run
    assert torch.equal(depthwise_conv_backward(x, w, g, stride, dil)[1], dw)


# Sites of the EfficientNet and NASNet backbones at 512² (B = 1): k = 5
# and 7 at both strides, C up to EfficientNet-B7's 1344, NASNet's odd 255²
# maps, and C = 11, 22 (not a multiple of 4) and 44, 88 (in 16 bits, not a
# multiple of 8), which take the narrow instantiation.
BACKBONE_SITES = [
    ((1, 64, 64, 144), 5, 2),
    ((1, 255, 255, 11), 7, 2),
    ((1, 255, 255, 32), 7, 2),
    ((1, 128, 128, 22), 7, 2),
    ((1, 32, 32, 1344), 5, 1),
    ((1, 32, 32, 88), 7, 1),
    ((1, 64, 64, 44), 5, 1),
    ((1, 128, 128, 11), 7, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,stride", BACKBONE_SITES)
def test_depthwise_kernels_match_plain_at_backbone_sites(card, shape, k, stride, dtype):
    """K2/K3 and K4/K5 at one site against the plain versions in float64 on
    the same (rounded) inputs and taps, by the bounds above."""
    x, w, g = _dw_inputs(card, shape, k, stride, dtype)
    rel = _REL[dtype]
    wr = w.to(dtype).double()
    counts = kernels.launch_counts()
    y = depthwise_conv(x, w, stride)
    dx, dw = depthwise_conv_backward(x, w, g, stride)
    after = kernels.launch_counts()
    assert after[f"depthwise_fwd_s{stride}"] == counts[f"depthwise_fwd_s{stride}"] + 1
    assert after[f"depthwise_bwd_s{stride}"] == counts[f"depthwise_bwd_s{stride}"] + 1
    ref = depthwise_conv_plain(x.double(), wr, stride)
    assert y.dtype == dtype and (y.double() - ref).abs().max() <= rel * ref.abs().max()
    rdx, rdw = depthwise_conv_backward_plain(x.double(), wr, g.double(), stride)
    assert dx.dtype == dtype and (dx.double() - rdx).abs().max() <= rel * rdx.abs().max()
    _, dw_abs = depthwise_conv_backward_plain(x.double().abs(), wr, g.double().abs(), stride)
    assert ((dw.double() - rdw).abs() <= 1e-4 * dw_abs).all()


# (B, H, W, C), k, stride, dilation, dtype, storage offset of x and g in
# elements, for the backward plan (kernels/depthwise.py _bwd_plan): the
# narrow instantiation (C = 12 bfloat16, C = 21 float32), x and g not
# 16-byte aligned, bfloat16 vectors at both strides and dilated, odd sizes
# at stride 2 (k = 5 odd and even: the last dx tile past the output tiles),
# k = 7, and a walk that crosses images.
BWD_EDGE_CASES = [
    ((2, 13, 17, 12), 3, 1, (1, 1), torch.bfloat16, 0),
    ((1, 19, 23, 21), 3, 2, (1, 1), torch.float32, 0),
    ((2, 19, 23, 40), 3, 1, (1, 1), torch.float32, 1),
    ((1, 18, 20, 40), 5, 2, (1, 1), torch.float32, 1),
    ((2, 21, 19, 64), 3, 2, (1, 1), torch.bfloat16, 0),
    ((2, 24, 24, 64), 3, 1, (1, 1), torch.bfloat16, 0),
    ((1, 16, 16, 64), 3, 1, (4, 2), torch.bfloat16, 0),
    ((1, 9, 11, 16), 5, 2, (1, 1), torch.float32, 0),
    ((1, 8, 16, 16), 5, 2, (1, 1), torch.float32, 0),
    ((1, 13, 15, 24), 7, 2, (1, 1), torch.bfloat16, 0),
    ((1, 12, 20, 40), 7, 1, (1, 1), torch.float32, 0),
    ((5, 8, 8, 32), 3, 1, (1, 1), torch.float32, 0),
    ((2, 13, 17, 12), 3, 1, (1, 1), torch.float16, 0),
    ((2, 21, 19, 64), 3, 2, (1, 1), torch.float16, 0),
    ((2, 24, 24, 64), 3, 1, (1, 1), torch.float16, 0),
    ((1, 16, 16, 64), 3, 1, (4, 2), torch.float16, 0),
    ((1, 13, 15, 24), 7, 2, (1, 1), torch.float16, 0),
    ((2, 19, 23, 48), 5, 1, (1, 1), torch.float16, 1),
]


def _offset_tensor(card, shape, dtype, offset):
    """(B, C, H, W) channels_last view of a buffer shifted by ``offset``
    elements."""
    B, H, W, C = shape
    base = torch.randn(B * H * W * C + offset, device="cuda", generator=card).to(dtype)
    return base[offset:].view(B, H, W, C).permute(0, 3, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,stride,dil,dtype,offset", BWD_EDGE_CASES)
def test_depthwise_backward_kernel_edges_match_plain(card, shape, k, stride, dil, dtype, offset):
    """dx and dk against the plain backward in float64 on the same (rounded)
    inputs and taps, with the bounds of the test above; dk bit-identical
    across runs; a dx-only and a dk-only call give the same bits as the
    full one, one launch each."""
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import _launch_backward

    B, H, W, C = shape
    x = _offset_tensor(card, shape, dtype, offset)
    Ho, Wo = -(-H // stride), -(-W // stride)
    g = _offset_tensor(card, (B, Ho, Wo, C), dtype, offset)
    assert (x.data_ptr() % 16 != 0) == (offset != 0)
    w = torch.randn(C, 1, k, k, device="cuda", generator=card)
    name = f"depthwise_bwd_s{stride}"
    before = kernels.launch_counts()[name]
    dx, dw = depthwise_conv_backward(x, w, g, stride, dil)
    assert kernels.launch_counts()[name] == before + 1
    wr = w.to(dtype).double()
    rdx, rdw = depthwise_conv_backward_plain(x.double(), wr, g.double(), stride, dil)
    rel = _REL[dtype]
    assert dx.dtype == dtype and dx.is_contiguous(memory_format=torch.channels_last)
    assert (dx.double() - rdx).abs().max() <= rel * rdx.abs().max()
    _, dw_abs = depthwise_conv_backward_plain(x.double().abs(), wr, g.double().abs(), stride, dil)
    assert ((dw.double() - rdw).abs() <= 1e-4 * dw_abs).all()
    dx_only, none = _launch_backward(x, w, g, stride, dil, True, False)
    none2, dk_only = _launch_backward(x, w, g, stride, dil, False, True)
    assert none is None and none2 is None
    assert kernels.launch_counts()[name] == before + 3
    assert torch.equal(dx_only, dx) and torch.equal(dk_only, dw)


@pytest.mark.cuda
@pytest.mark.parametrize("stride,dil", [(1, (6, 21)), (2, (1, 1))])
def test_autograd_runs_the_backward_kernel_once_per_backward(card, stride, dil):
    x, w, g = _dw_inputs(card, (2, 12, 10, 40), 3, stride, torch.float32)
    x.requires_grad_()
    w.requires_grad_()
    counts = kernels.launch_counts()
    depthwise_conv(x, w, stride, dil).backward(g)
    after = kernels.launch_counts()
    assert after[f"depthwise_fwd_s{stride}"] == counts[f"depthwise_fwd_s{stride}"] + 1
    assert after[f"depthwise_bwd_s{stride}"] == counts[f"depthwise_bwd_s{stride}"] + 1
    rdx, rdw = depthwise_conv_backward_plain(x.detach(), w.detach(), g, stride, dil)
    torch.testing.assert_close(x.grad, rdx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(w.grad, rdw, atol=1e-4, rtol=1e-4)
    # a frozen weight: dx only, still one launch
    w2 = w.detach()
    x.grad = None
    depthwise_conv(x, w2, stride, dil).backward(g)
    assert kernels.launch_counts()[f"depthwise_bwd_s{stride}"] == after[f"depthwise_bwd_s{stride}"] + 1
    torch.testing.assert_close(x.grad, rdx, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_depthwise_kernel_refuses_what_it_does_not_take(card):
    w = torch.randn(8, 1, 3, 3, device="cuda")
    with pytest.raises(TypeError):
        depthwise_conv(torch.randn(1, 8, 6, 6, device="cuda", dtype=torch.float64)
                       .contiguous(memory_format=torch.channels_last), w.double())
    with pytest.raises(ValueError, match="channels_last"):
        depthwise_conv(torch.randn(1, 8, 6, 6, device="cuda"), w)


# (B, C, H, W) NCHW for the channels-first kernels K6/K7: an odd plane
# (edge tiles of 32 x 32 cut on both axes) and an even one.
CF_CASES = [(2, 64, 37, 45), (2, 32, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                                       (torch.float16, 1e-3)])
@pytest.mark.parametrize("shape", CF_CASES)
def test_cf_kernels_match_plain(card, shape, dtype, rel):
    """K6 and K7 against the plain forward and backward in float64 on the
    same (rounded) inputs, with the tolerances of the NHWC kernels above."""
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    g = torch.randn(shape, device="cuda", generator=card).to(dtype)
    w = torch.randn(shape[1], 1, 3, 3, device="cuda", generator=card)
    wr = w.to(dtype).double()
    counts = kernels.launch_counts()
    y = depthwise_cf(x, w)
    dx, dw = depthwise_cf_backward(x, w, g)
    after = kernels.launch_counts()
    assert after["depthwise_fwd_cf"] == counts["depthwise_fwd_cf"] + 1
    assert after["depthwise_bwd_cf"] == counts["depthwise_bwd_cf"] + 1
    assert y.is_contiguous() and dx.is_contiguous() and y.dtype == dx.dtype == dtype
    ref = depthwise_conv_plain(x.double(), wr)
    assert (y.double() - ref).abs().max() <= rel * ref.abs().max()
    rdx, rdw = depthwise_conv_backward_plain(x.double(), wr, g.double())
    assert (dx.double() - rdx).abs().max() <= rel * rdx.abs().max()
    _, dw_abs = depthwise_conv_backward_plain(x.double().abs(), wr, g.double().abs())
    assert dw.dtype == w.dtype and ((dw.double() - rdw).abs() <= 1e-4 * dw_abs).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CF_CASES)
def test_cf_dk_is_bit_reproducible(card, shape):
    x = torch.randn(shape, device="cuda", generator=card)
    g = torch.randn(shape, device="cuda", generator=card)
    w = torch.randn(shape[1], 1, 3, 3, device="cuda", generator=card)
    runs = [depthwise_cf_backward(x, w, g) for _ in range(3)]
    assert all(torch.equal(r[1], runs[0][1]) and torch.equal(r[0], runs[0][0]) for r in runs)
    dx_only, none = depthwise_cf_backward(x, w, g, want_dk=False)
    none2, dk_only = depthwise_cf_backward(x, w, g, want_dx=False)
    assert none is None and none2 is None
    assert torch.equal(dx_only, runs[0][0]) and torch.equal(dk_only, runs[0][1])


@pytest.mark.cuda
def test_bhcw_layout_routes_autograd_through_k6_k7(card, monkeypatch):
    monkeypatch.setenv("DLV3_DW_LAYOUT", "bhcw")
    x, w, g = _dw_inputs(card, (2, 21, 19, 40), 3, 1, torch.float32)
    x.requires_grad_()
    w.requires_grad_()
    counts = kernels.launch_counts()
    y = depthwise_conv(x, w)
    y.backward(g)
    after = kernels.launch_counts()
    assert {k: after[k] - counts[k] for k in after if after[k] != counts[k]} == {
        "depthwise_fwd_cf": 1, "depthwise_bwd_cf": 1}
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert x.grad.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, depthwise_conv_plain(x.detach(), w.detach()), atol=1e-5, rtol=1e-5)
    rdx, rdw = depthwise_conv_backward_plain(x.detach(), w.detach(), g)
    torch.testing.assert_close(x.grad, rdx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(w.grad, rdw, atol=1e-4, rtol=1e-4)
    # a dilated site keeps the NHWC kernel under bhcw
    before = kernels.launch_counts()["depthwise_fwd_s1"]
    depthwise_conv(x.detach(), w.detach(), 1, (2, 2))
    assert kernels.launch_counts()["depthwise_fwd_s1"] == before + 1


# (B, C, H, W), dtype, storage offset in elements, plan mode, for K7's
# plan (kernels/depthwise.py _cf_bwd_plan): whole 32² planes that a block
# walks through the batch, batch groups (a partial buffer and the final
# pass), the flat copies of odd W (rows of 508 and 1012 float32 bytes,
# 16-row tiles walked; odd H and W), bfloat16 by both copies, pointer
# offsets that break 16-byte alignment (x and g then start and end inside
# a 16-byte chunk and are the last elements of their buffers, so the flat
# copy's first and last chunks cross the tensor's ends), and blocks of
# fewer threads than dk's 9 taps.
CF_BWD_CASES = [
    ((16, 1024, 32, 32), torch.float32, 0, "vec"),
    ((16, 728, 32, 32), torch.float32, 0, "vec"),
    ((4, 96, 127, 127), torch.float32, 0, "flat"),
    ((2, 64, 253, 253), torch.float32, 0, "flat"),
    ((2, 600, 61, 99), torch.float32, 0, "flat"),
    ((4, 256, 64, 64), torch.bfloat16, 0, "vec"),
    ((4, 128, 127, 127), torch.bfloat16, 0, "flat"),
    ((8, 300, 32, 32), torch.float32, 1, "flat"),
    ((2, 48, 37, 45), torch.bfloat16, 1, "flat"),
    ((2, 64, 31, 31), torch.float32, 3, "flat"),
    ((2, 600, 8, 8), torch.float32, 0, "vec"),
    ((4, 256, 64, 64), torch.float16, 0, "vec"),
    ((4, 128, 127, 127), torch.float16, 0, "flat"),
    ((2, 48, 37, 45), torch.float16, 1, "flat"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset,mode", CF_BWD_CASES)
def test_cf_backward_plan_variants_match_plain(card, shape, dtype, offset, mode):
    """K7 by each variant of its plan against the plain backward in float64
    on the same (rounded) inputs and taps (dx 1e-5 of its max in float32,
    1e-2 in bfloat16; dk 1e-4 of Σ|x·g|); dk and dx the same bits in a
    second run, and from a dx-only and a dk-only call."""
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import _cf_bwd_plan, _ptr_align

    n = math.prod(shape)
    x = torch.randn(n + offset, device="cuda", generator=card).to(dtype)[offset:].view(shape)
    g = torch.randn(n + offset, device="cuda", generator=card).to(dtype)[offset:].view(shape)
    w = torch.randn(shape[1], 1, 3, 3, device="cuda", generator=card)
    assert (x.data_ptr() % 16 != 0) == (offset != 0)
    assert offset == 0 or (x.data_ptr() + x.nbytes) % 16 != 0
    assert _cf_bwd_plan(*shape, dtype, _ptr_align(x, g)).mode == mode
    before = kernels.launch_counts()["depthwise_bwd_cf"]
    dx, dw = depthwise_cf_backward(x, w, g)
    assert kernels.launch_counts()["depthwise_bwd_cf"] == before + 1
    wr = w.to(dtype).double()
    rdx, rdw = depthwise_conv_backward_plain(x.double(), wr, g.double())
    rel = _REL[dtype]
    assert dx.dtype == dtype and dx.is_contiguous()
    assert (dx.double() - rdx).abs().max() <= rel * rdx.abs().max()
    _, dw_abs = depthwise_conv_backward_plain(x.double().abs(), wr, g.double().abs())
    assert dw.dtype == w.dtype and ((dw.double() - rdw).abs() <= 1e-4 * dw_abs).all()
    dx2, dw2 = depthwise_cf_backward(x, w, g)
    assert torch.equal(dx2, dx) and torch.equal(dw2, dw)
    dx_only, none = depthwise_cf_backward(x, w, g, want_dk=False)
    none2, dk_only = depthwise_cf_backward(x, w, g, want_dx=False)
    assert none is None and none2 is None
    assert torch.equal(dx_only, dx) and torch.equal(dk_only, dw)


# (B, C, H, W), dtype, storage offset in elements, plan mode, for K6's plan
# (kernels/depthwise.py _cf_fwd_plan): whole 32² planes four a tile (the
# last tile two), a 64² plane a tile, an odd H in vec mode (one tile of 34
# rows, 33 in the plane), a plane cut into three tiles of rows, W = 253 and
# 127 (flat, odd H too), misaligned views (a storage offset of one element:
# x's first and last chunks cross the tensor's ends), tiny planes many a
# tile, and a plane of one pixel; float32, bfloat16 and float16.
CF_FWD_CASES = [
    ((3, 50, 32, 32), torch.float32, 0, "vec"),
    ((2, 24, 64, 64), torch.bfloat16, 0, "vec"),
    ((2, 24, 64, 64), torch.float32, 0, "vec"),
    ((2, 5, 33, 32), torch.float16, 0, "vec"),
    ((2, 3, 300, 32), torch.float32, 0, "vec"),
    ((2, 16, 253, 253), torch.float32, 0, "flat"),
    ((3, 8, 127, 127), torch.bfloat16, 0, "flat"),
    ((2, 8, 127, 127), torch.float16, 0, "flat"),
    ((3, 24, 32, 32), torch.float32, 1, "flat"),
    ((2, 10, 37, 45), torch.bfloat16, 1, "flat"),
    ((2, 6, 31, 31), torch.float16, 1, "flat"),
    ((2, 600, 8, 8), torch.float32, 0, "vec"),
    ((1, 3, 1, 1), torch.float32, 0, "flat"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset,mode", CF_FWD_CASES)
def test_cf_forward_plan_variants_match_plain(card, shape, dtype, offset, mode):
    """K6 by each mode of its plan against the plain forward in float64 on
    the same (rounded) inputs and taps (1e-5 of the largest output in
    float32, 1e-2 in bfloat16, 1e-3 in float16); one launch a call; y the
    same bits in three runs and by plans of half and twice the rows a
    thread, each walking 1 and 4 tiles (the same float32 operations in the
    same order)."""
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import (
        _cf_fwd_flat,
        _cf_fwd_launch,
        _cf_fwd_plan,
        _cf_fwd_taps,
        _cf_fwd_vec,
        _ptr_align,
    )

    n = math.prod(shape)
    x = torch.randn(n + offset, device="cuda", generator=card).to(dtype)[offset:].view(shape)
    w = torch.randn(shape[1], 1, 3, 3, device="cuda", generator=card)
    assert (x.data_ptr() % 16 != 0) == (offset != 0)
    plan = _cf_fwd_plan(*shape, dtype, _ptr_align(x))
    assert plan.mode == mode
    before = kernels.launch_counts()["depthwise_fwd_cf"]
    ys = [depthwise_cf(x, w) for _ in range(3)]
    assert kernels.launch_counts()["depthwise_fwd_cf"] == before + 3
    y = ys[0]
    assert y.dtype == dtype and y.is_contiguous()
    ref = depthwise_conv_plain(x.double(), w.to(dtype).double())
    assert (y.double() - ref).abs().max() <= _REL[dtype] * ref.abs().max()
    assert all(torch.equal(other, y) for other in ys[1:])
    taps = _cf_fwd_taps(w)
    for r in (max(1, plan.r // 2), plan.r * 2):
        other = (_cf_fwd_flat(*shape, dtype.itemsize, r) if mode == "flat"
                 else _cf_fwd_vec(*shape, dtype.itemsize, r))
        for walk in (1, 4):
            ya = torch.full_like(y, float("nan"))
            _cf_fwd_launch(x, taps, ya, dataclasses.replace(other, walk=walk))
            assert torch.equal(ya, y), (r, walk)


@pytest.mark.cuda
def test_cf_forward_raises_where_the_kernel_refuses_the_plan(card):
    """A vec plan on a misaligned x: the kernel refuses it and the wrapper
    raises, with nothing computed in the plain version instead."""
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import _cf_fwd_launch, _cf_fwd_taps, _cf_fwd_vec

    x = torch.randn(4 * 32 * 32 + 1, device="cuda", generator=card)[1:].view(1, 4, 32, 32)
    w = torch.randn(4, 1, 3, 3, device="cuda", generator=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cf_fwd_launch(x, _cf_fwd_taps(w), torch.empty_like(x), _cf_fwd_vec(1, 4, 32, 32, 4, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [2, 16])
def test_upsample_argmax_kernel_matches_plain(card, scale):
    logits = torch.randn(2, 32, 32, 21, device="cuda", generator=card)
    before = kernels.launch_counts()["upsample_argmax"]
    lab, ref = upsample_argmax(logits, scale), upsample_argmax_plain(logits, scale)
    assert kernels.launch_counts()["upsample_argmax"] == before + 1
    assert lab.dtype == torch.int32 and lab.shape == ref.shape
    # only float-rounding ties between two classes may differ
    assert (lab != ref).float().mean().item() <= 1e-5
    assert (upsample_argmax(torch.zeros(1, 4, 4, 7, device="cuda"), 2) == 0).all()


# (B, h, w, C), scale: K1's plan (kernels/upsample_argmax.py
# _upsample_argmax_plan) at s 1, 2, 4, 16 and past 64, odd maps (the last
# band and column tile cut, rows whose labels a vector store does not
# take), C of 1, 21 and 150 (a narrower band and tile).
K1_CASES = [
    ((2, 9, 13, 21), 1), ((2, 33, 67, 21), 2), ((1, 7, 9, 150), 2), ((1, 5, 11, 1), 2),
    ((2, 11, 5, 21), 4), ((1, 3, 5, 150), 16), ((1, 6, 7, 1), 16), ((16, 16, 16, 21), 2),
    ((1, 3, 2, 21), 65), ((1, 2, 3, 5), 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,scale", K1_CASES)
def test_upsample_argmax_plan_matches_its_emulation(card, shape, scale):
    """The kernel's labels equal, bit for bit, the CPU emulation of its
    blocks (the same float32 operations in the same order), and the plain
    version's except at float-rounding near-ties."""
    from deeplabv3plus_keras_tpu_torch.kernels.upsample_argmax import (
        _upsample_argmax_plan,
        upsample_argmax_band_emulation,
    )

    logits = torch.randn(shape, device="cuda", generator=card)
    lab = upsample_argmax(logits, scale)
    plan = _upsample_argmax_plan(*shape, scale)
    emu = upsample_argmax_band_emulation(logits.cpu(), scale, plan)
    assert torch.equal(lab.cpu(), emu)
    assert (lab != upsample_argmax_plain(logits, scale)).float().mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_upsample_argmax_ties_keep_the_first_class(card, scale):
    logits = torch.randn(2, 9, 11, 21, device="cuda", generator=card)
    top = logits.amax(-1) + 1.0
    logits[..., 4] = top
    logits[..., 9] = top
    logits[..., 20] = top
    assert (upsample_argmax(logits, scale) == 4).all()


# The backbones' pools (models/blocks.py) at NASNet's cell sizes.  On CUDA,
# torch's avg_pool2d backward of a channels_last input with padding > 0 is
# wrong; avg_pool_same_s1 pads explicitly and pools without padding.
POOLS = {
    "avg_pool_same_s1": lambda x: blocks.avg_pool_same_s1(x),
    "pool_s2_keras_avg": lambda x: blocks.pool_s2_keras(x, 3, "avg"),
    "pool_s2_keras_max": lambda x: blocks.pool_s2_keras(x, 3, "max"),
    "max_pool_same": lambda x: blocks.max_pool_same(x, 3, 2),
    "avg_pool_valid": lambda x: blocks.avg_pool_valid(x, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 88, 8, 8), (2, 11, 32, 32), (2, 22, 17, 15)])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_pools_match_float64_in_channels_last(card, pool, shape):
    """Each pool and its gradient on a channels_last float32 input on the
    card within 1e-5 (of the largest value) of float64 on the CPU."""
    fn = POOLS[pool]
    x64 = torch.randn(shape, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    x = x64.clone().requires_grad_()
    y64 = fn(x)
    g64 = torch.randn(y64.shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    y64.backward(g64)
    xc = x64.float().cuda().contiguous(memory_format=torch.channels_last).requires_grad_()
    y = fn(xc)
    y.backward(g64.float().cuda().contiguous(memory_format=torch.channels_last))
    assert (y.detach().double().cpu() - y64.detach()).abs().max() <= 1e-5 * y64.abs().max()
    assert (xc.grad.double().cpu() - x.grad).abs().max() <= 1e-5 * x.grad.abs().max()


@pytest.mark.cuda
def test_data_path_on_card_matches_cpu(card):
    """prepare_batch and apply_augment (plain PyTorch, no kernel) on the
    card against the CPU: images within 1e-5, labels through float and
    rounding equal on ≥ 99.99 % of pixels (FMA contraction on the card can
    move a blend across .5)."""
    from deeplabv3plus_keras_tpu_torch.ops.augment import apply_augment, sample_params
    from deeplabv3plus_keras_tpu_torch.ops.preprocess import prepare_batch

    g = torch.Generator().manual_seed(0)
    sizes = torch.tensor([[300, 500], [500, 301], [377, 377], [512, 129]], dtype=torch.int32)
    img = torch.randint(0, 256, (4, 512, 512, 3), generator=g, dtype=torch.uint8)
    lab = torch.randint(0, 30, (4, 512, 512), generator=g, dtype=torch.uint8)
    for one_hot in (False, True):
        ci, cl = prepare_batch(img, sizes, lab, size=512, one_hot_labels=one_hot)
        gi, gl = prepare_batch(img.cuda(), sizes.cuda(), lab.cuda(), size=512,
                               one_hot_labels=one_hot)
        assert (gi.cpu() - ci).abs().max().item() <= 1e-5
        agree = (gl.cpu().argmax(-1) == cl.argmax(-1)) if one_hot else (gl.cpu() == cl)
        assert agree.float().mean().item() >= 0.9999
    params = sample_params(g, 4, True, (0.5, 2.0))
    gi, gl = apply_augment(ci.cuda(), cl.cuda(), {k: v.cuda() for k, v in params.items()})
    ai, al = apply_augment(ci, cl, params)
    assert (gi.cpu() - ai).abs().max().item() <= 1e-5
    assert (gl.cpu().argmax(-1) == al.argmax(-1)).float().mean().item() >= 0.9999


@pytest.mark.cuda
def test_two_ranks_launch_the_kernels_of_one_process(card, tmp_path):
    """One flagship-shaped step (the five-branch ASPP, 128², 4 rows a rank
    of a global batch of 8) on two ranks: NCCL with a card each where two
    cards exist, else gloo with both ranks on the one card.  Each rank
    launches K2–K5 as often as one process taking the whole batch, and
    both ranks report the same global loss, within 1e-5 of one process's
    (dropout 0: element-wise dropout draws from each rank's own stream)."""
    import json

    import numpy as np

    import torch_ddp_workers as workers
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.parallel import launch
    from torch_helpers import FLAGSHIP_MIDDLE, conf_dict

    two_cards = torch.cuda.device_count() >= 2
    launch.spawn(workers.on_card_worker, 2, (str(tmp_path),),
                 devices=["cuda:0", "cuda:1"] if two_cards else ["cuda:0", "cuda:0"],
                 backend="nccl" if two_cards else "gloo", timeout_s=300, group_timeout_s=120)
    ranks = [json.loads((tmp_path / f"card_r{r}.json").read_text()) for r in (0, 1)]

    conf = conf_dict(128)
    conf["hps"]["batch_size"] = 8
    conf["nn_arch"].update(encoder_middle_conf=FLAGSHIP_MIDDLE, dropout_rate=0.0)
    seg = SemanticSegmentation(conf, device="cuda")
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    loss = float(seg.train_step({"image": rng.uniform(-1, 1, (8, 128, 128, 3)).astype(np.float32),
                                 "label": rng.integers(0, 21, (8, 128, 128))})["loss"])
    one = kernels.launch_counts()
    names = ("depthwise_fwd_s1", "depthwise_fwd_s2", "depthwise_bwd_s1", "depthwise_bwd_s2")
    assert [one[k] for k in names] == [15, 3, 15, 3]
    for r in ranks:
        assert [r["launches"][k] for k in names] == [one[k] for k in names], r
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert abs(ranks[0]["loss"] - loss) <= 1e-5 * loss


# Row-window sites (mesh_space): (C, H, k, stride, dilation) of the
# flagship at 512² (its stride-2 sites at even heights, the dilated ASPP
# at the 32² map) and 3×3 sites at Xception's odd heights at 512² (253, 127)
# and 1024² (509, 255) and its 128² map, also at stride 2
WINDOW_SITES = [
    (32, 256, 3, 1, (1, 1)), (96, 256, 3, 2, (1, 1)), (144, 128, 3, 2, (1, 1)),
    (384, 32, 3, 1, (1, 1)), (96, 32, 3, 1, (18, 15)), (256, 32, 3, 1, (6, 21)),
    (64, 253, 3, 1, (1, 1)), (128, 253, 3, 2, (1, 1)), (256, 127, 3, 1, (1, 1)),
    (256, 127, 3, 2, (1, 1)), (64, 509, 3, 1, (1, 1)), (128, 255, 3, 2, (1, 1)),
    (728, 128, 3, 1, (1, 1)), (32, 57, 5, 2, (1, 1)), (32, 57, 7, 1, (1, 1)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("site", WINDOW_SITES, ids=lambda s: "C{}H{}k{}s{}d{}".format(*s[:4], s[4][0]))
def test_depthwise_row_windows_match_plain(card, site, dtype, rel):
    """K2–K5 on row windows (``window=(Ho, pad_t)``): for each shard of 2
    and of 4 (``mesh.rows_of`` of the output rows, uneven where they do not
    divide), the window's rows given to the kernels against the plain
    versions on the same window in float64 (forward and dx to ``rel`` of
    their largest value; dk, a float32 sum in either dtype, to 1e-4 of
    Σ|x·g|)."""
    from deeplabv3plus_keras_tpu_torch.kernels import same_pads
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    C, H, k, stride, dil = site
    x = torch.randn(2, C, H, H, device="cuda", generator=card).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(C, 1, k, k, device="cuda", generator=card).to(dtype).float()
    Ho, pt, _ = same_pads(H, k, stride, dil[0])
    for S in (2, 4):
        for q in range(S):
            o0, o1 = mesh.rows_of(Ho, S, q)
            if o0 == o1:
                continue
            lo, hi = o0 * stride - pt, (o1 - 1) * stride - pt + dil[0] * (k - 1) + 1
            c0, c1 = max(lo, 0), min(hi, H)
            win = (o1 - o0, c0 - lo)
            xw = x[:, :, c0:c1].contiguous(memory_format=torch.channels_last)
            g = torch.randn((2, C, o1 - o0, -(-H // stride)), device="cuda", generator=card).to(
                dtype).contiguous(memory_format=torch.channels_last)
            y = depthwise_conv(xw, w, stride, dil, window=win)
            dx, dk = depthwise_conv_backward(xw, w, g, stride, dil, window=win)
            ref = depthwise_conv_plain(xw.double(), w.double(), stride, dil, window=win)
            rdx, rdk = depthwise_conv_backward_plain(xw.double(), w.double(), g.double(), stride,
                                                     dil, window=win)
            _, dk_abs = depthwise_conv_backward_plain(xw.double().abs(), w.double(),
                                                      g.double().abs(), stride, dil, window=win)
            assert y.dtype == dtype and y.shape == ref.shape, (site, S, q)
            assert (y.double() - ref).abs().max() <= rel * ref.abs().max(), (site, S, q)
            assert (dx.double() - rdx).abs().max() <= rel * rdx.abs().max(), (site, S, q)
            assert ((dk.double() - rdk).abs() <= 1e-4 * dk_abs).all(), (site, S, q)


@pytest.mark.cuda
def test_two_ranks_split_in_space_launch_every_kernel(card, tmp_path):
    """One flagship-shaped step (the five-branch ASPP, 128², B = 2) with
    ``mesh_space`` 2: NCCL with a card each where two cards exist, else
    gloo with both ranks on the one card.  Each rank launches K2–K5 at
    every site (its row window) as often as one process, both report the
    same loss, within 1e-5 of one process's, and ``segment()`` returns the
    same whole labels on both ranks, equal to one process's except at
    float32 ties (at most 1 in 10⁴ pixels)."""
    import json

    import numpy as np

    import torch_spatial_workers as workers
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.parallel import launch
    from torch_helpers import FLAGSHIP_MIDDLE, conf_dict

    two_cards = torch.cuda.device_count() >= 2
    launch.spawn(workers.on_card_spatial_worker, 2, (str(tmp_path),),
                 devices=["cuda:0", "cuda:1"] if two_cards else ["cuda:0", "cuda:0"],
                 backend="nccl" if two_cards else "gloo", timeout_s=300, group_timeout_s=120)
    ranks = [json.loads((tmp_path / f"spatial_card_r{r}.json").read_text()) for r in (0, 1)]

    conf = conf_dict(128)
    conf["nn_arch"].update(encoder_middle_conf=FLAGSHIP_MIDDLE, dropout_rate=0.0)
    seg = SemanticSegmentation(conf, device="cuda")
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32),
             "label": rng.integers(0, 21, (2, 128, 128))}
    kernels.reset_launch_counts()
    loss = float(seg.train_step(batch)["loss"])
    one = kernels.launch_counts()
    labels = seg.segment(batch["image"])
    names = ("depthwise_fwd_s1", "depthwise_fwd_s2", "depthwise_bwd_s1", "depthwise_bwd_s2")
    assert [one[k] for k in names] == [15, 3, 15, 3]
    for r in ranks:
        assert [r["launches"][k] for k in names] == [one[k] for k in names], r
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert abs(ranks[0]["loss"] - loss) <= 1e-5 * loss
    assert ranks[0]["labels"] == ranks[1]["labels"]
    assert (np.asarray(ranks[0]["labels"]) != labels).mean() <= 1e-4


# int8 products (M, K, N) of the zoo's quantized sites: the flagship's ASPP
# at 16×512² (32² maps: 320 → 256, the 1280 → 256 projection), Xception's
# middle flow (728) and exit flow (1024 → 1536 → 2048 at 32²), EfficientNet's
# expand/project widths at 32², and row counts at and below _int_mm's 17
INT8_PRODUCT_CASES = [
    (16 * 32 * 32, 320, 256), (16 * 32 * 32, 1280, 256), (16 * 32 * 32, 728, 728),
    (16 * 32 * 32, 1024, 1536), (16 * 32 * 32, 1536, 2048), (16 * 32 * 32, 672, 192),
    (17, 128, 128), (16, 256, 128), (1, 728, 728),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", INT8_PRODUCT_CASES)
def test_int8_product_matches_plain(card, m, k, n):
    """``torch._int_mm`` (rows padded past 16) against the exact int64
    product on the CPU: equal, every term a product of two int8s."""
    from deeplabv3plus_keras_tpu_torch.ops import quant

    a = torch.randint(-127, 128, (m, k), generator=card, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=card, device="cuda", dtype=torch.int8)
    got = quant.int8_product(a, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), quant.int8_product(a.cpu(), w.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,shape", [(1, 1, (4, 728, 32, 32)), (1, 2, (2, 256, 63, 63)),
                                            (3, 1, (2, 128, 9, 10)), (3, 2, (1, 128, 16, 16))])
def test_int8_conv_matches_plain(card, k, stride, shape):
    """The whole int8 conv (quantize, im2col, product, dequantize) on the
    card against the CPU's plain version: the quantized values and the
    integer product are exact, the dequantization the same float32
    operations."""
    from deeplabv3plus_keras_tpu_torch.ops import quant

    x = torch.randn(shape, generator=card, device="cuda").contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(256, shape[1], k, k, generator=card, device="cuda") * 0.05
    amax = x.abs().amax() * 0.9
    got = quant.int8_conv(x, w, amax, strides=stride)
    ref = quant.int8_conv(x.cpu(), w.cpu(), amax.cpu(), strides=stride)
    assert got.shape == ref.shape
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)


@pytest.mark.cuda
def test_int8_site_that_int_mm_cannot_take_raises(card):
    """An eligible site whose K or N is no multiple of 8 raises naming the
    site: the card never falls back to float where JAX computes int8."""
    from deeplabv3plus_keras_tpu_torch.ops import quant

    conv = blocks.QuantConv(132, 256, 1).cuda()
    x = torch.randn(2, 132, 8, 8, device="cuda")
    with torch.no_grad(), quant.quantized(conv, {"": torch.tensor(1.0, device="cuda")}):
        with pytest.raises(ValueError, match=r"int8 site : K=132"):
            conv(x)


# T1/T2 (csrc/parity_tail.cu): (B, H, W, C) of the flagship's tail at a
# small map (the C ≤ 24 instantiation), a ragged one with C even (C ≤ 8),
# the C ≤ 16 and C ≤ 32 instantiations at their bounds, and the multi-pass
# kernels past them: C = 33, and C = 150, which takes smaller tiles and
# counts the matrix in device memory
PARITY_TAIL_CASES = [(2, 16, 32, 21), (3, 7, 9, 8), (2, 9, 11, 16), (2, 8, 12, 32), (2, 5, 6, 33),
                     (2, 10, 12, 150)]


def _parity_tail_inputs(shape, dtype, dense, seed=0):
    from deeplabv3plus_keras_tpu_torch.train.loss import SS_NW, SS_PW

    B, H, W, C = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, device="cuda", generator=g) * 2).to(dtype)
    ids = torch.randint(0, C, (B, 2 * H, 2 * W), device="cuda", generator=g)
    lab = torch.nn.functional.one_hot(ids, C).to(dtype) if dense else ids
    pw = SS_PW[:C] if C <= 21 else torch.linspace(0.3, 0.99, C).numpy()
    nw = 1.0 - pw
    valid = torch.ones(B, dtype=torch.int32, device="cuda")
    valid[-1] = 0
    scale = torch.rand(B, device="cuda", generator=g) * valid
    return x, lab, pw, nw, valid, scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PARITY_TAIL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dense", [True, False])
def test_parity_tail_kernels_match_plain(card, shape, dtype, dense):
    """T1 and T2 against the plain version on the float32 values of the
    same logits (the kernels compute in float32): the per-sample sums to
    1e-5 relative (sums over pixels and classes in another order), the
    confusion matrix exactly (the parity values are the plain version's
    lerps, rounded alike), dlogits to 1e-5 of their largest in float32 and
    to 2⁻⁷ of it in bfloat16/float16 (their rounding of the result); one
    launch each."""
    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt

    x, lab, pw, nw, valid, scale = _parity_tail_inputs(shape, dtype, dense)
    before = dict(kernels.launch_counts())
    sums, cm = pt.parity_tail_forward(x, lab, pw, nw, valid)
    dx = pt.parity_tail_backward(x, lab, pw, nw, scale)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["parity_tail_fwd"] == before["parity_tail_fwd"] + 1
    assert after["parity_tail_bwd"] == before["parity_tail_bwd"] + 1
    ref_sums, ref_cm = pt.parity_tail_forward_plain(x.float(), lab.float() if dense else lab, pw, nw, valid)
    ref_dx = pt.parity_tail_backward_plain(x.float(), lab.float() if dense else lab, pw, nw, scale)
    assert sums.dtype == torch.float32 and dx.dtype == dtype and dx.shape == x.shape
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=0)
    assert torch.equal(cm, ref_cm)
    assert int(cm.sum()) == (shape[0] - 1) * 4 * shape[1] * shape[2]
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    top = float(ref_dx.abs().max())
    assert float((dx.float() - ref_dx).abs().max()) <= tol * top
    assert not dx[-1].any()  # the padded sample's scale is 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 32, 21), (3, 7, 9, 8), (2, 3, 6, 33)])
@pytest.mark.parametrize("dense", [True, False])
def test_parity_tail_row_window_matches_plain(card, shape, dense):
    """T1 and T2 on a row window (``window=True``: the logits' first and
    last rows context only; ``mesh_space``): for the sites of each of 2
    and 3 ranks of the map, with a context row each side clamped at the
    image's edges, against the windowed plain version (the bounds of
    ``test_parity_tail_kernels_match_plain`` in float32), one launch each;
    the ranks' sums and matrices add up to T1's on the whole map."""
    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    x, lab, pw, nw, valid, scale = _parity_tail_inputs(shape, torch.float32, dense)
    B, H = shape[:2]
    whole_sums, whole_cm = pt.parity_tail_forward(x, lab, pw, nw, valid)
    for S in (2, 3):
        total, total_cm = 0, 0
        for q in range(S):
            a, b = mesh.rows_of(H, S, q)
            if a == b:
                continue
            rows = torch.arange(a - 1, b + 1, device="cuda").clamp(0, H - 1)
            blk, lb = x[:, rows].contiguous(), lab[:, 2 * a:2 * b].contiguous()
            before = dict(kernels.launch_counts())
            sums, cm = pt.parity_tail_forward(blk, lb, pw, nw, valid, window=True)
            dx = pt.parity_tail_backward(blk, lb, pw, nw, scale, window=True)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            assert after["parity_tail_fwd"] == before["parity_tail_fwd"] + 1
            assert after["parity_tail_bwd"] == before["parity_tail_bwd"] + 1
            ref_sums, ref_cm = pt.parity_tail_forward_plain(blk, lb, pw, nw, valid, window=True)
            ref_dx = pt.parity_tail_backward_plain(blk, lb, pw, nw, scale, window=True)
            torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=0)
            assert torch.equal(cm, ref_cm)
            assert float((dx - ref_dx).abs().max()) <= 1e-5 * float(ref_dx.abs().max())
            total, total_cm = total + sums, total_cm + cm
        torch.testing.assert_close(total, whole_sums, rtol=1e-5, atol=0)
        assert torch.equal(total_cm, whole_cm)


@pytest.mark.cuda
def test_parity_tail_kernels_are_bit_reproducible(card):
    """Two runs of T1 and T2 on the same inputs give the same bits:
    fixed-order float sums, integer atomics for the matrix."""
    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt

    x, lab, pw, nw, valid, scale = _parity_tail_inputs((4, 64, 64, 21), torch.float32, True)
    runs = [(*pt.parity_tail_forward(x, lab, pw, nw, valid), pt.parity_tail_backward(x, lab, pw, nw, scale))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_parity_tail_autograd_launches_t1_and_t2(card):
    """``ops/parity_tail.tail_loss_cm`` on a CUDA tensor: T1 in the forward,
    T2 in the backward, one launch each, and the loss and the gradient of
    the plain version on the same values (within the kernel test's
    bounds)."""
    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt
    from deeplabv3plus_keras_tpu_torch.ops import parity_tail

    x, lab, pw, nw, valid, _ = _parity_tail_inputs((2, 16, 16, 21), torch.float32, False)
    xr = x.clone().requires_grad_()
    kernels.reset_launch_counts()
    loss, cm = parity_tail.tail_loss_cm(xr, lab, pw, nw, 21, valid)
    loss.backward()
    counts = kernels.launch_counts()
    assert (counts["parity_tail_fwd"], counts["parity_tail_bwd"]) == (1, 1)
    xc = x.cpu().requires_grad_()
    ref, ref_cm = parity_tail.tail_loss_cm(xc, lab.cpu(), pw, nw, 21, valid.cpu())
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert torch.equal(cm.cpu(), ref_cm)
    assert float((xr.grad.cpu() - xc.grad).abs().max()) <= 1e-5 * float(xc.grad.abs().max())
    assert isinstance(pt.launches["parity_tail_fwd"], int)


def default_and_full_resolution_steps(accum: int, seed: int = 0, size: int = 128) -> dict:
    """One flagship-shaped train step (the five-branch ASPP, boundary
    refinement, B = 2·accum, one-hot labels, a padded sample, dropout 0,
    cuDNN deterministic) on the card, from the same weights and batch, once
    with the key ``fused_tail`` absent and once with ``fused_tail: false``:
    the T1/T2 launches of each, the loss gap over the full-resolution
    step's loss, the confusion matrices' L1 distance in pixels, and the
    gradients' distance over the full-resolution step's norm (2-norms over
    every parameter)."""
    import numpy as np

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from torch_helpers import FLAGSHIP_MIDDLE, conf_dict

    conf = conf_dict(size)
    conf["hps"]["batch_size"] = 2 * accum
    conf["nn_arch"].update(encoder_middle_conf=FLAGSHIP_MIDDLE, dropout_rate=0.0)
    if accum > 1:
        conf["grad_accum"] = accum
    rng = np.random.default_rng(seed)
    B = 2 * accum
    batch = {"image": rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32),
             "label": np.eye(21, dtype=np.float32)[rng.integers(0, 21, (B, size, size))],
             "valid": np.asarray([1] * (B - 1) + [0], np.int32)}
    state, out = None, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (("default", {}), ("full", {"fused_tail": False})):
            seg = SemanticSegmentation({**conf, **extra}, device="cuda")
            if state is None:
                state = {k: v.clone() for k, v in seg.model.state_dict().items()}
            seg.model.load_state_dict(state)
            kernels.reset_launch_counts()
            res = seg.train_step(batch)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            out[name] = (float(res["loss"]), res["cm"].cpu().long(),
                         [p.grad.detach().double() for p in seg.model.parameters()],
                         (counts["parity_tail_fwd"], counts["parity_tail_bwd"]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (la, ca, ga, na), (lb, cb, gb, nb) = out["default"], out["full"]
    diff = sum(float((x - y).square().sum()) for x, y in zip(ga, gb))
    norm = sum(float(y.square().sum()) for y in gb)
    return {"launches": na, "launches_full": nb, "loss_rel": abs(la - lb) / abs(lb),
            "cm_l1": int((ca - cb).abs().sum()), "cm_pixels": int(ca.sum()),
            "grad_rel": (diff / norm) ** 0.5}


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
def test_default_train_step_ends_in_t1_t2(card, accum):
    """With the key ``fused_tail`` absent, a refined train step on the card
    takes the parity tail: T1 and T2 once each per microbatch, none with
    ``fused_tail: false``, and the same step as the full-resolution one
    from the same weights (:func:`default_and_full_resolution_steps`):
    every non-padded pixel counted in the matrix, the loss to 1e-6
    relative, the matrices within 8 pixels of each other, the gradients to
    1e-5 in relative 2-norm: float32 reassociation in the tail, carried
    back through the network.  Readings on an H100 over seeds 0–4 and
    ``accum`` 1 and 2: loss gaps 0 to 7.3e-8, matrices equal, gradients
    1.11e-6 to 1.23e-6 (the CPU's reading of the same comparison at 32²:
    1.3e-6)."""
    r = default_and_full_resolution_steps(accum)
    assert r["launches"] == (accum, accum) and r["launches_full"] == (0, 0), r
    assert r["cm_pixels"] == (2 * accum - 1) * 128 * 128, r
    assert r["loss_rel"] <= 1e-6, r
    assert r["cm_l1"] <= 8, r
    assert r["grad_rel"] <= 1e-5, r


@pytest.mark.cuda
def test_parity_tail_takes_the_labels_the_loss_takes(card):
    """Labels the full-resolution loss takes and T1/T2 do not read (uint8
    and float ids, float64 and integer one-hot) go through ``tail_loss_cm``
    as int32 ids or float32 one-hot: the loss, matrix and gradient of the
    int64 ids and float32 one-hot, bit for bit."""
    from deeplabv3plus_keras_tpu_torch.ops import parity_tail

    x, ids, pw, nw, valid, _ = _parity_tail_inputs((2, 16, 16, 21), torch.float32, False)
    onehot = torch.nn.functional.one_hot(ids, 21)

    def run(lab):
        xr = x.clone().requires_grad_()
        loss, cm = parity_tail.tail_loss_cm(xr, lab, pw, nw, 21, valid)
        loss.backward()
        return loss, cm, xr.grad

    for ref, others in ((run(ids), (ids.to(torch.uint8), ids.float())),
                        (run(onehot.float()), (onehot.double(), onehot))):
        for lab in others:
            for a, b in zip(ref, run(lab)):
                assert torch.equal(a, b), lab.dtype


@pytest.mark.cuda
def test_parity_tail_kernels_refuse_what_they_do_not_take(card):
    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt

    x = torch.zeros(1, 4, 4, 3, device="cuda")
    ok = torch.zeros(1, 8, 8, dtype=torch.long, device="cuda")
    w = torch.ones(3).numpy()
    with pytest.raises(ValueError, match=r"\(1, 8, 6\)"):  # not the ×2 map
        pt.parity_tail_forward(x, torch.zeros(1, 8, 6, dtype=torch.long, device="cuda"), w, w)
    with pytest.raises(ValueError, match="float64"):
        pt.parity_tail_forward(x.double(), ok, w, w)
    with pytest.raises(ValueError, match="one-hot"):  # an integer one-hot
        pt.parity_tail_backward(x, torch.zeros(1, 8, 8, 3, dtype=torch.long, device="cuda"), w, w,
                                torch.ones(1, device="cuda"))
    with pytest.raises(ValueError, match="C=3000"):
        pt.parity_tail_forward(torch.zeros(1, 2, 2, 3000, device="cuda"),
                               torch.zeros(1, 4, 4, dtype=torch.long, device="cuda"),
                               torch.ones(3000).numpy(), torch.ones(3000).numpy())
    with pytest.raises(ValueError, match="class weights"):
        pt.parity_tail_forward(x, ok, torch.ones(4).numpy(), torch.ones(4).numpy())
