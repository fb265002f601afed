"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA card is present.  This file
imports neither JAX nor the JAX package, so on a machine that has a card
but no JAX it runs without the suite's ``conftest.py``:

    python -m pytest tests/test_torch_on_card.py --noconftest -m cuda -q
"""

import math

import pytest
import torch

from deeplabv3plus_keras_tpu_torch import kernels
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


# (B, H, W, C), k, stride, dilation, dtype, storage offset in elements:
# bfloat16 with C = 12 (not a multiple of 8: narrow), bfloat16 vectors at
# both strides, and an x whose data_ptr is not 16-byte aligned.
FWD_EDGE_CASES = [
    ((2, 13, 17, 12), 3, 1, (1, 1), torch.bfloat16, 0),
    ((2, 21, 19, 64), 3, 2, (1, 1), torch.bfloat16, 0),
    ((1, 16, 16, 64), 3, 1, (4, 2), torch.bfloat16, 0),
    ((2, 19, 23, 40), 3, 1, (1, 1), torch.float32, 1),
    ((1, 18, 20, 40), 5, 2, (1, 1), torch.float32, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,stride,dil,dtype,offset", FWD_EDGE_CASES)
def test_depthwise_kernel_edges_match_plain(card, shape, k, stride, dil, dtype, offset):
    """Against the plain version in float64 on the same (rounded) inputs
    and taps: 1e-5 of its max for float32, 1e-2 for bfloat16 (the output's
    rounding).  ``offset`` shifts x's storage by that many elements, so the
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
    rel = 1e-5 if dtype == torch.float32 else 1e-2
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
# adds the output's rounding, 2^-8 relative, so 1e-2.  dk: a float32 sum
# of up to B*H*W products in either dtype, 1e-4 of sum |x*g| per tap and
# channel.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
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
    rel = 1e-5 if dtype == torch.float32 else 1e-2
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
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
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
    rel = 1e-5 if dtype == torch.float32 else 1e-2
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
