"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA card is present.  This file
imports neither JAX nor the JAX package, so on a machine that has a card
but no JAX it runs without the suite's ``conftest.py``:

    python -m pytest tests/test_torch_on_card.py --noconftest -m cuda -q
"""

import pytest
import torch

from deeplabv3plus_keras_tpu_torch import kernels
from deeplabv3plus_keras_tpu_torch.kernels import (
    depthwise_conv,
    depthwise_conv_plain,
    upsample_argmax,
    upsample_argmax_plain,
)

# (B, H, W, C), k, stride, dilation: taps wholly in the padding, odd sizes
# at stride 2, k 5 and 7, and one backbone-like stride-2 site.
DEPTHWISE_CASES = [
    ((2, 4, 4, 16), 3, 1, (18, 15)),
    ((1, 4, 4, 8), 3, 1, (6, 21)),
    ((1, 5, 7, 8), 5, 1, (3, 4)),
    ((1, 7, 9, 8), 3, 2, (1, 1)),
    ((1, 6, 6, 8), 7, 2, (1, 1)),
    ((2, 64, 64, 96), 3, 2, (1, 1)),
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


@pytest.mark.cuda
def test_depthwise_kernel_refuses_what_it_does_not_take(card):
    w = torch.randn(8, 1, 3, 3, device="cuda")
    with pytest.raises(TypeError):
        depthwise_conv(torch.randn(1, 8, 6, 6, device="cuda", dtype=torch.float64)
                       .contiguous(memory_format=torch.channels_last), w.double())
    with pytest.raises(ValueError, match="channels_last"):
        depthwise_conv(torch.randn(1, 8, 6, 6, device="cuda"), w)


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
