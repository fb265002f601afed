"""The control below bfloat16 on the CPU: rounding to 6 significant bits,
the convolutions it rounds, and a reference so rounded departs from the
sound one further than the same reference under bfloat16 autocast."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark import control
from benchmark.reference import model as ref
from benchmark.tests.tiny import tiny_cell


def test_six_bits_move_a_tensor_by_a_quarter_of_bfloat16():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1 << 16, generator=g) * torch.exp2(torch.randint(-20, 20, (1 << 16,),
                                                                     generator=g).float())
    y = control.round_bits(x, 6)
    rel = float(((y - x) / x).square().mean().sqrt())
    assert 2.0 ** -8 < rel < 2.0 ** -6
    # bfloat16 (8 significant bits) moves it by a quarter as much
    rel16 = float(((x.bfloat16().float() - x) / x).square().mean().sqrt())
    assert 3.5 < rel / rel16 < 4.5


def test_six_bit_values_unchanged():
    x = torch.cat([torch.arange(-63, 64).float() * 2.0 ** k for k in range(-30, 30, 7)])
    assert torch.equal(control.round_bits(x, 6), x)
    y = control.round_bits(torch.randn(4096), 6)
    assert torch.equal(control.round_bits(y, 6), y)
    # ties go to the even neighbour: 65 = 1000001b lies between 64 and 66
    assert control.round_bits(torch.tensor([65.0, 67.0, -65.0]), 6).tolist() == [64.0, 68.0, -64.0]


def test_rounded_convs_forward_and_backward():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 9, 9, generator=g)
    w = torch.randn(4, 1, 5, 5, generator=g, requires_grad=True)
    with control.RoundedConvs(6):
        y = F.conv2d(x, w, padding=2, groups=4)
        (gw,) = torch.autograd.grad(y.square().sum(), w)
    xr, wr = control.round_bits(x, 6), control.round_bits(w.detach(), 6).requires_grad_(True)
    yr = F.conv2d(xr, wr, padding=2, groups=4)
    (gr,) = torch.autograd.grad(yr.square().sum(), wr)
    assert torch.equal(y, yr)
    assert torch.allclose(gw, gr, rtol=1e-5, atol=1e-5)


def test_bfloat16_control_is_below_bfloat16():
    """On a tiny flagship (2 x 64^2, seed 0): the logits' relative RMS gap
    to the sound reference is larger under the control than under
    bfloat16 autocast (seeds 0-5 read 1.76-2.23 times larger)."""
    torch.set_num_threads(4)
    arch = ref.arch_of(tiny_cell("flagship-train").config["config"])
    w = ref.random_weights(arch, 0, "cpu")
    g = torch.Generator().manual_seed(100)
    images = torch.rand((2, 64, 64, 3), generator=g) * 2.0 - 1.0
    ref.calibrate_bn(arch, w, images, 0)

    @torch.no_grad()
    def logits(ctx):
        with ctx:
            return ref.logits(ref.Run(w, train=False), arch, images)[0].float()

    sound = logits(contextlib.nullcontext())

    def gap(ctx):
        return float((logits(ctx) - sound).square().mean().sqrt() / sound.square().mean().sqrt())

    below = gap(control.below("bfloat16", "cpu"))
    bf16 = gap(control.below("float16", "cpu"))  # bfloat16 autocast
    assert below > 1.5 * bf16 > 0
