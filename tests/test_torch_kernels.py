"""The port's kernel modules against the JAX package's, on the CPU.

On a CPU tensor each wrapper takes its plain PyTorch version, so these
tests hold the plain versions (the arithmetic the CUDA kernels must
reproduce) against the Pallas kernels run in interpret mode, or against
lax where the Pallas stencil does not take the shape.  The CUDA kernels
themselves run only on the card: ``tests/test_torch_on_card.py`` (marker
``cuda``) and ``chip_smoke.py`` compare them with the plain versions there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.kernels.depthwise3 import (
    depthwise_stencil,
    depthwise_stencil_s2,
)
from deeplabv3plus_keras_tpu.kernels.upsample_argmax import (
    upsample_argmax as jax_upsample_argmax,
    upsample_argmax_reference,
)
from deeplabv3plus_keras_tpu.ops import fused_upconv as jax_fused
from deeplabv3plus_keras_tpu.ops import resize as jax_resize
from deeplabv3plus_keras_tpu_torch import kernels
from deeplabv3plus_keras_tpu_torch.kernels import _build
from deeplabv3plus_keras_tpu_torch.kernels.depthwise import (
    depthwise_conv,
    depthwise_conv_backward,
    depthwise_conv_backward_plain,
    depthwise_conv_plain,
    same_pads,
)
from deeplabv3plus_keras_tpu_torch.kernels.upsample_argmax import (
    upsample_argmax,
    upsample_argmax_plain,
)
from deeplabv3plus_keras_tpu_torch.ops import fused_upconv, resize

torch.set_num_threads(1)


def _nhwc_to_port(x):
    """numpy NHWC → torch NCHW in channels_last memory (the model's layout)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port_to_nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


def _dw_port(x, k_hwio, stride=1, dil=(1, 1)):
    w = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    return _port_to_nhwc(depthwise_conv(_nhwc_to_port(x), w, stride, dil))


def _dw_lax(x, k_hwio, stride=1, dil=(1, 1)):
    return np.asarray(
        jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k_hwio), (stride, stride), "SAME",
            rhs_dilation=dil, dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=x.shape[-1], precision=jax.lax.Precision.HIGHEST,
        )
    )


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dil", [(1, 1), (2, 3)])
def test_depthwise_s1_matches_pallas_stencil(k, dil):
    rng = np.random.default_rng(k * 10 + dil[1])
    x, kern = _rand(rng, 1, 8, 16, 8), _rand(rng, k, k, 1, 8)
    ref = np.asarray(depthwise_stencil(jnp.asarray(x), jnp.asarray(kern), dil))
    np.testing.assert_allclose(_dw_port(x, kern, 1, dil), ref, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
def test_depthwise_s2_matches_pallas_stencil(k):
    rng = np.random.default_rng(k)
    x, kern = _rand(rng, 1, 8, 16, 8), _rand(rng, k, k, 1, 8)
    ref = np.asarray(depthwise_stencil_s2(jnp.asarray(x), jnp.asarray(kern)))
    out = _dw_port(x, kern, 2)
    assert out.shape == (1, 4, 8, 8)
    np.testing.assert_allclose(out, ref, atol=1e-5)


# Shapes the Pallas stencil does not take ((k//2)*dw >= W): taps that fall
# wholly in the zero padding, as the flagship ASPP rates do on small maps.
LAX_CASES = [
    ((2, 4, 4, 16), 3, 1, (18, 15)),
    ((1, 4, 4, 8), 3, 1, (6, 21)),
    ((1, 5, 7, 8), 5, 1, (3, 4)),
    ((1, 7, 9, 8), 3, 2, (1, 1)),  # odd sizes at stride 2
    ((1, 6, 6, 8), 7, 2, (1, 1)),
]


@pytest.mark.parametrize("shape,k,stride,dil", LAX_CASES)
def test_depthwise_matches_lax(shape, k, stride, dil):
    rng = np.random.default_rng(sum(shape) + k)
    x, kern = _rand(rng, *shape), _rand(rng, k, k, 1, shape[-1])
    np.testing.assert_allclose(
        _dw_port(x, kern, stride, dil), _dw_lax(x, kern, stride, dil), atol=1e-5
    )


def _dw_bwd_port(x, k_hwio, g, stride=1, dil=(1, 1)):
    """(dx NHWC, dk HWIO) from the port's backward wrapper (plain on the CPU)."""
    w = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    dx, dw = depthwise_conv_backward(_nhwc_to_port(x), w, _nhwc_to_port(g), stride, dil)
    return _port_to_nhwc(dx), dw.numpy().transpose(2, 3, 1, 0)


def _assert_bwd_close(port, ref):
    """The JAX package's own bounds for its stencil VJPs
    (tests/test_kernels.py:330-334): dx 1e-5 absolute, dk 2e-6 of its max."""
    (dx, dk), (rdx, rdk) = port, ref
    np.testing.assert_allclose(dx, rdx, atol=1e-5, rtol=0)
    scale = float(np.abs(rdk).max())
    np.testing.assert_allclose(dk / scale, rdk / scale, atol=2e-6, rtol=0)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dil", [(1, 1), (2, 3)])
def test_depthwise_backward_s1_matches_pallas_vjp(k, dil):
    """Against ``jax.vjp`` of the Pallas stencil: its backward is K4
    (``_dw_bwd_nhwc``), run in interpret mode."""
    rng = np.random.default_rng(k * 100 + dil[1])
    x, kern, g = _rand(rng, 1, 8, 16, 8), _rand(rng, k, k, 1, 8), _rand(rng, 1, 8, 16, 8)
    _, vjp = jax.vjp(lambda a, b: depthwise_stencil(a, b, dil), jnp.asarray(x), jnp.asarray(kern))
    rdx, rdk = vjp(jnp.asarray(g))
    _assert_bwd_close(_dw_bwd_port(x, kern, g, 1, dil), (np.asarray(rdx), np.asarray(rdk)))


@pytest.mark.parametrize("k", [3, 5])
def test_depthwise_backward_s2_matches_pallas_vjp(k):
    """Against ``jax.vjp`` of the stride-2 Pallas stencil: its backward is
    K5 (``_dw_bwd_s2``, parity planes merged), run in interpret mode."""
    rng = np.random.default_rng(k + 50)
    x, kern, g = _rand(rng, 1, 8, 16, 8), _rand(rng, k, k, 1, 8), _rand(rng, 1, 4, 8, 8)
    _, vjp = jax.vjp(depthwise_stencil_s2, jnp.asarray(x), jnp.asarray(kern))
    rdx, rdk = vjp(jnp.asarray(g))
    _assert_bwd_close(_dw_bwd_port(x, kern, g, 2), (np.asarray(rdx), np.asarray(rdk)))


@pytest.mark.parametrize("shape,k,stride,dil", LAX_CASES)
def test_depthwise_backward_matches_lax(shape, k, stride, dil):
    """Taps wholly in the padding (their dk is exactly 0) and odd sizes
    at stride 2, which the Pallas stencils do not take: against lax's VJP."""
    rng = np.random.default_rng(sum(shape) + k + 7)
    x, kern = _rand(rng, *shape), _rand(rng, k, k, 1, shape[-1])
    g = _rand(rng, *_dw_lax(x, kern, stride, dil).shape)
    _, vjp = jax.vjp(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (stride, stride), "SAME", rhs_dilation=dil,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=shape[-1],
        precision=jax.lax.Precision.HIGHEST), jnp.asarray(x), jnp.asarray(kern))
    rdx, rdk = vjp(jnp.asarray(g))
    dx, dk = _dw_bwd_port(x, kern, g, stride, dil)
    _assert_bwd_close((dx, dk), (np.asarray(rdx), np.asarray(rdk)))
    H, W = shape[1:3]
    for ky in range(k):  # a tap that reads only padding has no gradient
        for kx in range(k):
            if abs(ky - k // 2) * dil[0] >= H or abs(kx - k // 2) * dil[1] >= W:
                assert stride == 1 and not dk[ky, kx].any()


def test_depthwise_autograd_on_cpu_is_the_plain_backward():
    kernels.reset_launch_counts()
    x = torch.randn(2, 8, 7, 9, dtype=torch.float64).contiguous(memory_format=torch.channels_last)
    w = torch.randn(8, 1, 3, 3, dtype=torch.float64)
    g = torch.randn(2, 8, 4, 5, dtype=torch.float64)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    depthwise_conv(xr, wr, 2).backward(g)
    dx, dw = depthwise_conv_backward_plain(x, w, g, 2)
    torch.testing.assert_close(xr.grad, dx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(wr.grad, dw, rtol=1e-12, atol=1e-12)
    assert set(kernels.launch_counts().values()) == {0}


def test_same_pads_tf_semantics():
    # stride 2, k 3, even size: nothing before, one after (torch's
    # symmetric padding=1 would shift the window by a pixel)
    assert same_pads(256, 3, 2, 1) == (128, 0, 1)
    assert same_pads(7, 3, 2, 1) == (4, 1, 1)
    assert same_pads(32, 3, 1, 21) == (32, 21, 21)
    assert same_pads(8, 5, 2, 1) == (4, 1, 2)


def test_depthwise_wrapper_cpu_takes_plain_and_counts_nothing():
    kernels.reset_launch_counts()
    x = torch.randn(1, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    w = torch.randn(8, 1, 3, 3)
    torch.testing.assert_close(depthwise_conv(x, w, 2), depthwise_conv_plain(x, w, 2))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize(
    "x,w,stride,dil,err",
    [
        ((1, 8, 6, 6), (8, 1, 4, 4), 1, (1, 1), ValueError),  # even k
        ((1, 8, 6, 6), (4, 1, 3, 3), 1, (1, 1), ValueError),  # C mismatch
        ((1, 8, 6, 6), (8, 1, 3, 3), 3, (1, 1), ValueError),  # stride 3
        ((1, 8, 6, 6), (8, 1, 3, 3), 2, (2, 2), ValueError),  # dilated s2
        ((1, 8, 6, 6), (8, 1, 3, 3), 1, (0, 1), ValueError),  # dilation 0
    ],
)
def test_depthwise_wrapper_rejects(x, w, stride, dil, err):
    with pytest.raises(err):
        depthwise_conv(torch.zeros(x), torch.zeros(w), stride, dil)


def test_wrappers_refuse_non_cpu_non_cuda_devices():
    with pytest.raises(ValueError):
        depthwise_conv(torch.zeros(1, 8, 6, 6, device="meta"), torch.zeros(8, 1, 3, 3, device="meta"))
    with pytest.raises(ValueError):
        upsample_argmax(torch.zeros(1, 4, 4, 3, device="meta"), 2)


@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_argmax_matches_pallas(scale):
    rng = np.random.default_rng(scale)
    x = _rand(rng, 2, 8, 8, 21)
    ref = np.asarray(jax_upsample_argmax(jnp.asarray(x), scale))
    out = upsample_argmax(torch.from_numpy(x), scale)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 8 * scale, 8 * scale)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_upsample_argmax_matches_reference_at_scale_16():
    x = _rand(np.random.default_rng(16), 2, 4, 4, 21)
    ref = np.asarray(upsample_argmax_reference(jnp.asarray(x), 16))
    np.testing.assert_array_equal(upsample_argmax_plain(torch.from_numpy(x), 16).numpy(), ref)


def test_upsample_argmax_ties_choose_first_class():
    out = upsample_argmax(torch.zeros(1, 4, 4, 7), 2)
    assert (out == 0).all()


@pytest.mark.parametrize("f", [2, 4, 8])
def test_upsample_conv3_matches_jax(f):
    rng = np.random.default_rng(f)
    x, w = _rand(rng, 2, 5, 6, 7), _rand(rng, 3, 3, 7, 5)
    ref = np.asarray(jax_fused.upsample_conv3(jnp.asarray(x), jnp.asarray(w), f))
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    out = fused_upconv.upsample_conv3(_nhwc_to_port(x), wt, f)
    np.testing.assert_allclose(_port_to_nhwc(out), ref, atol=1e-5)


@pytest.mark.parametrize("factors", [(2, 2), (4, 2), (16, 16)])
def test_resizes_match_jax(factors):
    x = _rand(np.random.default_rng(3), 2, 3, 5, 4)
    ref = np.asarray(jax_resize.tf_resize_images(jnp.asarray(x), *factors))
    for fn in (resize.tf_resize_images, resize.tf_resize_images_matmul):
        np.testing.assert_allclose(_port_to_nhwc(fn(_nhwc_to_port(x), *factors)), ref, atol=1e-5)


def test_build_command_targets_hopper(tmp_path):
    cmd = _build.build_command(tmp_path / "k.cu", tmp_path / "k.so", "nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert set(_build.sources()) == {"depthwise_bwd", "depthwise_cf", "depthwise_fwd", "upsample_argmax"}


def test_build_target_changes_with_an_included_header(tmp_path, monkeypatch):
    """A library is keyed by its source and the headers it includes, so an
    edited header builds anew instead of reusing a stale library."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [h.name for h in _build._headers(csrc / "depthwise_bwd.cu")] == ["depthwise_common.cuh"]
    before = {n: _build._target(n) for n in ("depthwise_bwd", "depthwise_fwd", "upsample_argmax")}
    header = csrc / "depthwise_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n) for n in before}
    assert after["depthwise_bwd"] != before["depthwise_bwd"]
    assert after["depthwise_fwd"] != before["depthwise_fwd"]
    assert after["upsample_argmax"] == before["upsample_argmax"]  # includes no header

