"""The fused upsample+argmax kernel's plan and decomposition, on the CPU.

``csrc/upsample_argmax.cu`` (K1) computes labels block by block as
``kernels/upsample_argmax.py`` ``_upsample_argmax_plan`` lays them out: a
band of source rows × a tile of source columns, all channels, copied with a
one-pixel halo clamped at the image's edges.  The CUDA kernel runs only on
the card; here ``upsample_argmax_band_emulation`` computes the same blocks
with the kernel's float32 operations in its order, and its labels must
equal, pixel for pixel, those of the JAX package's Pallas kernel
``upsample_argmax`` (interpret mode on the CPU) and of its reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_keras_tpu.kernels.upsample_argmax import upsample_argmax as jax_upsample_argmax
from deeplabv3plus_keras_tpu.kernels.upsample_argmax import upsample_argmax_reference
from deeplabv3plus_keras_tpu_torch.kernels.upsample_argmax import (
    _phase_weights,
    _upsample_argmax_plan,
    upsample_argmax_band_emulation,
)

torch.set_num_threads(1)


# (B, h, w, C) with odd h and w; the last band and column tile cut short
SHAPES = [(2, 7, 9, 21), (1, 5, 11, 150), (1, 9, 5, 1), (1, 3, 70, 21), (2, 17, 13, 150)]


def _labels(shape, scale, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    plan = _upsample_argmax_plan(*shape, scale)
    return x, upsample_argmax_band_emulation(torch.from_numpy(x), scale, plan).numpy()


# The Pallas kernel unrolls s² phases × C channels when it is traced, so
# interpret mode takes seconds a case: small maps here, the reference below
# for the rest (the Pallas kernel's own tests hold it to that reference).
@pytest.mark.parametrize("shape,scale", [((2, 7, 9, 21), 2), ((1, 3, 5, 21), 3), ((1, 5, 7, 21), 4),
                                         ((1, 3, 5, 1), 16)])
def test_band_emulation_equals_the_pallas_kernel(shape, scale):
    x, got = _labels(shape, scale, sum(shape) + scale)
    np.testing.assert_array_equal(got, np.asarray(jax_upsample_argmax(jnp.asarray(x), scale)))


@pytest.mark.parametrize("scale", [2, 3, 4, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_band_emulation_equals_the_jax_reference(shape, scale):
    """Against ``upsample_argmax_reference`` (the TF resize, then argmax)."""
    x, got = _labels(shape, scale, sum(shape) + scale)
    np.testing.assert_array_equal(got, np.asarray(upsample_argmax_reference(jnp.asarray(x), scale)))


@pytest.mark.parametrize("shape,scale", [((1, 3, 2, 21), 65), ((1, 2, 3, 5), 100)])
def test_band_emulation_equals_the_jax_reference_at_large_scales(shape, scale):
    """Scales past 64 (the phase table is made for each s, so none is
    capped)."""
    x, got = _labels(shape, scale, sum(shape) + scale)
    np.testing.assert_array_equal(got, np.asarray(upsample_argmax_reference(jnp.asarray(x), scale)))


@pytest.mark.parametrize("scale", [1, 2, 16])
@pytest.mark.parametrize("shape", [(1, 6, 7, 21), (2, 70, 9, 3)])
def test_plan_blocks_cover_every_label_once(shape, scale):
    B, h, w, C = shape
    plan = _upsample_argmax_plan(*shape, scale)
    seen = np.zeros((B, h * scale, w * scale), np.int32)
    for b, q0, p0 in plan.blocks():
        seen[b, q0 * scale:(q0 + plan.bh) * scale, p0 * scale:(p0 + plan.bw) * scale] += 1
    assert (seen == 1).all()
    assert plan.bw % 4 == 0 and plan.wpad == plan.bw + 2
    assert plan.smem >= (plan.bh + 2) * C * plan.wpad * 4


def test_plan_at_the_label_step_and_wide_c():
    """The flagship's label step (16, 256, 256, 21), ×2: 8 source rows ×
    64 columns a block in 55 KB (8 × 32 tasks of 2 × 4 labels, one a
    thread), 2048 blocks.  Wider C takes narrower bands and tiles within 64
    KB (C = 150: 1 × 32), then up to 227 KB (C = 512: 1 × 16 in 111 KB);
    past C = 3228 nothing fits."""
    p = _upsample_argmax_plan(16, 256, 256, 21, 2)
    assert (p.bh, p.bw, p.smem, p.grid) == (8, 64, 10 * 21 * 66 * 4, (4, 32, 16))
    q = _upsample_argmax_plan(2, 64, 64, 150, 2)
    assert q.smem <= 64 * 1024 and (q.bh, q.bw) == (1, 32)
    q = _upsample_argmax_plan(2, 64, 64, 512, 2)
    assert 64 * 1024 < q.smem <= 227 * 1024 and (q.bh, q.bw) == (1, 16)
    assert _upsample_argmax_plan(1, 8, 8, 3228, 2).smem <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        _upsample_argmax_plan(1, 8, 8, 3229, 2)
    assert _upsample_argmax_plan(1, 8, 8, 21, 1000).bh == 8  # the scale does not change the band
    assert _upsample_argmax_plan(16, 256, 256, 21, 2) is p


def test_phase_weights_are_the_jax_kernels():
    from deeplabv3plus_keras_tpu.kernels.upsample_argmax import _phase_weights as jax_phases

    for s in (1, 2, 3, 4, 16, 64, 65, 100):
        assert _phase_weights(s) == jax_phases(s)


def test_phase_offsets_are_the_kernels_integer_rule():
    """The kernel takes a phase's source offset as -1 where 2p + 1 < s,
    else 0 (csrc/upsample_argmax.cu phase_d), in place of the double
    floor((p + 0.5) / s - 0.5)."""
    for s in list(range(1, 300)) + [1023, 4096, 46340]:
        assert [d for d, _ in _phase_weights(s)] == [-1 if 2 * p + 1 < s else 0 for p in range(s)]
