"""The blocks the port's EfficientNet, NASNet and DenseNet backbones add,
one by one against flax, lax or the JAX package's modules, on the CPU:
Keras NASNet's zero-padded stride-2 pools, the ``SAME`` stride-1 average
pool at odd sizes, NASNet's adjust path, the explicit-pad conv, the conv
with bias of the squeeze-excite, EfficientNet's MBConv and DenseNet's
layer.  Forwards within 1e-6 (pools), 1e-5 (single convs) or 1e-5 of the
output's largest magnitude (blocks with BN), gradients within 1e-5 of
theirs (1e-4 absolute for a conv's kernel, as
``tests/test_torch_xception.py``).  bfloat16 for the biased conv: within
its rounding (2e-2 at outputs of a few units).  In bfloat16 the blocks
round where flax rounds (JAX compiled without XLA's excess precision):
sigmoid, swish, the Keras average pools, an MBConv and a NASNet separable
block equal JAX's bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from deeplabv3plus_keras_tpu.models.backbones import nasnet as jax_nasnet
from deeplabv3plus_keras_tpu.models.backbones.densenet import DenseLayer as JaxDenseLayer
from deeplabv3plus_keras_tpu.models.backbones.efficientnet import MBConv as JaxMBConv
from deeplabv3plus_keras_tpu_torch.models import blocks
from deeplabv3plus_keras_tpu_torch.models.backbones.densenet import DenseLayer
from deeplabv3plus_keras_tpu_torch.models.backbones.efficientnet import MBConv
from deeplabv3plus_keras_tpu_torch.models.backbones.nasnet import _Adjust, _SepBlock
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables, load_jax_variables

from torch_helpers import _redraw, strict_jit

torch.set_num_threads(1)


def _to_port(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _from_port(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("size", [9, 8, 7])
def test_keras_stride2_pools_match_jax(size, op):
    """Zero pads by ``correct_pad`` ((1, 1) on odd sizes, (0, 1) on even),
    a ``VALID`` pool: the max compares against the zeros, the average
    divides by 9 at the border too."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 1, 5)).astype(np.float32) - 1.0
    y_ref, vjp = jax.vjp(lambda a: jax_nasnet._pool_s2_keras(a, 3, op), jnp.asarray(x))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    xp = _to_port(x).requires_grad_()
    y = blocks.pool_s2_keras(xp, 3, op)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_from_port(y), np.asarray(y_ref), atol=1e-6, rtol=0)
    y.backward(_to_port(g))
    np.testing.assert_allclose(_from_port(xp.grad), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6)


@pytest.mark.parametrize("size", [7, 6, 3])
def test_same_avg_pool_excludes_the_padding(size):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 2, 4)).astype(np.float32)
    y_ref, vjp = jax.vjp(jax_nasnet._avg_s1_same_tf, jnp.asarray(x))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    xp = _to_port(x).requires_grad_()
    y = blocks.avg_pool_same_s1(xp)
    np.testing.assert_allclose(_from_port(y), np.asarray(y_ref), atol=1e-6, rtol=0)
    y.backward(_to_port(g))
    np.testing.assert_allclose(_from_port(xp.grad), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6)
    # the corner averages its 4 in-image pixels, not 9
    np.testing.assert_allclose(_from_port(y)[:, 0, 0], x[:, :2, :2].mean((1, 2)), atol=1e-6)


def _module_pair(jm, pm, *xs, train=False, seed=3):
    """Init ``jm`` on ``xs``, redraw its weights with numpy, load them into
    ``pm``; returns (JAX output, port output) with ``train``-mode BN, and
    the JAX VJP for an output gradient."""
    v = jm.init(jax.random.PRNGKey(0), *[jnp.asarray(x) for x in xs])
    v = {c: _redraw(v[c], np.random.default_rng(seed)) for c in v}
    load_jax_variables(pm, v)
    pm.train(train)

    def f(*a):
        out = jm.apply(v, *a, train=train, mutable=["batch_stats"] if train else False)
        return out[0] if train else out

    y_ref, vjp = jax.vjp(f, *[jnp.asarray(x) for x in xs])
    return v, y_ref, vjp


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["strided_odd", "strided_even", "projection"])
def test_nasnet_adjust_matches_jax(kind, train):
    """The previous path at twice the resolution (a 1×1 conv of p[::2, ::2]
    and one of the same shifted a pixel down and right, zero past the
    edge, concatenated) or at the cell's (a 1×1 projection)."""
    rng = np.random.default_rng(len(kind))
    size = {"strided_odd": 9, "strided_even": 8, "projection": 5}[kind]
    p = rng.normal(size=(2, size, size, 16)).astype(np.float32)
    ip = rng.normal(size=(2, 5 if kind != "strided_even" else 4, 5 if kind != "strided_even" else 4,
                          24)).astype(np.float32)
    jm = jax_nasnet._Adjust(12)
    pm = _Adjust(12, (0 if kind != "projection" else 1, 16), (1, 24))
    assert pm.mode == ("projection" if kind == "projection" else "strided").replace("projection", "project")
    _, y_ref, vjp = _module_pair(jm, pm, p, ip, train=train)
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    pp = _to_port(p).requires_grad_()
    y = pm(pp, _to_port(ip))
    assert y.is_contiguous(memory_format=torch.channels_last)
    scale = float(np.abs(np.asarray(y_ref)).max())
    np.testing.assert_allclose(_from_port(y), np.asarray(y_ref), atol=1e-5 * scale, rtol=0)
    y.backward(_to_port(g))
    rdp = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(_from_port(pp.grad), rdp, atol=1e-5 * np.abs(rdp).max(), rtol=0)


@pytest.mark.parametrize("pads,stride,size", [(((3, 3), (3, 3)), 2, 13), (((3, 3), (3, 3)), 2, 12),
                                              (((1, 2), (0, 1)), 1, 9)])
def test_explicit_pad_conv_matches_flax(pads, stride, size):
    rng = np.random.default_rng(size + stride)
    k = 7 if pads[0][0] == 3 else 3
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    conv = nn.Conv(4, (k, k), strides=(stride, stride), padding=pads, use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, vjp = jax.vjp(lambda a, p: conv.apply({"params": p}, a), jnp.asarray(x), v["params"])
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    rdx, rdp = vjp(jnp.asarray(g))
    pc = blocks.Conv(3, 4, k, strides=stride, padding=pads)
    load_jax_variables(pc, {"params": jax.tree_util.tree_map(np.asarray, v["params"])})
    xp = _to_port(x).requires_grad_()
    y = pc(xp)
    np.testing.assert_allclose(_from_port(y), np.asarray(y_ref), atol=1e-5)
    y.backward(_to_port(g))
    np.testing.assert_allclose(_from_port(xp.grad), np.asarray(rdx), atol=1e-5)
    np.testing.assert_allclose(pc.weight.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(rdp["kernel"]), atol=1e-4)
    with pytest.raises(ValueError, match="padding"):
        blocks.Conv(3, 4, 3, padding=(3, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_with_bias_matches_flax(dtype):
    """The squeeze-excite's 1×1 convs: flax ``nn.Conv`` with its bias (here
    nonzero), added after the conv in the conv's dtype."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, 1, 8)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    conv = nn.Conv(6, (1, 1), dtype=jdt)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"kernel": np.asarray(v["params"]["kernel"]),
                    "bias": rng.normal(size=(6,)).astype(np.float32)}}
    y_ref, vjp = jax.vjp(lambda a, p: conv.apply({"params": p}, a), jnp.asarray(x, jdt),
                         jax.tree_util.tree_map(jnp.asarray, v["params"]))
    pc = blocks.Conv(8, 6, 1, bias=True)
    load_jax_variables(pc, v)
    assert export_jax_variables(pc)["params"]["bias"].shape == (6,)
    y = pc(_to_port(x).to(tdt))
    assert y.dtype == tdt
    np.testing.assert_allclose(_from_port(y.float()), np.asarray(y_ref, np.float32),
                               atol=1e-5 if dtype == "float32" else 2e-2, rtol=0)
    if dtype == "float32":
        g = rng.normal(size=y_ref.shape).astype(np.float32)
        y.backward(_to_port(g))
        np.testing.assert_allclose(pc.bias.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[1]["bias"]),
                                   atol=1e-5)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("cin,cout,k,stride,expand", [(16, 16, 5, 1, 6), (16, 24, 3, 2, 6),
                                                      (16, 16, 3, 1, 1)])
def test_mbconv_matches_jax(cin, cout, k, stride, expand, train):
    """expand → depthwise → SE (with its biases) → project (+ residual);
    stochastic depth off (rate 0 on both sides)."""
    rng = np.random.default_rng(cin + cout + k)
    x = rng.normal(size=(2, 9, 9, cin)).astype(np.float32)
    jm = JaxMBConv(features_out=cout, kernel=k, strides=stride, expand_ratio=expand)
    pm = MBConv(cin, cout, k, stride, expand)
    _, y_ref, vjp = _module_pair(jm, pm, x, train=train)
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    xp = _to_port(x).requires_grad_()
    y = pm(xp)
    scale = float(np.abs(np.asarray(y_ref)).max())
    np.testing.assert_allclose(_from_port(y), np.asarray(y_ref), atol=1e-5 * scale, rtol=0)
    y.backward(_to_port(g))
    rdx = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(_from_port(xp.grad), rdx, atol=1e-5 * np.abs(rdx).max(), rtol=0)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dense_layer_matches_jax(train):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 7, 40)).astype(np.float32)
    _, y_ref, _ = _module_pair(JaxDenseLayer(), DenseLayer(40), x, train=train)
    pm = DenseLayer(40)
    _module_pair(JaxDenseLayer(), pm, x, train=train)
    y = pm(_to_port(x))
    assert y.shape[1] == 72 and y.is_contiguous(memory_format=torch.channels_last)
    scale = float(np.abs(np.asarray(y_ref)).max())
    np.testing.assert_allclose(_from_port(y), np.asarray(y_ref), atol=1e-5 * scale, rtol=0)


# bfloat16: the blocks round where flax rounds (JAX compiled without XLA's
# excess precision, torch_helpers.strict_jit): equal bit for bit at these
# sizes, where no conv's sum order happens to round the other way
BF16_CASES = {
    "sigmoid": (lambda: nn.sigmoid, lambda: blocks.sigmoid, (2, 5, 7, 16)),
    "swish": (lambda: nn.swish, lambda: blocks.swish, (2, 5, 7, 16)),
    "keras_avg_pool_s2": (lambda: lambda a: jax_nasnet._pool_s2_keras(a, 3, "avg"),
                          lambda: lambda a: blocks.pool_s2_keras(a, 3, "avg"), (2, 9, 8, 16)),
    "avg_pool_2x2": (lambda: lambda a: nn.avg_pool(a, (2, 2), strides=(2, 2)),
                     lambda: lambda a: blocks.avg_pool_valid(a, 2), (2, 8, 10, 16)),
    "mbconv_k5": (lambda: JaxMBConv(features_out=16, kernel=5, strides=1, expand_ratio=6,
                                    dtype=jnp.bfloat16),
                  lambda: MBConv(16, 16, 5, 1, 6), (2, 9, 9, 16)),
    "mbconv_no_expand": (lambda: JaxMBConv(features_out=16, kernel=3, strides=1, expand_ratio=1,
                                           dtype=jnp.bfloat16),
                         lambda: MBConv(16, 16, 3, 1, 1), (2, 9, 9, 16)),
    "nasnet_sep_block_s2": (lambda: jax_nasnet._SepBlock(12, 5, 2, dtype=jnp.bfloat16),
                            lambda: _SepBlock(16, 12, 5, 2), (2, 9, 9, 16)),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bfloat16_rounds_where_flax_rounds(case):
    jax_factory, port_factory, shape = BF16_CASES[case]
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32) * 2
    xb = jnp.asarray(x, jnp.bfloat16)
    jm, pm = jax_factory(), port_factory()
    if isinstance(pm, torch.nn.Module):
        v = jm.init(jax.random.PRNGKey(0), xb)
        v = {c: _redraw(v[c], np.random.default_rng(3)) for c in v}
        load_jax_variables(pm, v)
        pm.eval()
        fn = lambda v, a: jm.apply(v, a)  # noqa: E731
        args = (v, xb)
    else:
        fn = lambda a: jm(a)  # noqa: E731
        args = (xb,)
    want = np.asarray(strict_jit(fn, *args)(*args).astype(jnp.float32))
    with torch.no_grad():
        got = pm(_to_port(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_from_port(got.float()), want)
