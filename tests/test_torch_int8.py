"""int8 post-training quantization on the port (``ops/quant.py``,
``models/blocks.py`` ``QuantConv``) against the JAX package's
(``deeplabv3plus_keras_tpu/ops/quant.py``, its ``QuantConv``), on the CPU.

Tolerances and why:

- the quantizers are the same float32 operations (a division, round half
  to even, a clip), so they agree bit for bit, ties included;
- ``int8_conv``'s plain version is an exact integer product dequantized as
  JAX dequantizes, y_s32 · (s_x · s_w): within 1e-6 relative (it is exact
  here);
- the calibrated ranges are abs-maxima of float32 activations that the two
  stacks compute to rounding: 1e-4 relative;
- the whole int8 model is a discontinuous function of its float
  pre-activations: where they differ by rounding, a quantized value moves
  by one step, and the step's effect carries to every later site.  In
  float64 the pre-activations agree to ~1e-15, no value moves, and the
  logits agree to the float32 dequantization's rounding (1e-6 relative).
  In float32 the moved values are counted, and the port's distance to
  JAX's int8 logits is bounded by the int8 model's own distance to the
  float model (a moved value is one quantization step, the size of the
  error int8 makes everywhere).

The JAX side runs op by op (each operation compiled alone, rounding as its
jaxpr says): under ``jax.jit`` XLA reassociates the dequantization's
y · s_x · s_w, which alone moves values downstream.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.models.blocks import QuantConv as JaxQuantConv
from deeplabv3plus_keras_tpu.ops import quant as jq
from deeplabv3plus_keras_tpu_torch.models.blocks import QuantConv
from deeplabv3plus_keras_tpu_torch.ops import quant as pq
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables

from torch_helpers import (
    calibrate_bn,
    conf_dict,
    jax_model_and_traced_variables,
    port_model,
    xception_conf_dict,
)

torch.set_num_threads(1)

MODELS = {
    "mobilenetv2": lambda: conf_dict(64),
    "xception": lambda: xception_conf_dict(64),
    "efficientnetb0": lambda: {**conf_dict(64), "base_model": "efficientnetb0"},
}


def _flat(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def jax_ranges(q) -> dict[str, float]:
    """The JAX ``quant`` collection as {port site name: in_absmax}."""
    return {".".join(p[:-1]): float(a) for p, a in _flat(q)}


# ---- the quantizers and the conv ----

def _with_ties(rng, shape, scale):
    """Values whose quotient by ``scale`` lands on exact .5 ties (and on
    ±127.5, past the clip), mixed with random ones."""
    x = rng.normal(0.0, 40.0, shape)
    flat = x.reshape(-1)
    ties = rng.integers(-128, 128, flat.size // 3) + 0.5
    flat[: ties.size] = ties
    return (x * scale).astype(np.float32)


def test_quantizers_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    # absmax 127 gives a scale of exactly 1, so x/s keeps the ties
    x = _with_ties(rng, (2, 5, 6, 8), 1.0)
    for absmax in (np.float32(127.0), np.float32(np.abs(x).max() * 0.7), np.float32(0.0)):
        jx, js = jq.quantize_activation(jnp.asarray(x), jnp.asarray(absmax))
        px, ps = pq.quantize_activation(torch.from_numpy(x), torch.tensor(absmax))
        assert px.dtype == torch.int8 and ps.dtype == torch.float32
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        assert ps.item() == float(js)
    # weights: each output channel's abs-max 127 (scale 1), ties inside
    w = _with_ties(rng, (3, 3, 16, 12), 1.0).clip(-126.5, 126.5)
    w[0, 0, 0] = 127.0
    w[..., 5] *= 3e-3  # a channel of other scale
    w[..., 6] = 0.0    # the 1e-12 floor
    jw, jsw = jq.quantize_weight_per_channel(jnp.asarray(w))
    pw, psw = pq.quantize_weight_per_channel(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(pw.permute(2, 3, 1, 0).numpy(), np.asarray(jw))
    np.testing.assert_array_equal(psw.numpy(), np.asarray(jsw))
    assert (np.abs(np.asarray(jx)) <= 127).all() and np.asarray(jx).min() == -127


CONV_CASES = [
    (1, 1, "SAME"), (1, 2, "SAME"), (3, 1, "SAME"), (3, 2, "SAME"),
    (1, 2, "VALID"), (3, 1, "VALID"), (3, 2, "VALID"), (3, 1, ((1, 0), (2, 1))),
]


@pytest.mark.parametrize("k,stride,padding", CONV_CASES)
def test_int8_conv_plain_matches_jax(k, stride, padding):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, 9, 10, 16)).astype(np.float32)
    w = rng.normal(size=(k, k, 16, 24)).astype(np.float32)
    absmax = np.float32(np.abs(x).max() * 0.8)  # some values clip
    ref = np.asarray(jq.int8_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(absmax),
                                  strides=(stride, stride), padding=padding))
    got = pq.int8_conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), torch.tensor(absmax),
                       strides=stride, padding=padding)
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_int8_product_is_exact():
    """The plain product at the largest K of the zoo, every term ±127²."""
    a = torch.full((20, 2048), 127, dtype=torch.int8)
    a[::2] = -127
    w = torch.full((16, 2048), 127, dtype=torch.int8)
    out = pq.int8_product(a, w)
    assert out.dtype == torch.int32
    assert out[0, 0].item() == -2048 * 127 * 127 and out[1, 0].item() == 2048 * 127 * 127


@pytest.mark.parametrize("cin,cout,pixels", [
    (127, 128, None), (128, 127, 16), (128, 128, None), (128, 128, 1), (2048, 728, 4096),
    (728, 728, 4097), (128, 1024, 128 * 128), (96, 4096, 16), (4096, 4096, 0),
])
def test_eligible_gate_edges(cin, cout, pixels):
    assert pq.MIN_QUANT_CHANNELS == jq.MIN_QUANT_CHANNELS == 128
    assert pq.MAX_QUANT_PIXELS == jq.MAX_QUANT_PIXELS == 4096
    assert pq.eligible(cin, cout, pixels) == jq.eligible(cin, cout, pixels)
    expect = min(cin, cout) >= 128 and (pixels is None or pixels <= 4096)
    assert pq.eligible(cin, cout, pixels) == expect


# ---- the model: sites, ranges, logits ----

def _setup(name, dtype=np.float32):
    """(JAX model, variables, port model, images) with BN statistics from one
    batch (random weights otherwise shrink or blow up the activations)."""
    conf = MODELS[name]()
    conf["hps"]["dtype"] = np.dtype(dtype).name
    jm, v = jax_model_and_traced_variables(conf, seed=3)
    pm = port_model(conf, v).to(torch.float64 if dtype == np.float64 else torch.float32)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(dtype)
    calibrate_bn(pm, torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    return jm, export_jax_variables(pm), pm, x


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    return (request.param, *_setup(request.param))


@pytest.mark.parametrize("max_pixels", [4096, 64])
def test_calibrated_sites_and_ranges_match_jax(model, max_pixels, monkeypatch):
    """The same sites, at the default spatial gate and at one that drops
    the 8²/15² sites, and each in_absmax to float32 rounding."""
    name, jm, v, pm, x = model
    monkeypatch.setattr(jq, "MAX_QUANT_PIXELS", max_pixels)
    monkeypatch.setattr(pq, "MAX_QUANT_PIXELS", max_pixels)
    x2 = np.flip(x, 0).copy()  # a running max over two batches
    ref = jax_ranges(jq.calibrate(jm, v, [x, x2]))
    got = pq.calibrate(pm, [x, x2])
    assert sorted(got) == sorted(ref) and len(got) >= 10
    for site, amax in ref.items():
        assert got[site].dtype == torch.float32
        assert abs(got[site].item() - amax) <= 1e-4 * amax, site
    # every calibrated site is a QuantConv the gate lets through
    quant_sites = {n for n, m in pm.named_modules() if isinstance(m, QuantConv)}
    assert set(got) <= quant_sites
    assert set(got) != quant_sites  # the stems and thin convs stay float


def _jax_int8(jm, v, q, x):
    """JAX's int8 logits op by op, and each quantized site's input."""
    inputs = {}

    def record(next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, JaxQuantConv) and ctx.method_name == "__call__":
            inputs[".".join(ctx.module.path)] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        logits = jm.apply({**v, "quant": q}, jnp.asarray(x), train=False, return_presample=True)[0]
    return np.asarray(logits), inputs


def _port_int8(pm, ranges, x):
    inputs = {}
    names = {m: n for n, m in pm.named_modules()}
    hooks = [m.register_forward_pre_hook(
        lambda m, a: inputs.__setitem__(names[m], a[0].permute(0, 2, 3, 1).numpy().copy()))
        for m in pm.modules() if isinstance(m, QuantConv)]
    try:
        pq.reset_counts()
        with torch.no_grad(), pq.quantized(pm, ranges):
            logits = pm(torch.from_numpy(x), return_presample=True)[0].numpy()
    finally:
        for h in hooks:
            h.remove()
    assert pq.counts["int8_conv"] == len(ranges)
    return logits, inputs


def _moved(ranges, jin, pin):
    """(values quantized differently at the sites, values at the sites)."""
    moved = total = 0
    for site, amax in ranges.items():
        s = np.float32(max(amax, 1e-12)) / np.float32(127.0)
        a = np.clip(np.round(jin[site].astype(np.float32) / s), -127, 127)
        b = np.clip(np.round(pin[site].astype(np.float32) / s), -127, 127)
        moved += int((a != b).sum())
        total += a.size
    return moved, total


def test_int8_model_close_to_jax_float32(model):
    name, jm, v, pm, x = model
    q = jq.calibrate(jm, v, [x])
    ranges = jax_ranges(q)
    jl, jin = _jax_int8(jm, v, q, x)
    pl, pin = _port_int8(pm, {k: torch.tensor(a) for k, a in ranges.items()}, x)
    jf = np.asarray(jax.jit(lambda v_, x_: jm.apply(v_, x_, train=False, return_presample=True)[0])(
        v, jnp.asarray(x)))
    moved, total = _moved(ranges, jin, pin)
    dist, own = np.abs(pl - jl).max(), np.abs(jl - jf).max()
    print(f"{name}: {moved} of {total} quantized values moved; port vs JAX int8 "
          f"{dist / np.abs(jl).max():.3g}, JAX int8 vs float {own / np.abs(jl).max():.3g}")
    assert np.isfinite(pl).all() and pl.shape == jl.shape
    assert dist <= own


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", ["xception"])
def test_int8_model_matches_jax_float64(name, x64):
    jm, v, pm, x = _setup(name, np.float64)
    q = jq.calibrate(jm, v, [x])
    got = pq.calibrate(pm, [x])
    ranges = jax_ranges(q)
    assert {k: a.item() for k, a in got.items()} == ranges  # float32 of the same float64 maxima
    jl, jin = _jax_int8(jm, v, q, x)
    pl, pin = _port_int8(pm, got, x)
    assert pl.dtype == jl.dtype == np.float64
    assert _moved(ranges, jin, pin)[0] == 0
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-6 * np.abs(jl).max())


def test_training_never_reads_the_ranges(model):
    """Outside a quantized pass (training, plain inference) every site is
    float, and the ranges stay out of the state_dict."""
    _, _, _, pm, x = model
    keys = set(pm.state_dict())
    ranges = pq.calibrate(pm, [x])
    assert set(pm.state_dict()) == keys and pq.active() is None
    pq.reset_counts()
    with torch.no_grad():
        pm(torch.from_numpy(x))
    assert pq.counts["int8_conv"] == 0 and ranges
