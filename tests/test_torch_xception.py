"""The port's Xception DeepLabV3+ and its channels-first depthwise route
(``DLV3_DW_LAYOUT=bhcw``) against the JAX package's, on the CPU.

- The route (K6/K7's plain versions on a CPU tensor) against the JAX
  ``depthwise3x3`` under ``bhcw``, whose forward and backward are the Pallas
  kernels ``_dw_fwd_padded``/``_dw_bwd_padded`` run in interpret mode.
  Forward 2e-6 and dx 5e-6 absolute, the JAX package's own bounds for the
  stencil (tests/test_kernels.py:101, :117); dk 1e-5 of Σ|x·g| per tap and
  channel (a float32 sum of B·H·W products in two orders).
- The blocks Xception adds (``VALID`` conv, ``SAME`` max-pool) against flax.
- The backbone, the full model and the train step against the JAX package
  with the same weights: float32 logits within 1e-4 of their max and
  probabilities within 1e-5 (as tests/test_torch_model.py holds
  MobileNetV2); the float64 train step's loss within 5e-8 relative and BN
  statistics within 1e-10 (as tests/test_torch_train.py).

Xception's widths are fixed by its architecture, so only the image size is
cut (64²).  Random weights are drawn with numpy (``torch_helpers``); BN
statistics are then set from one batch so activations stay O(1) through
the residual stacks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.kernels.depthwise3 import depthwise3x3
from deeplabv3plus_keras_tpu.models.backbones.xception import XceptionBackbone as JaxXception
from deeplabv3plus_keras_tpu.parallel import step as jax_step
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.kernels import (
    depthwise_conv,
    depthwise_conv_backward,
    depthwise_conv_backward_plain,
    depthwise_route,
)
from deeplabv3plus_keras_tpu_torch.models import blocks
from deeplabv3plus_keras_tpu_torch.models.backbones import get_backbone
from deeplabv3plus_keras_tpu_torch.models.backbones.xception import XceptionBackbone
from deeplabv3plus_keras_tpu_torch.parallel import step as port_step
from deeplabv3plus_keras_tpu_torch.train import loss as port_loss
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables, load_jax_variables

from torch_helpers import (
    _redraw,
    calibrate_bn,
    jax_model_and_variables,
    port_model,
    xception_conf_dict,
)

torch.set_num_threads(1)


def _to_port(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _from_port(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def _close(a, b, rel):
    scale = float(np.abs(b).max())
    assert scale > 0.1, "activations vanished; the comparison would test nothing"
    np.testing.assert_allclose(a, b, atol=rel * scale, rtol=0)


def _images(n=2, size=64, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


# ---- the channels-first route against the interpret-mode Pallas kernels ----

CF_SHAPES = [(2, 16, 16, 8), (1, 12, 20, 144), (1, 9, 13, 32), (1, 11, 15, 64)]


@pytest.mark.parametrize("shape", CF_SHAPES)
def test_cf_route_matches_pallas_bhcw_kernels(shape, monkeypatch):
    monkeypatch.setenv("DLV3_DW_LAYOUT", "bhcw")
    rng = np.random.default_rng(sum(shape))
    B, H, W, C = shape
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 1, C)) * 0.5).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    y_ref, vjp = jax.vjp(depthwise3x3, jnp.asarray(x), jnp.asarray(k))
    rdx, rdk = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    xp = _to_port(x).requires_grad_()
    wp = w.clone().requires_grad_()
    kernels.reset_launch_counts()
    y = depthwise_conv(xp, wp)
    assert depthwise_route(w) == "cf"
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_from_port(y), np.asarray(y_ref), atol=2e-6, rtol=0)

    y.backward(_to_port(g))
    assert xp.grad.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_from_port(xp.grad), rdx, atol=5e-6, rtol=0)
    dk = wp.grad.numpy().transpose(2, 3, 1, 0)
    _, dk_abs = depthwise_conv_backward_plain(
        torch.from_numpy(np.abs(x)).permute(0, 3, 1, 2), w, torch.from_numpy(np.abs(g)).permute(0, 3, 1, 2))
    assert (np.abs(dk - rdk) <= 1e-5 * dk_abs.numpy().transpose(2, 3, 1, 0)).all()
    # the backward alone takes the same route; CPU tensors count no launch
    dx2, dk2 = depthwise_conv_backward(_to_port(x), w, _to_port(g))
    assert dx2.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(dx2, xp.grad, rtol=0, atol=0)
    torch.testing.assert_close(dk2, wp.grad, rtol=0, atol=0)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("layout", [None, "nhwc", "bhcw"])
def test_route_names_the_kernel_family(layout, monkeypatch):
    if layout is None:
        monkeypatch.delenv("DLV3_DW_LAYOUT", raising=False)
    else:
        monkeypatch.setenv("DLV3_DW_LAYOUT", layout)
    w3, w5 = torch.zeros(8, 1, 3, 3), torch.zeros(8, 1, 5, 5)
    assert depthwise_route(w3) == ("cf" if layout == "bhcw" else "nhwc")
    assert depthwise_route(w3, 1, (2, 2)) == "nhwc"  # dilated: K2/K4
    assert depthwise_route(w3, 1, (1, 2)) == "nhwc"
    assert depthwise_route(w3, 2) == "nhwc"  # stride 2: K3/K5
    assert depthwise_route(w5) == "nhwc"  # k5: K2/K4
    x = torch.randn(1, 8, 7, 9).contiguous(memory_format=torch.channels_last)
    for w, s, d in ((w3, 1, (1, 1)), (w3, 1, (2, 2)), (w3, 2, (1, 1)), (w5, 1, (1, 1))):
        assert depthwise_conv(x, w, s, d).is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("value", ["BHCW", "nchw", ""])
def test_unknown_layout_raises(value, monkeypatch):
    monkeypatch.setenv("DLV3_DW_LAYOUT", value)
    with pytest.raises(ValueError, match="DLV3_DW_LAYOUT"):
        depthwise_conv(torch.zeros(1, 8, 6, 6).contiguous(memory_format=torch.channels_last),
                       torch.zeros(8, 1, 3, 3))


# ---- the blocks Xception adds, against flax ----

@pytest.mark.parametrize("size", [13, 9, 8, 6])
def test_max_pool_same_matches_flax(size):
    """253 → 127 and 127 → 64 pad (1, 1), 64 → 32 pads (0, 1): odd and even
    sizes, forward and gradient."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 2, 5)).astype(np.float32)

    def ref(a):
        return nn.max_pool(a, (3, 3), strides=(2, 2), padding="SAME")

    y_ref, vjp = jax.vjp(ref, jnp.asarray(x))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    xp = _to_port(x).requires_grad_()
    y = blocks.max_pool_same(xp, 3, 2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_from_port(y), np.asarray(y_ref))
    y.backward(_to_port(g))
    np.testing.assert_allclose(_from_port(xp.grad), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6)
    if size % 2 == 0:  # torch's symmetric padding=1 is the trap here
        sym = torch.nn.functional.max_pool2d(_to_port(x), 3, 2, padding=1)
        assert np.abs(_from_port(sym) - np.asarray(y_ref)).max() > 1e-2


@pytest.mark.parametrize("size,stride", [(13, 2), (12, 2), (11, 1), (10, 1)])
def test_valid_conv_matches_flax(size, stride):
    rng = np.random.default_rng(size + stride)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    conv = nn.Conv(4, (3, 3), strides=(stride, stride), padding="VALID", use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, vjp = jax.vjp(lambda a, p: conv.apply({"params": p}, a), jnp.asarray(x), v["params"])
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    rdx, rdp = vjp(jnp.asarray(g))
    pc = blocks.Conv(3, 4, 3, strides=stride, padding="VALID")
    load_jax_variables(pc, {"params": jax.tree_util.tree_map(np.asarray, v["params"])})
    xp = _to_port(x).requires_grad_()
    y = pc(xp)
    assert tuple(y.shape) == (2, 4) + y_ref.shape[1:3]
    np.testing.assert_allclose(_from_port(y), np.asarray(y_ref), atol=1e-5)
    y.backward(_to_port(g))
    np.testing.assert_allclose(_from_port(xp.grad), np.asarray(rdx), atol=1e-5)
    np.testing.assert_allclose(pc.weight.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(rdp["kernel"]), atol=1e-4)
    with pytest.raises(ValueError, match="padding"):
        blocks.Conv(3, 4, 3, padding="same")


# ---- backbone, model, train step ----

@pytest.mark.parametrize("layout", ["nhwc", "bhcw"])
@pytest.mark.parametrize("os_", [16, 8])
def test_xception_backbone_matches_jax(os_, layout, monkeypatch):
    monkeypatch.setenv("DLV3_DW_LAYOUT", layout)
    x = _images(2, 64)
    jm = JaxXception(output_stride=os_)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {c: _redraw(v[c], np.random.default_rng(os_)) for c in v}
    pm = XceptionBackbone(os_)
    assert pm.out_channels == JaxXception.feature_channels(os_)
    load_jax_variables(pm, v)
    pm = pm.to(memory_format=torch.channels_last)
    calibrate_bn(pm, _to_port(x))
    v = export_jax_variables(pm)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        out = _from_port(pm(_to_port(x)))
    # 64 → 31 → 29 (VALID stem) → 15 → 8 (→ 4 at os 16)
    assert out.shape == ref.shape == (2, 8 if os_ == 8 else 4, 8 if os_ == 8 else 4, pm.out_channels)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("layout", ["nhwc", "bhcw"])
def test_xception_full_model_matches_jax(layout, monkeypatch):
    monkeypatch.setenv("DLV3_DW_LAYOUT", layout)
    conf = xception_conf_dict(64)
    jm, v = jax_model_and_variables(conf, seed=7)
    pm = port_model(conf, v)
    x = _images(2, 64)
    calibrate_bn(pm, torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    v = export_jax_variables(pm)
    jl, jup = jm.apply(v, jnp.asarray(x), train=False, return_presample=True)
    jp = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        pl, pup = pm(torch.from_numpy(x), return_presample=True)
        pp = pm(torch.from_numpy(x))
    assert pup == jup == 2 and tuple(pp.shape) == jp.shape == (2, 64, 64, 21)
    _close(pl.numpy(), np.asarray(jl), 1e-4)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5)
    assert float(np.asarray(jp).max(-1).mean()) < 0.99  # not saturated: a real comparison


def test_xception_l2_is_the_heads_only():
    conf = xception_conf_dict(32)
    _, v = jax_model_and_variables(conf, seed=5)
    pm = port_model(conf, v)
    names = [n for n, _ in pm.named_parameters() if any("_l2" in p for p in n.split("."))]
    assert names and not any(n.startswith("base.") for n in names)
    from deeplabv3plus_keras_tpu.train import loss as jax_loss

    ref = float(jax_loss.l2_penalty(jax.tree_util.tree_map(jnp.asarray, v["params"]), 4e-5))
    assert abs(float(port_loss.l2_penalty(pm, 4e-5).detach()) - ref) <= 1e-6 * ref


def test_xception_variables_round_trip_through_the_port():
    for os_ in (16, 8):
        conf = xception_conf_dict(32, output_stride=os_)
        _, v = jax_model_and_variables(conf, seed=3)
        e = export_jax_variables(port_model(conf, v))
        flat_v = dict(jax.tree_util.tree_leaves_with_path(v))
        flat_e = dict(jax.tree_util.tree_leaves_with_path(e))
        assert flat_v.keys() == flat_e.keys()
        for path, a in flat_v.items():
            np.testing.assert_array_equal(flat_e[path], a, err_msg=jax.tree_util.keystr(path))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_xception_train_step_matches_jax_fp64_bhcw(x64, monkeypatch):
    """Two float64 steps at B=2, 64², the port under ``bhcw``."""
    monkeypatch.setenv("DLV3_DW_LAYOUT", "bhcw")
    conf = xception_conf_dict(64)
    conf["hps"].update(dtype="float64", lr=1e-4, decay=0.0)
    conf["nn_arch"]["dropout_rate"] = 0.0
    jm, v = jax_model_and_variables(conf, seed=7)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    pm = port_model(conf, v).double()
    jconf, pconf = JaxConfig.from_dict(conf), Config.from_dict(conf)
    jstate, tx = jax_step.create_train_state(jconf, jax.tree_util.tree_map(jnp.asarray, v))
    jtrain = jax.jit(jax_step.build_train_step(jm, tx, jconf))
    ptrain = port_step.build_train_step(pm, port_step.create_train_state(pconf, pm), pconf)
    rng = np.random.default_rng(11)
    for step in range(2):
        x = rng.uniform(-1, 1, (2, 64, 64, 3))
        y = rng.integers(0, 21, (2, 64, 64))
        val = np.ones(2, np.int32)
        jstate, jout = jtrain(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y),
                                       "valid": jnp.asarray(val)}, jax.random.PRNGKey(3))
        pout = ptrain({"image": torch.from_numpy(x), "label": torch.from_numpy(y),
                       "valid": torch.from_numpy(val)})
        jl, pl = float(jout["loss"]), float(pout["loss"])
        assert abs(pl - jl) <= 5e-8 * abs(jl), (step, pl, jl)
        np.testing.assert_array_equal(pout["cm"].numpy(), np.asarray(jout["cm"]))
        stats = export_jax_variables(pm)["batch_stats"]
        for path, a in jax.tree_util.tree_leaves_with_path(jstate.batch_stats):
            rel = np.abs(np.asarray(a) - _leaf(stats, path)).max() / np.abs(np.asarray(a)).max()
            assert rel <= 1e-10, (step, jax.tree_util.keystr(path), rel)


def test_facade_serves_and_trains_xception_at_os8(monkeypatch):
    """Through the public facade on the CPU under ``bhcw``: train steps at
    os 8, where block 4's shortcut is computed but unused (its weights get
    a zero gradient and stay put, as under jax.grad), then segment()."""
    monkeypatch.setenv("DLV3_DW_LAYOUT", "bhcw")
    seg = SemanticSegmentation(xception_conf_dict(32, output_stride=8), device="cpu")
    assert isinstance(seg.model.base, XceptionBackbone) and seg.model.base.out_channels == 728
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 21, (2, 32, 32))
    w0 = seg.model.base.conv2d_2.weight.detach().clone()
    m0 = seg.model.base.batch_normalization_2.running_mean.clone()
    for _ in range(2):
        out = seg.train_step({"image": x, "label": y})
        assert np.isfinite(float(out["loss"])) and int(out["cm"].sum()) == 2 * 32 * 32
    assert not seg.model.base.conv2d_2.weight.grad.any()
    assert torch.equal(seg.model.base.conv2d_2.weight, w0)
    assert not torch.equal(seg.model.base.batch_normalization_2.running_mean, m0)
    used = [p for n, p in seg.model.named_parameters() if "_2." not in n]
    assert all(p.grad.abs().sum() > 0 for p in used)
    labels = seg.segment(x)
    assert labels.shape == (2, 32, 32) and labels.min() >= 0 and labels.max() < 21


def test_registry_has_xception():
    assert isinstance(get_backbone("xception", 16), XceptionBackbone)
