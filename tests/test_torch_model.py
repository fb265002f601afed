"""The port's model modules against the JAX package's, same weights, on the CPU.

Weights come from ``torch_helpers``: drawn with numpy from a seed into the
JAX package's variable tree, then carried into the port by
``load_jax_variables``.  Tolerances: float32 on both sides with convs summed
in different orders, so logits agree to ~1e-6 relative; the bounds below
leave a 10× margin.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.models import blocks as jax_blocks
from deeplabv3plus_keras_tpu.models.backbones.mobilenetv2 import MobileNetV2Backbone as JaxMNV2
from deeplabv3plus_keras_tpu.models.encoder import EncoderMiddle as JaxEncoder
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.models import blocks
from deeplabv3plus_keras_tpu_torch.models.backbones import get_backbone
from deeplabv3plus_keras_tpu_torch.models.backbones.mobilenetv2 import MobileNetV2Backbone
from deeplabv3plus_keras_tpu_torch.models.encoder import EncoderMiddle
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import load_jax_variables

from torch_helpers import _redraw, conf_dict, jax_model_and_variables, port_model

torch.set_num_threads(1)


def _images(n=2, size=64, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _to_port(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _from_port(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def _init_jax(module, x, seed):
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return {c: _redraw(variables[c], rng) for c in variables}


def _close(a, b, rel):
    scale = float(np.abs(b).max())
    assert scale > 0.1, "activations vanished; the comparison would test nothing"
    np.testing.assert_allclose(a, b, atol=rel * scale, rtol=0)


def test_batchnorm_is_keras_eps_and_momentum():
    bn = blocks.BatchNorm(4, momentum=0.9)
    assert bn.epsilon == 1e-3
    x = np.random.default_rng(0).normal(size=(2, 3, 3, 4)).astype(np.float32)
    jbn = jax_blocks.BatchNorm(momentum=0.9)
    v = _init_jax(jbn, x, seed=1)
    load_jax_variables(bn, v)
    np.testing.assert_allclose(
        _from_port(bn.eval()(_to_port(x))),
        np.asarray(jbn.apply(v, jnp.asarray(x))), atol=1e-6)
    # Keras momentum m ↔ torch 1 − m: one training step moves the running
    # statistics by (1 − m) of the batch's, as flax does, with the biased
    # batch variance (torch's own update takes the unbiased one: at n = 18
    # values per channel that is 1/17 larger, ~0.6 % of the variance here)
    y, upd = jbn.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    out = bn.train()(_to_port(x))
    np.testing.assert_allclose(_from_port(out), np.asarray(y), atol=1e-6)
    np.testing.assert_allclose(
        bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["bn"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(
        bn.running_var.numpy(), np.asarray(upd["batch_stats"]["bn"]["var"]), atol=1e-6)


def test_bn_without_scale_has_no_weight():
    bn = blocks.BatchNorm(4, scale=False)
    assert bn.weight is None and "weight" not in bn.state_dict()


def test_stride2_conv_uses_tf_same_padding():
    rng = np.random.default_rng(2)
    x, k = rng.normal(size=(1, 8, 8, 3)).astype(np.float32), rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    conv = blocks.Conv(3, 4, 3, strides=2)
    load_jax_variables(conv, {"params": {"kernel": k}})
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    np.testing.assert_allclose(_from_port(conv(_to_port(x))), ref, atol=1e-5)
    # torch's symmetric padding=1 is the trap: a one-pixel shift
    sym = torch.nn.functional.conv2d(_to_port(x), conv.weight, stride=2, padding=1)
    assert np.abs(_from_port(sym) - ref).max() > 1e-2


def test_avg_pool_valid_floors():
    y = blocks.avg_pool_valid(torch.ones(1, 2, 7, 9), 2)
    assert tuple(y.shape) == (1, 2, 3, 4)


def test_initializers_draw_from_the_generator():
    w1, w2 = torch.empty(64, 96, 3, 3), torch.empty(64, 96, 3, 3)
    blocks.glorot_uniform_(w1, torch.Generator().manual_seed(5))
    blocks.glorot_uniform_(w2, torch.Generator().manual_seed(5))
    assert torch.equal(w1, w2)
    limit = (6.0 / (9 * 96 + 9 * 64)) ** 0.5
    assert w1.abs().max() <= limit and w1.abs().max() > 0.95 * limit
    dw = torch.empty(144, 1, 3, 3)  # flax fans of (3,3,1,144): 9 and 9·144
    blocks.glorot_uniform_(dw, torch.Generator().manual_seed(0))
    assert dw.abs().max() <= (6.0 / (9 + 9 * 144)) ** 0.5
    t = torch.empty(256, 256, 1, 1)
    blocks.truncated_normal_05_(t, torch.Generator().manual_seed(0))
    assert t.abs().max() <= 0.1 and 0.035 < t.std() < 0.05


@pytest.mark.parametrize("os_", [8, 16])
def test_mobilenetv2_matches_jax(os_):
    x = _images(2, 64)
    jm = JaxMNV2(output_stride=os_)
    v = _init_jax(jm, x, seed=os_)
    pm = MobileNetV2Backbone(os_)
    load_jax_variables(pm, v)
    pm = pm.to(memory_format=torch.channels_last).eval()
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        out = _from_port(pm(_to_port(x)))
    assert out.shape == (2, 64 // os_, 64 // os_, 32 if os_ == 8 else 96) == ref.shape
    _close(out, ref, 1e-5)


def test_encoder_flagship_dag_with_pyramid_pooling_matches_jax():
    arch = JaxConfig.from_dict(conf_dict(64, pyramid=True)).nn_arch
    kw = dict(reduction_size=arch.reduction_size, concat_channels=arch.concat_channels,
              conv_rate_multiplier=1, dropout_rate=0.5, bn_momentum=0.9, bn_scale=True)
    x = np.random.default_rng(3).normal(size=(2, 4, 4, 96)).astype(np.float32)
    je = JaxEncoder(middle_conf=tuple(arch.encoder_middle_conf), **kw)
    v = _init_jax(je, x, seed=3)
    pe = EncoderMiddle(96, Config.from_dict(conf_dict(64, pyramid=True)).nn_arch.encoder_middle_conf, **kw)
    load_jax_variables(pe, v)
    pe = pe.eval()
    with torch.no_grad():
        out = _from_port(pe(_to_port(x)))
    _close(out, np.asarray(je.apply(v, jnp.asarray(x))), 1e-5)


@pytest.mark.parametrize("refine,os_", [(True, 16), (False, 16), (True, 8)])
def test_full_model_matches_jax(refine, os_):
    conf = conf_dict(64, output_stride=os_, refine=refine)
    jm, v = jax_model_and_variables(conf, seed=7)
    pm = port_model(conf, v)
    x = _images(2, 64)
    jl, jup = jm.apply(v, jnp.asarray(x), train=False, return_presample=True)
    jp = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        pl, pup = pm(torch.from_numpy(x), return_presample=True)
        pp = pm(torch.from_numpy(x))
    assert pup == jup == (2 if refine else os_)
    assert tuple(pl.shape) == jl.shape and tuple(pp.shape) == jp.shape == (2, 64, 64, 21)
    _close(pl.numpy(), np.asarray(jl), 1e-4)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5)


def test_refined_classifier_two_step_path_matches_jax():
    conf = conf_dict(64, fused_upconv=False)
    jm, v = jax_model_and_variables(conf, seed=8)
    pm = port_model(conf, v)
    assert not pm.decoder.classifier_l2.fused
    x = _images(1, 64, seed=4)
    jl, _ = jm.apply(v, jnp.asarray(x), train=False, return_presample=True)
    with torch.no_grad():
        pl, _ = pm(torch.from_numpy(x), return_presample=True)
    _close(pl.numpy(), np.asarray(jl), 1e-4)


def test_load_jax_variables_raises_on_leftovers():
    conf = conf_dict(64)
    _, v = jax_model_and_variables(conf)
    model = port_model(conf, v)
    extra = {"params": {**v["params"], "stray": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        load_jax_variables(model, extra)
    missing = {"params": {k: p for k, p in v["params"].items() if k != "decoder"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="no JAX leaf"):
        load_jax_variables(model, missing)


def test_bn_scale_false_transplants_without_weights():
    conf = conf_dict(64)
    conf["hps"]["bn_scale"] = False
    jm, v = jax_model_and_variables(conf, seed=9)
    pm = port_model(conf, v)
    assert pm.encoder.projection.bn.weight is None
    assert pm.base.block_1.depthwise_BN.weight is not None  # backbone BNs keep scale
    x = _images(1, 64, seed=5)
    jl, _ = jm.apply(v, jnp.asarray(x), train=False, return_presample=True)
    with torch.no_grad():
        pl, _ = pm(torch.from_numpy(x), return_presample=True)
    _close(pl.numpy(), np.asarray(jl), 1e-4)


def test_other_backbones_name_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="Queue A item 14"):
        get_backbone("efficientnetb0", 16)
    with pytest.raises(ValueError, match="Unknown"):
        get_backbone("resnet50", 16)
