"""The train step of EfficientNet-B0 and NASNet-Mobile on the port against
the JAX package's, float64, on the CPU.

Two Keras-Adam steps at B=2, 64², from the same weights, with dropout and
stochastic depth at 0 on both sides: the JAX module's
``drop_connect_rate`` is set to 0 for the test (the facade fixes it at
0.2), the port's per-block rates likewise, since the two frameworks draw
different masks.  The bounds are ``tests/test_torch_xception.py``'s: the
loss within 5e-8 relative, the confusion matrix equal, every BN statistic
within 1e-10 of its largest magnitude.  NASNet-Mobile's last normal cell
feeds nothing after the cut; its BN statistics still move, in both.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.models import backbones as jax_backbones
from deeplabv3plus_keras_tpu.models.backbones.efficientnet import (
    EfficientNetBackbone as JaxEfficientNet,
)
from deeplabv3plus_keras_tpu.parallel import step as jax_step
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.models.blocks import Dropout
from deeplabv3plus_keras_tpu_torch.parallel import step as port_step
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables

from torch_helpers import conf_dict, jax_model_and_traced_variables, port_model

torch.set_num_threads(1)


def _jax_efficientnet_without_drop(variant, output_stride=16, dtype=None, name="base"):
    return JaxEfficientNet(variant=variant, output_stride=output_stride, drop_connect_rate=0.0,
                           dtype=dtype, name=name)


@pytest.fixture
def no_stochastic_depth(monkeypatch):
    """The JAX package's EfficientNets built with ``drop_connect_rate`` 0."""
    jax_backbones.get_backbone("efficientnetb0", 16)  # fills the lazy registry
    for variant in list(jax_backbones._REGISTRY):
        if variant.startswith("efficientnet"):
            monkeypatch.setitem(jax_backbones._REGISTRY, variant,
                                functools.partial(_jax_efficientnet_without_drop, variant))


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


@pytest.mark.parametrize("name", ["efficientnetb0", "nasnetmobile"])
def test_train_step_matches_jax_fp64(name, x64, no_stochastic_depth):
    conf = {**conf_dict(64), "base_model": name}
    conf["hps"].update(dtype="float64", lr=1e-4, decay=0.0)
    conf["nn_arch"]["dropout_rate"] = 0.0
    jm, v = jax_model_and_traced_variables(conf, seed=7)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    pm = port_model(conf, v).double()
    for m in pm.modules():
        if isinstance(m, Dropout) and m.per_sample:
            m.rate = 0.0
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
