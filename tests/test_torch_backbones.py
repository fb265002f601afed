"""The port's EfficientNet B0–B7, NASNet Mobile/Large and DenseNet
121/169/201 backbones against the JAX package's, on the CPU: their
variable trees, stochastic depth and the layout of their depthwise inputs.

- Every new name at output stride 8 and 16: ``load_jax_variables`` fills
  the port's backbone from the JAX tree (its shapes by ``jax.eval_shape``,
  nothing compiled) with nothing left over on either side,
  ``export_jax_variables`` gives the tree back, and ``out_channels`` is JAX
  ``feature_channels``.
- Stochastic depth: one draw a sample from the explicit generator, kept
  samples scaled by 1/keep, torch's global generator untouched.
- Every depthwise input of the new models is ``channels_last`` already,
  so ``DepthwiseConv.forward`` copies nothing.

The blocks are held one by one in ``tests/test_torch_backbone_blocks.py``,
the models' logits and train steps in ``tests/test_torch_backbones_parity.py``
and ``tests/test_torch_backbones_train.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.models.backbones import get_backbone as jax_get_backbone
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.config import ALL_BASE_MODELS
from deeplabv3plus_keras_tpu_torch.models import blocks
from deeplabv3plus_keras_tpu_torch.models.backbones import get_backbone
from deeplabv3plus_keras_tpu_torch.models.backbones.efficientnet import EfficientNetBackbone
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables, load_jax_variables

from torch_helpers import conf_dict

torch.set_num_threads(1)

NEW = [n for n in ALL_BASE_MODELS if n not in ("mobilenetv2", "xception")]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.shape(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


# ---- variable trees ----

@pytest.mark.parametrize("os_", [8, 16])
@pytest.mark.parametrize("name", NEW)
def test_state_dict_is_the_jax_tree(name, os_):
    jm = jax_get_backbone(name, os_)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = {c: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes[c])
         for c in shapes}
    pm = get_backbone(name, os_)
    load_jax_variables(pm, v)  # raises on a leaf or a tensor left over
    assert pm.out_channels == type(jm).feature_channels(name, os_)
    back = export_jax_variables(pm)
    assert _leaves({c: back[c] for c in v}) == _leaves(v)


# ---- stochastic depth ----

def test_stochastic_depth_is_per_sample_and_drawn_from_the_generator():
    drop = blocks.Dropout(0.25, per_sample=True).train()
    x = torch.rand(64, 3, 4, 5) + 0.5
    global_state = torch.random.get_rng_state()
    y = drop(x, torch.Generator().manual_seed(1))
    assert torch.equal(torch.random.get_rng_state(), global_state)
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(1)))  # same seed, same masks
    assert not torch.equal(y, drop(x, torch.Generator().manual_seed(2)))
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | (~kept).all(1)).all())  # whole samples kept or dropped
    assert 0 < int((~kept.all(1)).sum()) < 64
    torch.testing.assert_close(y[kept.all(1)], x[kept.all(1)] / 0.75, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    assert drop.eval()(x) is x


def test_efficientnet_drop_rates_grow_with_the_block_index():
    """drop_connect_rate × index / blocks (JAX ``efficientnet.py``), on the
    residual blocks only; 0.2 unless the constructor says otherwise."""
    base = EfficientNetBackbone("efficientnetb0", 16)
    rates = {n: getattr(base, n).drop for n in base.blocks}
    # B0: 16 blocks in all (7 stages); the os-16 cut keeps 1 + 2 + 2 + 3 + 3
    assert len(rates) == 11
    assert rates["block1a"] is None and rates["block2a"] is None  # no residual
    assert rates["block2b"].rate == pytest.approx(0.2 * 2 / 16)
    assert rates["block5c"].rate == pytest.approx(0.2 * 10 / 16)
    off = EfficientNetBackbone("efficientnetb0", 16, drop_connect_rate=0.0)
    assert all(getattr(off, n).drop is None or getattr(off, n).drop.rate == 0.0
               for n in off.blocks)


# ---- layout ----

@pytest.mark.parametrize("name", ["efficientnetb0", "nasnetmobile", "nasnetlarge"])
def test_depthwise_inputs_are_already_channels_last(name):
    """NASNet's slices, pads and concatenations and EfficientNet's gates keep
    every depthwise input ``channels_last``: the layout copy in
    ``DepthwiseConv.forward`` is a no-op at every site."""
    seg = SemanticSegmentation({**conf_dict(64), "base_model": name}, device="cpu")
    seen = []
    for m in seg.model.modules():
        if isinstance(m, blocks.DepthwiseConv):
            m.register_forward_pre_hook(
                lambda mod, a: seen.append(a[0].is_contiguous(memory_format=torch.channels_last)))
    seg.segment(np.zeros((1, 64, 64, 3), np.float32))
    assert len(seen) > 5 and all(seen)
