"""EfficientNet-B0, EfficientNet-B3 (width 1.2: the rounding of filters to
multiples of 8), NASNet-Mobile (its ``VALID`` stem and odd maps) and
DenseNet-121 on the port against the JAX package, float32, on the CPU.

Same weights on both sides (drawn with numpy, ``torch_helpers``; BN
statistics then set from one batch so activations stay O(1)), images of
64², B=2.  The bounds are those of ``tests/test_torch_xception.py``: the
backbone's features and the model's pre-upsample logits within 1e-4 of
their largest magnitude, the probabilities within 1e-5.  Each model's JAX
apply is jitted once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.models.backbones import get_backbone as jax_get_backbone
from deeplabv3plus_keras_tpu_torch.models.backbones import get_backbone
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables, load_jax_variables

from torch_helpers import (
    _redraw,
    calibrate_bn,
    conf_dict,
    jax_model_and_traced_variables,
    port_model,
)

torch.set_num_threads(1)

MODELS = ["efficientnetb0", "efficientnetb3", "nasnetmobile", "densenet121"]


def _images(n=2, size=64, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _close(a, b, rel):
    scale = float(np.abs(b).max())
    assert scale > 0.1, "activations vanished; the comparison would test nothing"
    np.testing.assert_allclose(a, b, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("os_", [16, 8])
@pytest.mark.parametrize("name", MODELS)
def test_backbone_matches_jax(name, os_):
    x = _images()
    jm = jax_get_backbone(name, os_)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    v = {c: _redraw(shapes[c], np.random.default_rng(os_)) for c in shapes}
    pm = get_backbone(name, os_)
    load_jax_variables(pm, v)
    pm = pm.to(memory_format=torch.channels_last)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    calibrate_bn(pm, xt, generator=torch.Generator().manual_seed(0))
    v = export_jax_variables(pm)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        out = pm(xt).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 64 // os_, 64 // os_, pm.out_channels)
    _close(out, ref, 1e-4)


@pytest.fixture(scope="module", params=MODELS)
def model_pair(request):
    """(name, JAX (pre-upsample logits, probabilities) of the images, port
    model, images)."""
    name = request.param
    conf = {**conf_dict(64), "base_model": name}
    jm, v = jax_model_and_traced_variables(conf, seed=7)
    pm = port_model(conf, v)
    x = _images()
    calibrate_bn(pm, torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    v = export_jax_variables(pm)

    @jax.jit
    def apply(v, x):
        logits, _ = jm.apply(v, x, train=False, return_presample=True)
        return logits, jm.apply(v, x, train=False)

    jl, jp = apply(v, jnp.asarray(x))
    return name, (np.asarray(jl), np.asarray(jp)), pm, x


def test_full_model_matches_jax(model_pair):
    _, (jl, jp), pm, x = model_pair
    with torch.no_grad():
        pl, pup = pm(torch.from_numpy(x), return_presample=True)
        pp = pm(torch.from_numpy(x))
    # output stride 16 with boundary refinement: logits at 1/2, then ×2
    assert pup == 2 and tuple(pl.shape) == jl.shape == (2, 32, 32, 21)
    assert tuple(pp.shape) == jp.shape == (2, 64, 64, 21)
    _close(pl.numpy(), jl, 1e-4)
    np.testing.assert_allclose(pp.numpy(), jp, atol=1e-5, rtol=0)
    assert float(jp.max(-1).mean()) < 0.99  # not saturated: a real comparison


def test_full_model_batch_of_one_matches(model_pair):
    """Each image alone gives the batch's probabilities (eval BN, nothing
    across the batch), so serving at B=1 is the same model."""
    _, (_, jp), pm, x = model_pair
    with torch.no_grad():
        one = pm(torch.from_numpy(x[1:2]))
    np.testing.assert_allclose(one.numpy()[0], jp[1], atol=1e-5, rtol=0)
