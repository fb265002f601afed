"""EfficientNet-B0 and NASNet-Mobile on the port in bfloat16, stochastic
depth under ``remat``, and EfficientNet's export, on the CPU.

- bfloat16 against the JAX package (compiled without XLA's excess
  precision, ``torch_helpers.strict_jit``), under the bounds that
  ``tests/test_torch_dtype.py`` states for the full model, and every conv
  computing in bfloat16.  The blocks round where flax rounds (an MBConv
  and a separable block equal JAX's bit for bit at 9², measured); what
  is left is a conv summing in another order now and then, which these
  nets grow over 11 MBConvs or 110 depthwise sites.  On the weights as
  drawn (activations up to hundreds) that growth reaches the float32
  port's own distance to JAX (measured 0.74 and 0.88 of it), while the
  logits stay within 5 % of their largest magnitude (measured 1.4 % and
  2.0 %) and the labels agree on at least 95 % of pixels (98.7 %,
  98.4 %): those two bounds are held there.  With BN statistics set from
  the batch (activations O(1)), the logits are below 0.5 and bfloat16's
  rounding is a tenth of them, but the port is at most 0.75 of the float32
  port's distance to JAX (measured 0.12 and 0.27) with at most half its
  label disagreement (measured 0.19 and 0.27 of it): those two bounds are
  held there.  EfficientNet normalises the images in float32 before its
  stem conv casts them, as the JAX module does: the stem's input equals
  the float32 prologue rounded once to bfloat16, bit for bit.
- Stochastic depth (EfficientNet's 0.2) draws from the step's generator
  only: two steps from the same seed give the same loss, and torch's
  global generator is not touched.  With ``remat`` the recompute draws the
  same masks: loss, BN statistics and gradients equal the plain step's
  bit for bit.
- ``convert_to_tf_lite()``'s ``.pt2`` of EfficientNet-B0 at 64²
  reproduces the model within 1e-6 (``tests/test_torch_export.py``'s
  bound).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.kernels.upsample_argmax import upsample_argmax_reference
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.models import blocks
from deeplabv3plus_keras_tpu_torch.models.decoder import _RefinedClassifier
from deeplabv3plus_keras_tpu_torch.parallel import step as port_step
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables

from torch_helpers import (
    calibrate_bn,
    conf_dict,
    jax_model_and_traced_variables,
    port_model,
    strict_jit,
)

torch.set_num_threads(1)


def _conv_inputs(model, x):
    """Every conv's input dtype in one forward, and the stem's input."""
    seen, stem = [], {}
    convs = (blocks.Conv, blocks.DepthwiseConv, _RefinedClassifier)
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.extend(a.dtype for a in args))
             for m in model.modules() if isinstance(m, convs)]
    first = next(m for m in model.base.modules() if isinstance(m, blocks.Conv))
    hooks.append(first.register_forward_pre_hook(lambda mod, args: stem.setdefault("x", args[0])))
    try:
        with torch.no_grad():
            out = model(x, return_presample=True)
    finally:
        for h in hooks:
            h.remove()
    return seen, stem["x"], out


@pytest.mark.parametrize("weights", ["drawn", "calibrated"])
@pytest.mark.parametrize("name", ["efficientnetb0", "nasnetmobile"])
def test_bfloat16_model_matches_jax(name, weights):
    conf = {**conf_dict(64), "base_model": name}
    conf["hps"]["dtype"] = "bfloat16"
    conf32 = copy.deepcopy(conf)
    conf32["hps"]["dtype"] = "float32"
    jm, v = jax_model_and_traced_variables(conf, seed=3)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    pm32 = port_model(conf32, v)
    if weights == "calibrated":
        calibrate_bn(pm32, torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
        v = export_jax_variables(pm32)
    jl = np.asarray(strict_jit(lambda v, x: jm.apply(v, x, return_presample=True)[0], v,
                               jnp.asarray(x))(v, jnp.asarray(x)))

    pm = port_model(conf, v)
    seen, stem_x, (pl, up) = _conv_inputs(pm, torch.from_numpy(x))
    assert len(seen) >= 30 and set(seen) == {torch.bfloat16}, set(seen)
    assert pl.dtype == torch.float32
    if name == "efficientnetb0":
        mean = np.asarray(v["batch_stats"]["base"]["normalization_mean"], np.float32)
        var = np.asarray(v["batch_stats"]["base"]["normalization_var"], np.float32)
        prologue = (jnp.asarray(x) / 255.0 - mean) / jnp.sqrt(var + 1e-7)
        want = np.asarray(prologue.astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(stem_x.float().permute(0, 2, 3, 1).numpy(), want)

    with torch.no_grad():
        p32, _ = pm32(torch.from_numpy(x), return_presample=True)
    pl, p32 = pl.numpy(), p32.numpy()
    labels = port_step.build_label_step(pm)(torch.from_numpy(x)).numpy()
    jlabels = np.asarray(upsample_argmax_reference(jnp.asarray(jl), up))
    labels32 = port_step.build_label_step(pm32)(torch.from_numpy(x)).numpy()
    agree, agree32 = (labels == jlabels).mean(), (labels32 == jlabels).mean()
    if weights == "drawn":
        assert np.abs(pl - jl).max() <= 5e-2 * np.abs(jl).max()
        assert agree >= 0.95
    else:
        assert np.linalg.norm(pl - jl) <= 0.75 * np.linalg.norm(p32 - jl)
        assert 1 - agree <= 0.5 * (1 - agree32)


def _batch(seed=11, size=32):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 21, (2, size, size))),
            "valid": torch.ones(2, dtype=torch.int32)}


def _step(remat: bool, steps: int = 1):
    conf = {**conf_dict(32), "base_model": "efficientnetb0", "remat": remat}
    conf["nn_arch"]["dropout_rate"] = 0.0  # only the backbone draws
    _, v = jax_model_and_traced_variables(conf, seed=5)
    model = port_model(conf, v)
    pconf = Config.from_dict(conf)
    train = port_step.build_train_step(model, port_step.create_train_state(pconf, model), pconf,
                                       seed=2)
    outs = [train(_batch(11 + i)) for i in range(steps)]
    return model, outs


def test_stochastic_depth_draws_from_the_step_generator_only():
    rates = [m.rate for m in _step(False, 0)[0].modules()
             if isinstance(m, blocks.Dropout) and m.per_sample]
    assert max(rates) > 0.1  # drop_connect_rate 0.2, grown with the block index
    global_state = torch.random.get_rng_state()
    model_a, (a,) = _step(False)
    model_b, (b,) = _step(False)
    assert torch.equal(torch.random.get_rng_state(), global_state)
    assert torch.equal(a["loss"], b["loss"])
    for p, q in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(p.grad, q.grad)


def test_remat_replays_the_stochastic_depth_masks():
    """Two steps each way: the recompute winds the generator back to its
    state before the first forward, and forward after it."""
    plain, plain_out = _step(False, 2)
    remat, remat_out = _step(True, 2)
    assert remat.remat and not plain.remat
    for a, b in zip(plain_out, remat_out):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["cm"], b["cm"])
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, a), b in zip(plain.named_buffers(), remat.buffers()):
        assert torch.equal(a, b), name


def test_export_reproduces_efficientnet(tmp_path):
    conf = {**conf_dict(64), "base_model": "efficientnetb0"}
    seg = SemanticSegmentation(conf, work_dir=str(tmp_path), device="cpu")
    paths = seg.convert_to_tf_lite()
    program = torch.export.load(paths[0])
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got = program.module()(x)
        ref = seg.model.eval()(x)
    assert tuple(got.shape) == (2, 64, 64, 21)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
