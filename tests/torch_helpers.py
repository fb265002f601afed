"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

Weights are made with numpy from a seed and handed to both stacks: the JAX
package's init gives the tree's structure, then every leaf is redrawn so
that activations stay O(1) through the network (glorot init with identity
BN shrinks them by ~C/2 at every depthwise layer, and parity at 1e-8
scale would test little).
"""

from __future__ import annotations

import copy

import numpy as np

FLAGSHIP_MIDDLE = [
    {"op": "conv", "kernel": 3, "rate": [1, 1], "input": -1},
    {"op": "conv", "kernel": 3, "rate": [18, 15], "input": 0},
    {"op": "conv", "kernel": 3, "rate": [6, 3], "input": 1},
    {"op": "conv", "kernel": 3, "rate": [1, 1], "input": 0},
    {"op": "conv", "kernel": 3, "rate": [6, 21], "input": 0},
]
PYRAMID = {"op": "pyramid_pooling", "kernel": 2, "input": 0, "target_size_factor": [2, 2]}
# The reference's Xception ASPP (bench.py:58-74, tests/test_sharding.py:103).
XCEPTION_MIDDLE = [
    {"op": "conv", "kernel": 3, "rate": [1, 1], "input": -1},
    {"op": "conv", "kernel": 3, "rate": [6, 6], "input": 0},
    {"op": "conv", "kernel": 3, "rate": [12, 12], "input": 0},
    {"op": "conv", "kernel": 3, "rate": [18, 18], "input": 0},
    {"op": "pyramid_pooling", "kernel": 1, "input": 0, "target_size_factor": [1, 1]},
]


def conf_dict(image_size=64, output_stride=16, refine=True, pyramid=False, **extra):
    """The flagship configuration (MobileNetV2, 21 classes), at a test size."""
    middle = copy.deepcopy(FLAGSHIP_MIDDLE) + ([dict(PYRAMID)] if pyramid else [])
    d = {
        "base_model": "mobilenetv2",
        "hps": {"dtype": "float32", "batch_size": 2, "bn_momentum": 0.9, "bn_scale": True},
        "nn_arch": {
            "boundary_refinement": refine,
            "output_stride": output_stride,
            "image_size": image_size,
            "num_classes": 21,
            "encoder_middle_conf": middle,
        },
    }
    d.update(extra)
    return d


def xception_conf_dict(image_size=64, output_stride=16, **extra):
    """Xception + the reference's Xception ASPP, otherwise the flagship's."""
    d = conf_dict(image_size, output_stride, **extra)
    d["base_model"] = "xception"
    d["nn_arch"]["encoder_middle_conf"] = copy.deepcopy(XCEPTION_MIDDLE)
    return d


def _redraw(tree, rng, path=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _redraw(v, rng, path + (k,))
            continue
        shape = np.shape(v)
        if k == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            # He scale; a 5x smaller classifier keeps logits at a few units
            gain = 0.2 if "classifier_l2" in path else 1.0
            val = rng.normal(0.0, gain * np.sqrt(2.0 / fan_in), shape)
        elif k in ("scale", "var", "normalization_var"):
            val = rng.uniform(0.6, 1.4, shape)
        else:  # bias, mean
            val = rng.normal(0.0, 0.2, shape)
        out[k] = val.astype(np.float32)
    return out


def jax_model_and_variables(conf: dict, seed: int = 0):
    """(flax model, numpy variable tree) for ``conf``, weights from ``seed``."""
    import jax

    from deeplabv3plus_keras_tpu.config import Config
    from deeplabv3plus_keras_tpu.models import init_model

    model, variables = init_model(Config.from_dict(conf), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return model, {c: _redraw(variables[c], rng) for c in ("params", "batch_stats")}


def port_model(conf: dict, variables):
    """The port's model on the CPU, eval mode, weights from ``variables``."""
    import torch

    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.models import DeepLabV3Plus
    from deeplabv3plus_keras_tpu_torch.utils.jax_weights import load_jax_variables

    model = DeepLabV3Plus(Config.from_dict(conf))
    load_jax_variables(model, variables)
    return model.to(memory_format=torch.channels_last).eval()


def calibrate_bn(module, *args, **kwargs):
    """Set every BN's running statistics of the port's ``module`` to one
    batch's (a train-mode forward with Keras momentum 0), then eval mode.
    Random weights through Xception's residual stacks otherwise grow the
    activations by orders of magnitude; this keeps them O(1)."""
    import torch

    from deeplabv3plus_keras_tpu_torch.models.blocks import BatchNorm

    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    module.train()
    with torch.no_grad():
        module(*args, **kwargs)
    module.eval()
    for m, mom in zip(bns, saved):
        m.momentum = mom


def jax_model_and_traced_variables(conf: dict, seed: int = 0):
    """As :func:`jax_model_and_variables`, with the tree's shapes from
    ``jax.eval_shape`` of the init instead of running it op by op (seconds
    instead of tens of seconds at 64²).  The leaves are drawn in the sorted
    key order of a traced tree, so the weights differ from that function's
    for the same seed."""
    import jax
    import jax.numpy as jnp

    from deeplabv3plus_keras_tpu.config import Config
    from deeplabv3plus_keras_tpu.models.deeplab import create_model

    config = Config.from_dict(conf)
    model = create_model(config)
    size = config.nn_arch.image_size
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return model, {c: _redraw(variables[c], rng) for c in ("params", "batch_stats")}


def strict_jit(fn, *args):
    """``fn`` compiled by XLA without its excess-precision liberty
    (``xla_allow_excess_precision`` off), so that a bfloat16/float16
    computation rounds after every operation, as its jaxpr says; by default
    XLA keeps float32 intermediates inside a fusion."""
    import jax

    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
