"""The port's test-time augmentation (extra keys ``eval_scales`` and
``eval_flip``) against the JAX package's ``build_eval_step``."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.parallel.step import build_eval_step as jax_build_eval_step
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.parallel.step import build_eval_step

from torch_helpers import conf_dict, jax_model_and_variables, port_model

torch.set_num_threads(1)
SIZE = 64


def test_tta_eval_probs_match_jax():
    """eval_scales [0.75, 1.0, 1.25] + eval_flip: the averaged probabilities
    within 1e-5 of the JAX package's build_eval_step, whose scales below 1
    resize with an antialiasing filter."""
    conf = conf_dict(SIZE)
    jm, v = jax_model_and_variables(conf, seed=31)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.integers(0, 21, (2, SIZE, SIZE)).astype(np.int32)
    valid = np.array([1, 1], np.int32)
    scales = [0.75, 1.0, 1.25]

    class State:  # what the JAX step reads of its TrainState
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        batch_stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])

    jstep = jax_build_eval_step(jm, JaxConfig.from_dict(conf), tta_scales=scales, tta_flip=True)
    ref = jstep(State, {"image": jnp.asarray(x), "label": jnp.asarray(y), "valid": jnp.asarray(valid)})
    pstep = build_eval_step(port_model(conf, v), Config.from_dict(conf), tta_scales=scales,
                            tta_flip=True)
    got = pstep({"image": torch.from_numpy(x), "label": torch.from_numpy(y),
                 "valid": torch.from_numpy(valid)})
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(ref["probs"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-5)
    assert np.abs(got["cm"].numpy() - np.asarray(ref["cm"])).sum() <= 2 * 1e-3 * y.size
