"""bfloat16 training on the port reaches float32's trained quality.

The port's counterpart of tests/test_bf16_quality.py: the recipe of
tests/test_torch_accuracy_parity.py (its configuration, seed k's weights
from the JAX package's ``init_model``, the batch stream of rng 11 + 1000k,
the held-out set, batch-statistics evals at the 5 checkpoints 25 steps
apart) trained twice on the port, once with ``hps.dtype`` float32 and once
with bfloat16 (bfloat16 compute, float32 parameters, BN statistics and Adam
moments: both runs start from the same weights).  bfloat16's mean over
seeds must reach 0.15 (3× chance) and land within 0.05 of float32's, the
band of the JAX suites (bfloat16 rounding perturbs the chaotic β₁ = 0.5
Adam trajectory as a change of framework does).

Seeds: ``DLV3_TORCH_BF16_QUALITY_SEEDS`` (default 3; seed 0 is the JAX
test's one seed), steps ``DLV3_TORCH_BF16_QUALITY_STEPS`` (default 250).
The band is the JAX parity suite's, set for the mean of 15 evals a side
(its docstring); one seed gives 5, and its two runs part chaotically: at
seed 0 alone the port's float32 scored 0.1824 and its bfloat16 0.2387
(|Δ| 0.056, bfloat16 the higher); over the three seeds 0.1946 and 0.2146
(|Δ| 0.020), as chip_smoke.py's ``parity_conf`` arm on an H100 lands its
three seeds within 0.01.  Port against port, so it lives in the slow suite.
"""

import os

import numpy as np
import pytest
import torch

import jax

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.models import init_model
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.models import DeepLabV3Plus
from deeplabv3plus_keras_tpu_torch.parallel import step as port_step
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import load_jax_variables

from synthetic_task import checkpoint_steps, make_batch, miou, np_cm
from torch_helpers import accuracy_conf_dict, batch_stats_probs

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

N_STEPS = int(os.environ.get("DLV3_TORCH_BF16_QUALITY_STEPS", "250"))
N_SEEDS = int(os.environ.get("DLV3_TORCH_BF16_QUALITY_SEEDS", "3"))
BATCH, SIZE, CLASSES = 4, 96, 21
N_EVAL_BATCHES, N_CHECKPOINTS, EVAL_EVERY = 4, 5, 25
BAND = 0.05


def _train_and_score(dtype: str, seed: int, variables, held_out) -> list:
    conf = Config.from_dict(accuracy_conf_dict(dtype))
    model = DeepLabV3Plus(conf)
    load_jax_variables(model, variables)
    model = model.to(memory_format=torch.channels_last)
    train_step = port_step.build_train_step(model, port_step.create_train_state(conf, model),
                                            conf)
    eye = np.eye(CLASSES, dtype=np.float32)
    rng = np.random.default_rng(11 + 1000 * seed)
    eval_at = checkpoint_steps(N_STEPS, N_CHECKPOINTS, EVAL_EVERY)
    mious = []
    for i in range(N_STEPS):
        x, lab = make_batch(rng, BATCH, SIZE)
        out = train_step({"image": torch.from_numpy(x), "label": torch.from_numpy(eye[lab]),
                          "valid": torch.ones(BATCH, dtype=torch.int32)})
        assert torch.isfinite(out["loss"]), (dtype, i)
        if i in eval_at:
            cm = np.zeros((CLASSES, CLASSES), np.int64)
            for xe, le in held_out:
                cm += np_cm(le, batch_stats_probs(model, torch.from_numpy(xe)).argmax(-1).numpy())
            mious.append(miou(cm))
    return mious


def test_bf16_training_reaches_fp32_quality():
    held_out = [make_batch(np.random.default_rng(1000 + i), BATCH, SIZE)
                for i in range(N_EVAL_BATCHES)]
    scores = {"float32": [], "bfloat16": []}
    for seed in range(N_SEEDS):
        _, variables = init_model(JaxConfig.from_dict(accuracy_conf_dict()),
                                  jax.random.PRNGKey(seed))
        variables = jax.device_get(variables)
        for dtype, seed_scores in scores.items():
            marks = _train_and_score(dtype, seed, variables, held_out)
            seed_scores.append(float(np.mean(marks)))
            print(f"seed {seed} {dtype} {seed_scores[-1]:.4f} {np.round(marks, 3)}", flush=True)
    s_fp32, s_bf16 = float(np.mean(scores["float32"])), float(np.mean(scores["bfloat16"]))
    print(f"fp32 {s_fp32:.4f} bf16 {s_bf16:.4f} |delta| {abs(s_bf16 - s_fp32):.4f}", flush=True)
    assert s_bf16 >= 0.15, scores
    assert abs(s_bf16 - s_fp32) <= BAND, scores
