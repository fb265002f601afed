"""Gradient sanity of the port: overfitting one tiny batch must drive the
class-balanced loss down.  The port's counterpart of tests/test_convergence.py
with that test's configuration (MobileNetV2 at 32², boundary refinement,
reduction and concat width 16, the two-op middle, dropout 0, lr 3e-3, B = 2,
the constant label 3, 40 steps), through the facade's ``train_step()`` on
the CPU from the facade's own initial weights, in float32 and in bfloat16
(``hps.dtype``: bfloat16 compute, float32 parameters).  A fault anywhere in
backbone, encoder, decoder, loss or optimizer that breaks the gradient
leaves the loss where it started.
"""

import numpy as np
import pytest
import torch

from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

torch.set_num_threads(1)

SIZE, BATCH, STEPS, LABEL = 32, 2, 40, 3


def _conf(dtype: str) -> dict:
    return {
        "base_model": "mobilenetv2",
        "hps": {"dtype": dtype, "batch_size": BATCH, "lr": 3e-3},
        "nn_arch": {
            "image_size": SIZE,
            "boundary_refinement": True,
            "reduction_size": 16,
            "concat_channels": 16,
            "dropout_rate": 0.0,
            "encoder_middle_conf": [
                {"op": "conv", "kernel": 3, "rate": [1, 1], "input": -1},
                {"op": "conv", "kernel": 1, "input": 0},
            ],
        },
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overfit_tiny_batch(dtype):
    seg = SemanticSegmentation(_conf(dtype), device="cpu")
    rng = np.random.default_rng(0)
    batch = {
        "image": rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32),
        # a constant label: trivially learnable, so the loss must crater
        "label": np.eye(21, dtype=np.float32)[np.full((BATCH, SIZE, SIZE), LABEL)],
        "valid": np.ones(BATCH, np.int32),
    }
    losses = [float(seg.train_step(batch)["loss"]) for _ in range(STEPS)]
    assert np.isfinite(losses[-1]), losses
    assert losses[-1] < 0.3 * losses[0], losses
