"""Serving steps (port of the serving half of
``deeplabv3plus_keras_tpu/parallel/step.py:378-407``).

The JAX steps take ``(state, images)``; here the model module holds its
own weights, so a step takes the images alone.  Both run under
``torch.inference_mode()`` with the model in eval mode (BN on running
statistics, dropout off).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import upsample_argmax


def build_predict_step(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """images (B, S, S, 3) → softmax probabilities (B, S, S, classes)."""

    def predict_step(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(images)

    return predict_step


def build_label_step(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """images (B, S, S, 3) → class labels (B, S, S) int32.

    argmax∘softmax∘upsample ≡ argmax∘upsample, so labels come from the
    decoder's pre-upsample logits through the fused upsample+argmax kernel
    (``kernels/upsample_argmax``): the (B, S, S, C) probabilities never
    exist."""

    def label_step(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            logits, up = model(images, return_presample=True)
            return upsample_argmax(logits.contiguous(), up)

    return label_step
