"""Train, eval, predict and label steps (port of
``deeplabv3plus_keras_tpu/parallel/step.py:63-265, 305-407``).

The JAX steps are pure functions of ``(state, batch, rng)``.  Here the
model module holds the parameters and the BN running statistics, and the
optimizer (:class:`~..train.optimizer.KerasAdam`) holds the Adam moments
and the step count: together they are the training state, and a train
step updates them in place.

Batches are dicts with ``image`` (B, S, S, 3), ``label`` one-hot
(B, S, S, C) or integer (B, S, S), and ``valid`` (B,) 0/1, on the model's
device.  Loss = class-balanced loss + the Keras L2 of ``_l2`` kernels, in
both the train and the eval step, as Keras adds regularizer losses to
both.  Padded samples (``valid == 0``) count in neither the loss mean nor
the confusion matrix.

The eval, predict and label steps run under ``torch.inference_mode()`` in
eval mode (BN on running statistics, dropout off); the train step in
train mode (BN on batch statistics, dropout drawn from a generator seeded
from (seed, step)).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import Config
from ..kernels import upsample_argmax
from ..train.loss import (
    SS_NW,
    SS_PW,
    class_balanced_loss,
    class_balanced_loss_sparse,
    l2_penalty,
)
from ..train.metrics import confusion_matrix_update, confusion_matrix_update_sparse
from ..train.optimizer import KerasAdam, make_optimizer

# Extra config keys of the JAX steps that the port does not take yet, and
# where ROADMAP.md queues them.
_UNPORTED = {
    "augment": "on-device augmentation, ROADMAP.md Queue A item 9",
    "fused_tail": "the parity-decomposed loss tail, ROADMAP.md Queue A item 16",
    "eval_scales": "test-time augmentation, ROADMAP.md Queue A item 8",
    "eval_flip": "test-time augmentation, ROADMAP.md Queue A item 8",
}


def _refuse_unported(conf: Config, keys) -> None:
    for key in keys:
        if conf.extra.get(key):
            raise NotImplementedError(f"extra key {key!r} is not ported yet ({_UNPORTED[key]})")


def default_class_weights(num_classes: int):
    """The reference's 21-class VOC-Aug weights (semantic_segmentation.py:
    785-787); pw=1, nw=0 (plain cross-entropy) for other class counts."""
    if num_classes == len(SS_PW):
        return SS_PW, SS_NW
    return np.ones(num_classes, np.float32), np.zeros(num_classes, np.float32)


def resolve_class_weights(conf: Config):
    """The extra key ``class_weights_npz`` (an .npz with ``pw``/``nw``)
    overrides the defaults; None means "use default_class_weights"."""
    path = conf.extra.get("class_weights_npz")
    if not path:
        return None
    z = np.load(path)
    pw = np.asarray(z["pw"], np.float32)
    nw = np.asarray(z["nw"], np.float32)
    n = conf.nn_arch.num_classes
    if pw.shape != (n,) or nw.shape != (n,):
        raise ValueError(
            f"class_weights_npz arrays must have shape ({n},); got pw {pw.shape}, nw {nw.shape}"
        )
    return pw, nw


def create_train_state(conf: Config, model: torch.nn.Module) -> KerasAdam:
    """The optimizer over ``model``'s parameters.  With the model (weights
    and BN statistics) it is the whole training state: the JAX
    ``TrainState``'s step and Adam moments live in it."""
    return make_optimizer(model.parameters(), conf.hps)


def _loss_for(label, probs, pw, nw, valid):
    """One-hot (B,H,W,C) or integer (B,H,W) labels."""
    if label.dim() == probs.dim():
        return class_balanced_loss(label, probs, pw, nw, valid=valid)
    return class_balanced_loss_sparse(label, probs, pw, nw, valid=valid)


def _cm_for(label, probs, num_classes, valid):
    if label.dim() == probs.dim():
        return confusion_matrix_update(label, probs, num_classes, valid)
    return confusion_matrix_update_sparse(label, probs, num_classes, valid)


def step_generator(seed: int, step: int, device, microbatch: int | None = None) -> torch.Generator:
    """The dropout generator of one (micro)step, seeded from (seed, step[,
    microbatch]): the port's ``jax.random.fold_in(rng, step)``."""
    key = [int(seed), int(step)] + ([int(microbatch)] if microbatch is not None else [])
    state = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def build_train_step(model, optimizer: KerasAdam, conf: Config, class_weights=None,
                     seed: int = 0) -> Callable[[dict], dict]:
    """``train_step(batch) -> {"loss", "cm"}`` (device tensors; the loss is
    the class-balanced loss + L2, the cm int32).  One Keras-Adam update per
    call.  The extra key ``grad_accum`` N splits the batch into N
    sequential microbatches: gradients and losses are averaged, confusion
    matrices summed, and BN's running statistics move once per microbatch
    (each sees its microbatch's statistics), as in the JAX step.  The
    gradients of the last update stay in each parameter's ``.grad``."""
    _refuse_unported(conf, ("augment", "fused_tail"))
    wd = conf.hps.weight_decay
    num_classes = conf.nn_arch.num_classes
    pw, nw = class_weights or default_class_weights(num_classes)
    accum = max(1, int(conf.extra.get("grad_accum", 1)))

    def train_step(batch: dict) -> dict:
        model.train()
        image, label, valid = batch["image"], batch["label"], batch["valid"]
        B = image.shape[0]
        if B % accum:
            raise ValueError(f"grad_accum {accum} must divide batch size {B}")
        mb = B // accum
        step = optimizer.iterations
        optimizer.zero_grad()
        loss_sum, cm_sum = 0.0, 0
        for i in range(accum):
            part = slice(i * mb, (i + 1) * mb)
            gen = step_generator(seed, step, image.device, i if accum > 1 else None)
            probs = model(image[part], generator=gen)
            loss = _loss_for(label[part], probs, pw, nw, valid[part]) + l2_penalty(model, wd)
            loss.backward()
            with torch.no_grad():
                cm_sum = cm_sum + _cm_for(label[part], probs, num_classes, valid[part])
            loss_sum = loss_sum + loss.detach()
            del probs, loss
        # a parameter the loss does not reach (Xception's unused os-8
        # shortcut) gets a zero gradient, as jax.grad gives it
        for p in optimizer.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if accum > 1:
            torch._foreach_div_([p.grad for p in optimizer.params], float(accum))
        optimizer.step()
        return {"loss": loss_sum / accum, "cm": cm_sum}

    return train_step


def build_eval_step(model, conf: Config, class_weights=None,
                    with_probs: bool = True) -> Callable[[dict], dict]:
    """``eval_step(batch) -> {"loss", "cm"[, "probs"]}`` in eval mode.
    ``with_probs=False`` drops the (B, S, S, C) probabilities."""
    _refuse_unported(conf, ("eval_scales", "eval_flip", "fused_tail"))
    wd = conf.hps.weight_decay
    num_classes = conf.nn_arch.num_classes
    pw, nw = class_weights or default_class_weights(num_classes)

    def eval_step(batch: dict) -> dict:
        model.eval()
        with torch.inference_mode():
            probs = model(batch["image"])
            loss = _loss_for(batch["label"], probs, pw, nw, batch["valid"])
            out = {
                "loss": loss + l2_penalty(model, wd),
                "cm": _cm_for(batch["label"], probs, num_classes, batch["valid"]),
            }
            if with_probs:
                out["probs"] = probs
            return out

    return eval_step


def build_predict_step(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """images (B, S, S, 3) → softmax probabilities (B, S, S, classes)."""

    def predict_step(images: torch.Tensor) -> torch.Tensor:
        model.eval()
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
        model.eval()
        with torch.inference_mode():
            logits, up = model(images, return_presample=True)
            return upsample_argmax(logits.contiguous(), up)

    return label_step
