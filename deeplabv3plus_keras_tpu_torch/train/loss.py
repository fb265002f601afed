"""Class-balanced per-pixel loss and Keras L2 (port of
``deeplabv3plus_keras_tpu/train/loss.py:27-152``).

The loss is a per-class weighted binary cross-entropy over softmax
probabilities, summed over classes and mean-reduced over batch and pixels:

    L = mean_{b,h,w}  Σ_i −[ pw_i · y_i · log(ŷ_i + ε)
                           + nw_i · (1 − y_i) · log(1 − ŷ_i + ε) ]

with ε = 1e-7, accumulated in at least float32.  Keras
``kernel_regularizer=l2(wd)`` adds ``wd · Σ‖W‖²`` for the conv kernels of
modules whose name carries ``_l2``; the port's module names follow the
flax tree, so the JAX rule carries over.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# Per-class positive/negative pixel-frequency weights over Pascal VOC 2012
# Aug (21 classes), hard-coded by the reference (semantic_segmentation.py:
# 120-127).  pw = 1 − freq(class), nw = freq(class).
SS_PW = np.array([
    0.29754999, 0.99106889, 0.99236374, 0.99122957, 0.99350396, 0.99455487,
    0.98728424, 0.98090446, 0.96883489, 0.98753125, 0.99376389, 0.98942612,
    0.97222875, 0.99080578, 0.98845309, 0.92606652, 0.99393374, 0.99374322,
    0.98782171, 0.98659656, 0.99233476,
], dtype=np.float32)
SS_NW = (1.0 - SS_PW).astype(np.float32)


def _acc_dtype(y_pred: torch.Tensor) -> torch.dtype:
    """≥ float32: bf16/f16 probabilities promote, float64 stays."""
    return torch.promote_types(y_pred.dtype, torch.float32)


def _weights(w, dt, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(w), device=device).to(dt)


def per_pixel_loss_dense(y_true, y_pred, pos_weights, neg_weights, epsilon=1e-7):
    """The (B, H, W) per-pixel loss of one-hot labels (B, H, W, C)."""
    dt = _acc_dtype(y_pred)
    pw = _weights(pos_weights, dt, y_pred.device)
    nw = _weights(neg_weights, dt, y_pred.device)
    y_true = y_true.to(dt)
    y_pred = y_pred.to(dt)
    per_class = -(
        pw * y_true * torch.log(y_pred + epsilon)
        + nw * (1.0 - y_true) * torch.log(1.0 - y_pred + epsilon)
    )
    return per_class.sum(-1)


def per_pixel_loss_sparse(labels, y_pred, pos_weights, neg_weights, epsilon=1e-7):
    """The (B, H, W) per-pixel loss of integer labels (B, H, W): with t the
    true class, −[pw_t·log(p_t+ε) + Σ_i nw_i·log(1−p_i+ε) − nw_t·log(1−p_t+ε)]."""
    dt = _acc_dtype(y_pred)
    pw = _weights(pos_weights, dt, y_pred.device)
    nw = _weights(neg_weights, dt, y_pred.device)
    p = y_pred.to(dt)
    t = labels.long()
    neg_sum = torch.log(1.0 - p + epsilon) @ nw  # Σ_i nw_i·log(1−p_i+ε)
    p_t = p.gather(-1, t[..., None])[..., 0]
    log1m_t = torch.log(1.0 - p_t + epsilon)
    return -(pw[t] * torch.log(p_t + epsilon) + neg_sum - nw[t] * log1m_t)


def masked_pixel_mean(per_pixel, valid):
    """Mean of per-pixel losses over valid samples (``valid`` (B,) 0/1, or
    None for all)."""
    n_pix = per_pixel[0].numel()
    if valid is None:
        return per_pixel.sum() / (per_pixel.shape[0] * n_pix)
    v = valid.to(per_pixel.dtype).reshape((-1,) + (1,) * (per_pixel.dim() - 1))
    denom = torch.clamp(v.sum() * n_pix, min=1.0)
    return (per_pixel * v).sum() / denom


def class_balanced_loss(y_true, y_pred, pos_weights=SS_PW, neg_weights=SS_NW,
                        epsilon: float = 1e-7, valid=None):
    """Weighted per-class BCE of one-hot ``y_true`` and probabilities
    ``y_pred`` (both (B, H, W, C)), summed over classes, mean over the rest
    (over valid samples only when ``valid`` (B,) is given)."""
    per_pixel = per_pixel_loss_dense(y_true, y_pred, pos_weights, neg_weights, epsilon)
    if valid is None:
        return per_pixel.mean()
    return masked_pixel_mean(per_pixel, valid)


def class_balanced_loss_sparse(labels, y_pred, pos_weights=SS_PW, neg_weights=SS_NW,
                               epsilon: float = 1e-7, valid=None):
    """:func:`class_balanced_loss` of integer labels (B, H, W): the same
    value without a (B, H, W, C) one-hot tensor."""
    per_pixel = per_pixel_loss_sparse(labels, y_pred, pos_weights, neg_weights, epsilon)
    if valid is None:
        return per_pixel.mean()
    return masked_pixel_mean(per_pixel, valid)


def l2_penalty(model: nn.Module, weight_decay: float):
    """``wd · Σ‖W‖²`` over the parameters whose path has a ``_l2`` part."""
    if weight_decay == 0.0:
        return 0.0
    total = 0.0
    for name, p in model.named_parameters():
        if any("_l2" in part for part in name.split(".")):
            total = total + p.to(_acc_dtype(p)).square().sum()
    return weight_decay * total
