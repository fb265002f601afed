"""Parity-decomposed training tail: ×2 upsample → softmax → loss and
confusion matrix without a full-resolution tensor (port of
``deeplabv3plus_keras_tpu/ops/parity_tail.py:49-126``, extra key
``fused_tail``).

Under boundary refinement the decoder's last upsample is ×2 (reference
semantic_segmentation.py:899-902), and the half-pixel bilinear ×2 along one
axis is a fixed 2-tap lerp per output parity:

    up[2k]   = 0.25·x[k−1] + 0.75·x[k]      (x[−1] ≡ x[0])
    up[2k+1] = 0.75·x[k]   + 0.25·x[k+1]    (x[H]  ≡ x[H−1])

so the full-resolution grid splits into four half-resolution parity
planes, each a 4-tap lerp of the logits.  The loss and the confusion matrix
are sums over pixels, hence sums over the planes; the mean divides by the
full-resolution pixel count.

On the CPU :func:`tail_loss_cm` computes the planes in PyTorch (the plain
version, also the tests' reference).  On a CUDA tensor it launches the
fused kernels T1/T2 (``kernels/parity_tail.py``), which never hold a plane
either: eager PyTorch would materialise every shift, lerp, softmax and log
of the planes, and autograd would keep them.
"""

from __future__ import annotations

import torch

from ..kernels import parity_tail as _kernel
from ..models.decoder import softmax
from ..train.loss import masked_pixel_mean, per_pixel_loss_dense, per_pixel_loss_sparse
from ..train.metrics import confusion_matrix_update, confusion_matrix_update_sparse


def _shift_prev(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x[k−1] along ``dim``, x[−1] ≡ x[0]."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)


def _shift_next(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x[k+1] along ``dim``, x[n] ≡ x[n−1]."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def upsample2_parities(x: torch.Tensor):
    """The four parity planes of ``tf_resize_images(x, 2, 2)``.

    x: (B, H, W, C).  ``planes[ph][pw]`` equals
    ``tf_resize_images(x, 2, 2)[:, ph::2, pw::2, :]`` (each (B, H, W, C)) to
    float rounding; in the input's dtype, rounded after every operation, as
    the JAX function."""
    e_h = 0.25 * _shift_prev(x, 1) + 0.75 * x
    o_h = 0.75 * x + 0.25 * _shift_next(x, 1)
    planes = []
    for base in (e_h, o_h):
        e_w = 0.25 * _shift_prev(base, 2) + 0.75 * base
        o_w = 0.75 * base + 0.25 * _shift_next(base, 2)
        planes.append((e_w, o_w))
    return planes


def tail_per_pixel(logits, label, pos_weights, neg_weights, num_classes: int, valid=None,
                   epsilon: float = 1e-7):
    """(per-pixel loss summed over the four parities, (B, H, W) in ≥ float32;
    confusion matrix (C, C) int32) of the ×2-upsampled softmax, in PyTorch.

    label: one-hot (B, 2H, 2W, C) or integer (B, 2H, 2W); each parity plane
    takes the matching strided slice.  argmax∘softmax ≡ argmax, so the
    confusion matrix argmaxes the parity logits (first maximum on ties);
    samples with ``valid == 0`` count in it nowhere."""
    dense = label.dim() == logits.dim()
    per_pixel, cm = None, 0
    for ph, row in enumerate(upsample2_parities(logits)):
        for pw_, u in enumerate(row):
            lab = label[:, ph::2, pw_::2]
            probs = softmax(u, dim=-1)
            with torch.no_grad():
                if dense:
                    cm = cm + confusion_matrix_update(lab, u, num_classes, valid)
                else:
                    cm = cm + confusion_matrix_update_sparse(lab, u, num_classes, valid)
            loss_fn = per_pixel_loss_dense if dense else per_pixel_loss_sparse
            pp = loss_fn(lab, probs, pos_weights, neg_weights, epsilon)
            per_pixel = pp if per_pixel is None else per_pixel + pp
    return per_pixel, cm


def tail_loss_cm(logits, label, pos_weights, neg_weights, num_classes: int, valid=None,
                 epsilon: float = 1e-7, n_valid=None):
    """(loss, cm) of the ×2-upsampled softmax output, parity-decomposed.

    Equals, to float reassociation::

        probs = softmax(tf_resize_images(logits, 2, 2))
        loss  = class_balanced_loss(label, probs, pw, nw, valid=valid)
        cm    = confusion_matrix_update(label, probs, num_classes, valid)

    logits: (B, H, W, C), the decoder's half-resolution output; label
    one-hot (B, 2H, 2W, C) or integer (B, 2H, 2W).  ``n_valid``: the global
    count of valid samples under a process group
    (``train/loss.py`` ``masked_pixel_mean``).  A CPU tensor takes the plain
    version (:func:`tail_per_pixel`); a CUDA tensor launches T1 and, in the
    backward, T2 (``kernels/parity_tail.py``), or raises."""
    if logits.device.type == "cpu":
        per_pixel, cm = tail_per_pixel(logits, label, pos_weights, neg_weights, num_classes,
                                       valid, epsilon)
    else:
        per_pixel, cm = _kernel.parity_tail_sums(logits, label, pos_weights, neg_weights,
                                                 num_classes, valid, epsilon)
    h, w = logits.shape[1], logits.shape[2]
    loss = masked_pixel_mean(per_pixel, valid, n_valid, total_pixels_per_sample=4 * h * w)
    return loss, cm
