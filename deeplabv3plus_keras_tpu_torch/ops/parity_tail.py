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

Under ``mesh_space`` (``parallel/spatial.py``) a rank holds some rows of
the logits: it fetches one row above and one below (edge-clamped: the
upsample's clamp at the image's true edges), computes its own sites alone
on that row window (``window``: the first and last rows are context), takes
the label rows of its sites from the whole labels, and returns its share of
the loss over the global pixel count; the fetch's transpose returns the
context rows' gradients to their owners.

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
from ..parallel import mesh, spatial
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
                   epsilon: float = 1e-7, window: bool = False):
    """(per-pixel loss summed over the four parities, (B, H, W) in ≥ float32;
    confusion matrix (C, C) int32) of the ×2-upsampled softmax, in PyTorch.

    label: one-hot (B, 2H, 2W, C) or integer (B, 2H, 2W); each parity plane
    takes the matching strided slice.  argmax∘softmax ≡ argmax, so the
    confusion matrix argmaxes the parity logits (first maximum on ties);
    samples with ``valid == 0`` count in it nowhere.  ``window``: the
    logits' first and last rows are context only, the sites of rows 1 ..
    H − 2 are computed (loss (B, H − 2, W)) and ``label`` holds their
    2(H − 2) rows; the context rows still take their share of the
    gradient."""
    dense = label.dim() == logits.dim()
    per_pixel, cm = None, 0
    for ph, row in enumerate(upsample2_parities(logits)):
        for pw_, u in enumerate(row):
            if window:
                u = u[:, 1:-1]
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
    backward, T2 (``kernels/parity_tail.py``), or raises.

    Under ``mesh_space`` logits are this rank's rows of the global map and
    label the whole labels; the result is this rank's share of the loss
    and its sites' matrix (:func:`_own_sites`), which the step sums over
    the ranks."""
    h, w = logits.shape[1], logits.shape[2]
    window = spatial.active() is not None
    if window:
        logits, label, h = _own_sites(logits, label)
    if logits.shape[1] == 0:  # a rank with no sites: nothing of its own
        per_pixel = logits.new_zeros(logits.shape[0]) + logits.sum()
        cm = torch.zeros(num_classes, num_classes, dtype=torch.int32, device=logits.device)
    elif logits.device.type == "cpu":
        per_pixel, cm = tail_per_pixel(logits, label, pos_weights, neg_weights, num_classes,
                                       valid, epsilon, window)
    else:
        per_pixel, cm = _kernel.parity_tail_sums(logits, label, pos_weights, neg_weights,
                                                 num_classes, valid, epsilon, window)
    loss = masked_pixel_mean(per_pixel, valid, n_valid, total_pixels_per_sample=4 * h * w)
    return loss, cm


def _own_sites(logits, label):
    """(this rank's logits sites [a, b) = ``rows_of(h)`` with a context row
    above and below, fetched and clamped at the image's edges; the label
    rows [2a, 2b) of those sites, which follow the logits and not
    ``rows_of(2h)``; the global h).  A rank with no sites gets the empty
    block its (empty) request fetched, joined to its logits in the graph,
    so that its backward enters the fetch's transpose."""
    grid = spatial.active()
    x = logits.permute(0, 3, 1, 2)  # NHWC → the NCHW view spatial takes
    h = spatial.global_height(x)
    spans = [mesh.rows_of(h, grid.n_space, q) for q in range(grid.n_space)]
    block = spatial.fetch_rows(x, [a - 1 if a < b else 0 for a, b in spans],
                               [b + 1 if a < b else 0 for a, b in spans], h, edge="clamp")
    a, b = spans[grid.s]
    return block.permute(0, 2, 3, 1), label[:, 2 * a:2 * b], h
