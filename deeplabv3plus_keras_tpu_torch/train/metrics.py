"""Confusion matrix and streaming mean IoU (port of
``deeplabv3plus_keras_tpu/train/metrics.py:25-184``).

Reference ``MeanIoUExt`` (semantic_segmentation.py:283-334): argmax truth
and prediction, accumulate a confusion matrix, reduce with the Keras
MeanIoU formula: per-class IoU = diag / (rowsum + colsum − diag), averaged
over classes whose denominator is > 0.

The update counts ``t·C + p`` with ``torch.bincount`` (integer counts,
exact; the JAX package's one-hot matmul existed to avoid a serialized
scatter on the TPU).  Pixels of padded samples (``valid == 0``) go to an
overflow bin that is dropped, so no host sync selects them.  Counts are
int32 per batch; the host accumulator sums them in int64.
"""

from __future__ import annotations

import numpy as np
import torch


def _cm_count(t: torch.Tensor, p: torch.Tensor, num_classes: int, sample_valid) -> torch.Tensor:
    """cm[i, j] = #pixels with true i and predicted j, int32."""
    n = num_classes
    idx = t.long() * n + p.long()
    if sample_valid is not None:
        keep = sample_valid.reshape((-1,) + (1,) * (idx.dim() - 1)).to(idx.device) != 0
        idx = torch.where(keep, idx, n * n)  # the overflow bin
    counts = torch.bincount(idx.reshape(-1), minlength=n * n + 1)
    return counts[: n * n].reshape(n, n).to(torch.int32)


def confusion_matrix_update(y_true, y_pred, num_classes: int, sample_valid=None):
    """One batch's confusion matrix from one-hot (or probability) tensors
    (B, ..., C), both argmaxed over the last axis (first maximum on ties).
    ``sample_valid`` (B,) 0/1 leaves padded samples out."""
    return _cm_count(y_true.argmax(-1), y_pred.argmax(-1), num_classes, sample_valid)


def confusion_matrix_update_sparse(labels, y_pred, num_classes: int, sample_valid=None):
    """Integer labels (B, ...) against argmax(y_pred)."""
    return _cm_count(labels, y_pred.argmax(-1), num_classes, sample_valid)


def mean_iou_from_cm(cm: torch.Tensor) -> torch.Tensor:
    """Keras MeanIoU reduction: mean over classes with nonzero denominator."""
    cm = cm.to(torch.float64 if cm.dtype == torch.int64 else torch.float32)
    diag = torch.diagonal(cm)
    denom = cm.sum(0) + cm.sum(1) - diag
    valid = denom > 0
    iou = torch.where(valid, diag / torch.where(valid, denom, torch.ones_like(denom)), 0.0)
    return iou.sum() / torch.clamp(valid.sum(), min=1)


class MeanIoU:
    """Host-side streaming accumulator (API analogue of ``MeanIoUExt``).

    ``update_from_cm`` only keeps the device tensor, so a training loop
    never waits on a step's outputs; the int64 host sum (int32 would
    overflow within a VOC-Aug epoch) happens at ``result()``.
    ``accum_enable=False`` replaces instead of accumulating."""

    def __init__(self, num_classes: int, accum_enable: bool = True):
        self.num_classes = num_classes
        self.accum_enable = accum_enable
        self.reset()

    def reset(self):
        self._total_cm = np.zeros((self.num_classes, self.num_classes), np.int64)
        self._pending: list = []

    def update_state(self, y_true, y_pred):
        return self.update_from_cm(confusion_matrix_update(y_true, y_pred, self.num_classes))

    def update_from_cm(self, cm):
        if self.accum_enable:
            self._pending.append(cm)
        else:
            self._pending = [cm]
            self._total_cm[:] = 0
        return self

    @property
    def total_cm(self) -> np.ndarray:
        for cm in self._pending:
            c = cm.cpu().numpy() if isinstance(cm, torch.Tensor) else np.asarray(cm)
            self._total_cm += c.astype(np.int64)
        self._pending = []
        return self._total_cm

    def per_class_iou(self) -> np.ndarray:
        """Per-class IoU (NaN for classes never seen in truth or prediction)."""
        cm = self.total_cm.astype(np.float64)
        diag = np.diagonal(cm)
        denom = cm.sum(axis=0) + cm.sum(axis=1) - diag
        valid = denom > 0
        return np.where(valid, diag / np.where(valid, denom, 1.0), np.nan)

    def result(self) -> float:
        iou = self.per_class_iou()
        seen = ~np.isnan(iou)
        return float(iou[seen].mean()) if seen.any() else 0.0

    def report(self, class_names=None) -> str:
        """Readable per-class IoU table + mean (one line per class)."""
        iou = self.per_class_iou()
        names = class_names or [str(i) for i in range(self.num_classes)]
        width = max(len(str(n)) for n in names)
        lines = [
            f"  {str(names[i]):<{width}}  {'  n/a' if np.isnan(v) else f'{v:.4f}'}"
            for i, v in enumerate(iou)
        ]
        lines.append(f"  {'mean':<{width}}  {self.result():.4f}")
        return "\n".join(lines)
