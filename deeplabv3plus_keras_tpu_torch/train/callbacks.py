"""Training callbacks (port of ``deeplabv3plus_keras_tpu/train/callbacks.py:16-83``).

The reference enables ``ReduceLROnPlateau(monitor='loss',
factor=reduce_lr_factor, patience=5, min_lr=1e-8)`` and best-val-loss
checkpointing (semantic_segmentation.py:978-986; the second is
train/checkpoint.py).  Both callbacks here return the new learning rate;
the epoch loop sets it on ``KerasAdam.lr``.
"""

from __future__ import annotations

import math


class ReduceLROnPlateau:
    """Keras semantics: if the monitored value hasn't improved for
    ``patience`` epochs, multiply LR by ``factor`` (not below min_lr)."""

    def __init__(
        self,
        factor: float,
        patience: int = 5,
        min_lr: float = 1e-8,
        min_delta: float = 1e-4,
    ):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.best = math.inf
        self.wait = 0

    def update(self, monitored: float, current_lr: float) -> float:
        """Returns the (possibly reduced) LR after this epoch."""
        if monitored < self.best - self.min_delta:
            self.best = monitored
            self.wait = 0
            return current_lr
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr


class LRSchedule:
    """Per-epoch learning-rate schedule (extra config key ``lr_schedule``).

    The reference sketches exactly this hook — a per-epoch exponential
    ``LearningRateScheduler`` (lr ← factor·lr each epoch) — but leaves it
    commented out (semantic_segmentation.py:992-998).  Enabled here, plus
    the DeepLab-paper "poly" policy:

    - ``{"type": "exponential", "factor": f}`` → lr_e = lr₀ · fᵉ
      (the reference's sketch; ``factor`` defaults to reduce_lr_factor)
    - ``{"type": "poly", "power": p, "end_lr": l}`` →
      lr_e = (lr₀ − l)·(1 − e/E)ᵖ + l over E = hps.epochs
      (power defaults to 0.9, end_lr to 0 — the DeepLabV3+ recipe,
      applied at epoch granularity)

    When set, the schedule replaces ReduceLROnPlateau (both mutate the
    same LR; the reference likewise comments one out to use the other).
    """

    def __init__(self, spec: dict, lr0: float, total_epochs: int,
                 default_factor: float = 0.99):
        kind = spec.get("type", "poly")
        if kind not in ("poly", "exponential"):
            raise ValueError(f"lr_schedule type {kind!r}: expected "
                             "'poly' or 'exponential'")
        self.kind = kind
        self.lr0 = float(lr0)
        self.total = max(int(total_epochs), 1)
        self.power = float(spec.get("power", 0.9))
        self.end_lr = float(spec.get("end_lr", 0.0))
        self.factor = float(spec.get("factor", default_factor))

    def lr(self, epoch: int) -> float:
        if self.kind == "exponential":
            return self.lr0 * self.factor**epoch
        frac = 1.0 - min(epoch, self.total - 1) / self.total
        return (self.lr0 - self.end_lr) * frac**self.power + self.end_lr
