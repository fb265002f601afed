"""Keras-semantics Adam with iteration decay and a mutable learning rate
(port of ``deeplabv3plus_keras_tpu/train/optimizer.py:36-83``).

The reference compiles ``optimizers.Adam(lr, beta_1, beta_2, decay)``
(semantic_segmentation.py:477-480; conf.json: β₁=0.5, β₂=0.99) and lowers
the LR with ``ReduceLROnPlateau``.  Keras folds the bias correction into
the step size and applies ε to the *uncorrected* √v:

  lr_t = lr · 1/(1 + decay · iteration)        (iteration 0-based)
  α_t  = lr_t · √(1−β₂ᵗ)/(1−β₁ᵗ)              (t = iteration + 1)
  m ← β₁·m + (1−β₁)·g ;  v ← β₂·v + (1−β₂)·g²
  θ ← θ − α_t · m/(√v + ε),  ε = 1e-7

``torch.optim.Adam`` computes m̂/(√v̂ + ε) instead, which differs by about
2× where √v ≈ ε (small, near-converged gradients), so it is not used.
"""

from __future__ import annotations

import math

import torch

from ..config import HParams


class KerasAdam:
    """Keras Adam over ``params``; ``step()`` applies their ``.grad``.

    The moments live beside the parameters (same device and dtype) and
    are updated in place with ``torch._foreach`` ops, a few launches per
    step for all parameters.  ``iterations`` counts the updates made."""

    def __init__(self, params, lr: float, beta_1: float, beta_2: float,
                 decay: float = 0.0, epsilon: float = 1e-7):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.beta_1, self.beta_2 = float(lr), float(beta_1), float(beta_2)
        self.decay, self.epsilon = float(decay), float(epsilon)
        self.iterations = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        params = [p for p in self.params if p.grad is not None]
        if len(params) != len(self.params):
            raise RuntimeError(f"{len(self.params) - len(params)} parameters have no gradient")
        grads = [p.grad for p in params]
        b1, b2 = self.beta_1, self.beta_2
        t = self.iterations + 1
        alpha = math.sqrt(1.0 - b2**t) / (1.0 - b1**t)
        lr_t = self.lr / (1.0 + self.decay * self.iterations)
        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.v, b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.v)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_addcdiv_(params, self.m, denom, value=-lr_t * alpha)
        self.iterations = t


def make_optimizer(params, hps: HParams) -> KerasAdam:
    return KerasAdam(params, hps.lr, hps.beta_1, hps.beta_2, hps.decay, epsilon=1e-7)


def get_learning_rate(opt: KerasAdam) -> float:
    return opt.lr


def set_learning_rate(opt: KerasAdam, lr: float) -> KerasAdam:
    """Host-side LR override (the ReduceLROnPlateau port)."""
    opt.lr = float(lr)
    return opt
