"""The training step in plain PyTorch: the class-balanced loss, Keras L2
and Keras-semantics Adam.

Loss (the Keras reference's): a per-class weighted binary cross-entropy
over the softmax probabilities, summed over classes and averaged over the
pixels of the valid samples,

    L = mean  Σ_i −[pw_i·y_i·log(p_i + 1e-7) + nw_i·(1 − y_i)·log(1 − p_i + 1e-7)]

with pw = 1 − f and nw = f, f the class frequencies of VOC 2012 Aug;
plus wd·Σ‖W‖² over the kernels whose path has an ``_l2`` part.

Dropout: step t (counted from 0) draws its mask from a torch generator
seeded with ``numpy.random.SeedSequence([seed, t]).generate_state(1,
uint64)[0]``, the deployment's stream (seed 1024, the Keras reference's,
folded with the step as ``jax.random.fold_in`` folds it); the
configuration file states the seed.

Keras Adam (epsilon 1e-7 on the uncorrected √v, the bias correction
folded into the step size):

    m ← β₁m + (1 − β₁)g;  v ← β₂v + (1 − β₂)g²
    θ ← θ − lr/(1 + decay·(t − 1)) · √(1 − β₂ᵗ)/(1 − β₁ᵗ) · m/(√v + ε)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import model as ref

# VOC 2012 Aug class frequencies' complements (the Keras reference's
# hard-coded positive weights); the negative weights are 1 − these.
VOC_PW = np.array([
    0.29754999, 0.99106889, 0.99236374, 0.99122957, 0.99350396, 0.99455487,
    0.98728424, 0.98090446, 0.96883489, 0.98753125, 0.99376389, 0.98942612,
    0.97222875, 0.99080578, 0.98845309, 0.92606652, 0.99393374, 0.99374322,
    0.98782171, 0.98659656, 0.99233476,
], dtype=np.float32)
EPS = 1e-7


def class_weights(num_classes: int):
    if num_classes == len(VOC_PW):
        return VOC_PW, (1.0 - VOC_PW).astype(np.float32)
    return np.ones(num_classes, np.float32), np.zeros(num_classes, np.float32)


def loss(arch: ref.Arch, params: dict, stats: dict | None, images, onehot, valid,
         weight_decay: float, generator: torch.Generator | None = None):
    """Class-balanced loss + L2 of one batch, BN in training mode; and the
    probabilities."""
    probs = ref.probabilities(ref.Run(params, train=True, stats=stats, generator=generator),
                              arch, images)
    pw, nw = (torch.as_tensor(w, device=images.device) for w in class_weights(arch.num_classes))
    per_pixel = -(pw * onehot * torch.log(probs + EPS)
                  + nw * (1.0 - onehot) * torch.log(1.0 - probs + EPS)).sum(-1)
    v = valid.to(per_pixel.dtype)
    n_pix = per_pixel[0].numel()
    data = (per_pixel * v[:, None, None]).sum() / torch.clamp(v.sum() * n_pix, min=1.0)
    l2 = sum(params[n].square().sum() for n in params if ref.is_l2(n) and ref.is_trainable(n))
    return data + weight_decay * l2, probs


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """Step ``step``'s dropout stream (module docstring)."""
    state = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


class KerasAdam:
    """Adam over the trainable tensors of ``params`` (a dict), Keras
    semantics."""

    def __init__(self, names, lr, beta_1, beta_2, decay=0.0, epsilon=1e-7, params=None):
        self.names = list(names)
        self.lr, self.b1, self.b2, self.decay, self.eps = lr, beta_1, beta_2, decay, epsilon
        self.t = 0
        self.m = {n: torch.zeros_like(params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(params[n]) for n in self.names}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        lr_t = self.lr / (1.0 + self.decay * self.t)
        self.t += 1
        alpha = lr_t * math.sqrt(1.0 - self.b2 ** self.t) / (1.0 - self.b1 ** self.t)
        for n in self.names:
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            params[n].sub_(alpha * self.m[n] / (self.v[n].sqrt() + self.eps))


class Trainer:
    """The training step over ``params`` (updated in place, running
    statistics too): loss, gradient, Keras Adam, the statistics moved."""

    def __init__(self, arch: ref.Arch, hps: dict, params: dict, dropout_seed: int):
        self.arch, self.params, self.dropout_seed = arch, params, int(dropout_seed)
        self.wd = float(hps["weight_decay"])
        self.names = [n for n in params if ref.is_trainable(n)]
        for n in self.names:
            params[n].requires_grad_(False)
        self.opt = KerasAdam(self.names, float(hps["lr"]), float(hps["beta_1"]),
                             float(hps["beta_2"]), float(hps["decay"]), params=params)

    def step(self, images, onehot, valid):
        """One step on (images, one-hot, valid); returns (the loss, the
        probabilities), both detached."""
        params, names = self.params, self.names
        gen = dropout_generator(self.dropout_seed, self.opt.t, images.device)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        stats = {}
        value, probs = loss(self.arch, dict(params, **leaves), stats, images, onehot, valid,
                            self.wd, gen)
        grads = torch.autograd.grad(value, [leaves[n] for n in names])
        self.opt.step(params, dict(zip(names, grads)))
        del grads
        with torch.no_grad():
            for k, v in stats.items():
                params[k].copy_(v)
        return value.detach(), probs.detach()

    def first_moment(self) -> dict:
        """The gradient as Adam's first moment holds it after one step."""
        return {n: self.opt.m[n] / (1.0 - self.opt.b1) for n in self.names}


def train_steps(arch: ref.Arch, hps: dict, params: dict, batches, dropout_seed: int):
    """Train ``params`` in place on each batch of ``batches`` (a sequence of
    callables, each returning (images, one-hot, valid) on the device).
    Returns (losses, the first step's gradient as Adam's moment gives it,
    by name)."""
    trainer = Trainer(arch, hps, params, dropout_seed)
    losses, first = [], None
    for make in batches:
        value, _ = trainer.step(*make())
        losses.append(float(value))
        if first is None:
            first = trainer.first_moment()
    return losses, first
