"""Train, eval, predict and label steps (port of
``deeplabv3plus_keras_tpu/parallel/step.py:63-407``).

The JAX steps are pure functions of ``(state, batch, rng)``.  Here the
model module holds the parameters and the BN running statistics, and the
optimizer (:class:`~..train.optimizer.KerasAdam`) holds the Adam moments
and the step count: together they are the training state, and a train
step updates them in place.

Batches are dicts with ``image`` (B, H, W, 3), ``label`` one-hot
(B, H, W, C) or integer (B, H, W), and ``valid`` (B,) 0/1, on the model's
device.  Loss = class-balanced loss + the Keras L2 of ``_l2`` kernels, in
both the train and the eval step, as Keras adds regularizer losses to
both.  Padded samples (``valid == 0``) count in neither the loss mean nor
the confusion matrix.

In a 16-bit ``hps.dtype`` the train and eval steps compute their loss and
confusion matrix from probabilities upsampled and normalised in float32
from the 16-bit logits (the model's ``float32_tail``), as the parity tail
reads them: rounded to 16 bits first, as ``jax.nn.softmax`` rounds them, a
confidently wrong class's probability becomes 1.0 and the loss's gradient
there noise (ROADMAP C5).  The predict step returns the model's own
16-bit-rounded probabilities.

The eval, predict and label steps run under ``torch.inference_mode()`` in
eval mode (BN on running statistics, dropout off); the train step in
train mode (BN on batch statistics, dropout drawn from a generator seeded
from (seed, step)).  The extra key ``augment`` draws a flip and a scale
jitter from that generator before the dropout (ops/augment.py), and
``eval_scales``/``eval_flip`` make the eval step average the probabilities
over scales and a horizontal flip (test-time augmentation).  The extra key
``fused_tail`` (default off) ends the train and eval steps in the
parity-decomposed tail (``ops/parity_tail.py``; T1/T2 on the card).  Given the
calibrated ranges of ``ops/quant.calibrate`` (``quant``), the eval,
predict and label steps run the eligible convolutions in int8 (JAX
``_variables(state, quant)``, ``step.py:109-116``); the train step never
takes them.

Under a process group of N > 1 ranks (``parallel/mesh.py``) the train and
eval steps take this rank's rows of a global batch and compute what the
JAX steps compute over a batch sharded on an N-device mesh: BN statistics
over every rank's rows (``models/blocks.py``), the loss's denominator the
global count of valid pixels, gradients, loss and confusion matrix summed
over ranks.  The gradients cross ranks once, after the last microbatch's
backward, through flat all-reduces in parameter order (no
``DistributedDataParallel``: its buckets would be all-reduced from
autograd hooks, interleaved with BN's own backward all-reduces in an order
that is not fixed, it would stall on a parameter the loss never reaches,
and accumulation would need ``no_sync``).

Under ``mesh_space`` S > 1 (the grid of ``mesh.init_grid``: N = n_data × S
ranks) the train and eval steps take this rank's data position's rows of
the global batch (``mesh.row_indices`` over the n_data data positions) as
whole H × W images, and cut this rank's image rows (``mesh.rows_of(H)``)
themselves, after the augmentation or a test-time scale's resize: the JAX
steps' batch sharded over ``('data', 'space')``.  The model fetches the
rows each spatial op needs (``parallel/spatial.py``, its global heights
seeded from the images' H and W), BN takes its statistics over every
rank's pixels, each sample's pixel mean in the loss sums over its space
ranks (the global H·W in every rank's denominator), the count of valid
samples is the data ranks', and gradients, loss and confusion matrix sum
over all N ranks.  ``fused_tail`` takes the label rows of this rank's
logits sites (``ops/parity_tail.py``); ``remat`` recomputes the backbone's
exchanges in the backward (``models/deeplab.py``); test-time augmentation
resizes each scale's whole images, runs the model on this rank's rows of
them and resizes its probabilities back to its rows of the native size
(``spatial.resize_rows_linear``).  The predict and label steps take whole
images and return whole probabilities and labels on every rank, as the
JAX steps return them replicated: each rank computes its rows and the
rows are gathered.  Dropout draws from each rank's own stream, as under a
data split (a known divergence from the JAX mask, ROADMAP.md Queue C).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..kernels import upsample_argmax
from ..ops import quant as quant_lib
from ..ops.augment import augment_batch, parse_augment_conf
from ..ops.parity_tail import tail_loss_cm
from ..train.loss import (
    SS_NW,
    SS_PW,
    class_balanced_loss,
    class_balanced_loss_sparse,
    l2_penalty,
)
from ..train.metrics import confusion_matrix_update, confusion_matrix_update_sparse
from ..train.optimizer import KerasAdam, make_optimizer
from . import mesh, spatial

def _use_fused_tail(conf: Config) -> bool:
    """The extra key ``fused_tail`` (default off, as in the JAX package,
    ``step.py:46-60``): the steps end in the parity-decomposed tail
    (``ops/parity_tail.py``) instead of the ×2 upsample, softmax and loss of
    the full-resolution probabilities.  It applies under boundary
    refinement, whose last upsample is always ×2; elsewhere the key is
    ignored."""
    return bool(conf.extra.get("fused_tail", False)) and conf.nn_arch.boundary_refinement


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


def _loss_for(label, probs, pw, nw, valid, n_valid=None, n_pix=None):
    """One-hot (B,H,W,C) or integer (B,H,W) labels; ``n_valid``: the global
    count of valid samples (``train/loss.py`` ``masked_pixel_mean``);
    ``n_pix``: a sample's global pixel count, where the rows are a share."""
    if label.dim() == probs.dim():
        return class_balanced_loss(label, probs, pw, nw, valid=valid, n_valid=n_valid,
                                   n_pix=n_pix)
    return class_balanced_loss_sparse(label, probs, pw, nw, valid=valid, n_valid=n_valid,
                                      n_pix=n_pix)


def _valid_count(valid: torch.Tensor, grid) -> torch.Tensor:
    """The count of valid samples of the global batch, in float64, per row
    of ``valid``'s leading dimensions summed: over every rank, or under
    ``mesh_space`` over the data ranks (the ranks of one space position
    hold different samples, those of one data position the same ones)."""
    v = valid.to(torch.float64)
    if grid is None:
        return mesh.all_reduce_(v)
    return mesh.all_reduce_group_(v, grid.data_group)


def _pixels(image: torch.Tensor, grid) -> int | None:
    """A sample's global pixel count H·W of whole images under
    ``mesh_space``, else None (the rows are whole samples)."""
    return None if grid is None else image.shape[1] * image.shape[2]


def _image_rows(t: torch.Tensor, grid) -> torch.Tensor:
    """This rank's image rows (``rows_of(H)`` along dim 1) of whole images
    or labels under ``mesh_space``; ``t`` itself otherwise."""
    if grid is None:
        return t
    a, b = grid.rows_of(t.shape[1])
    return t[:, a:b]


def _sum_over_ranks(loss_share: torch.Tensor, cm: torch.Tensor):
    """(Σ loss shares, Σ confusion matrices) over the ranks, in one
    all-reduce in float64 (exact for the counts)."""
    out = mesh.all_reduce_(torch.cat([loss_share.detach().reshape(1).to(torch.float64),
                                      cm.reshape(-1).to(torch.float64)]))
    return out[0].to(loss_share.dtype), out[1:].reshape(cm.shape).to(cm.dtype)


def _cm_for(label, probs, num_classes, valid):
    if label.dim() == probs.dim():
        return confusion_matrix_update(label, probs, num_classes, valid)
    return confusion_matrix_update_sparse(label, probs, num_classes, valid)


def step_generator(seed: int, step: int, device, microbatch: int | None = None,
                   rank: int | None = None) -> torch.Generator:
    """The dropout generator of one (micro)step, seeded from (seed, step[,
    microbatch]): the port's ``jax.random.fold_in(rng, step)``.  ``rank``:
    that rank's own stream (element-wise dropout under a process group)."""
    key = [int(seed), int(step)] + ([int(microbatch)] if microbatch is not None else [])
    seq = np.random.SeedSequence(key, spawn_key=() if rank is None else (int(rank),))
    state = int(seq.generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def build_train_step(model, optimizer: KerasAdam, conf: Config, class_weights=None,
                     seed: int = 0) -> Callable[[dict], dict]:
    """``train_step(batch) -> {"loss", "cm"}`` (device tensors; the loss is
    the class-balanced loss + L2, the cm int32).  One Keras-Adam update per
    call.  The extra key ``grad_accum`` N splits the batch into N
    sequential microbatches: gradients and losses are averaged, confusion
    matrices summed, and BN's running statistics move once per microbatch
    (each sees its microbatch's statistics), as in the JAX step.  The
    gradients of the last update stay in each parameter's ``.grad``.

    Under a process group of W > 1 ranks (the group active when the step is
    built) ``batch`` holds this rank's rows of a global batch W times as
    large, in the order ``mesh.row_indices`` gives them (its slice of each
    microbatch); under ``mesh_space`` its data position's rows, whole
    images, whose image rows the step cuts after the augmentation.  Each
    rank differentiates its share of the global loss (its pixels' sum over
    the global valid-pixel count, + L2/W), and the
    gradients are summed over ranks; the augmentation's and stochastic
    depth's per-sample draws are made for the global batch and sliced, so
    W ranks draw what one process draws; element-wise dropout draws from
    the rank's own stream.  Loss and confusion matrix are the global
    ones.

    With ``fused_tail`` (:func:`_use_fused_tail`) the model stops at its
    half-resolution logits and ``ops/parity_tail.tail_loss_cm`` gives each
    microbatch's loss and confusion matrix (on the card: T1, and T2 in the
    backward), as the JAX step's ``grads_one`` (``step.py:163-182``)."""
    wd = conf.hps.weight_decay
    num_classes = conf.nn_arch.num_classes
    pw, nw = class_weights or default_class_weights(num_classes)
    accum = max(1, int(conf.extra.get("grad_accum", 1)))
    aug = parse_augment_conf(conf.extra.get("augment"))
    fused = _use_fused_tail(conf)
    world, rank = mesh.world_size(), mesh.rank()
    grid = mesh.grid()
    # the data positions: the ranks under a data split, n_data under space
    n_data, d = (grid.n_data, grid.d) if grid is not None else (world, rank)

    def train_step(batch: dict) -> dict:
        model.train()
        image, label, valid = batch["image"], batch["label"], batch["valid"]
        dev = image.device
        B = image.shape[0]
        if B % accum:
            raise ValueError(f"grad_accum {accum} must divide batch size {B}")
        step = optimizer.iterations
        gen = step_generator(seed, step, dev)
        rows = n_valid = None
        if world > 1:
            rows = torch.as_tensor(mesh.row_indices(B * n_data, n_data, d, accum), device=dev)
            # each microbatch's count of valid samples over the data ranks
            n_valid = _valid_count(valid.reshape(accum, B // accum).sum(1), grid)
        if aug is not None:
            # drawn before the dropout, as the JAX step splits its step key
            image, label = augment_batch(image, label, gen, flip=aug[0], scale_range=aug[1],
                                         rows=rows, batch=B * n_data)
        mb = B // accum
        n_pix = _pixels(image, grid)
        geometry = spatial.use_heights({image.shape[2]: image.shape[1]})
        image = _image_rows(image, grid)
        if not fused:  # the fused tail takes its sites' rows of the whole labels
            label = _image_rows(label, grid)
        optimizer.zero_grad()
        loss_sum, l2_sum, cm_sum = 0.0, 0.0, 0
        with geometry:
            for i in range(accum):
                part = slice(i * mb, (i + 1) * mb)
                if accum > 1:
                    gen = step_generator(seed, step, dev, i)
                draws = gen
                if world > 1:
                    own = step_generator(seed, step, dev, i if accum > 1 else None, rank=rank)
                    draws = mesh.RankDraws(gen, own, torch.arange(d * mb, (d + 1) * mb, device=dev),
                                           mb * n_data)
                nv = n_valid[i] if world > 1 else None
                if fused:
                    logits, _ = model(image[part], return_presample=True, generator=draws)
                    loss, cm = tail_loss_cm(logits, label[part], pw, nw, num_classes, valid[part],
                                            n_valid=nv)
                    del logits
                else:
                    probs = model(image[part], generator=draws, float32_tail=True)
                    loss = _loss_for(label[part], probs, pw, nw, valid[part], nv, n_pix)
                    with torch.no_grad():
                        cm = _cm_for(label[part], probs, num_classes, valid[part])
                    del probs
                l2 = l2_penalty(model, wd)
                if world > 1:
                    (loss + l2 / world).backward()
                    loss_sum = loss_sum + loss.detach()
                    l2_sum = l2_sum + (l2.detach() if torch.is_tensor(l2) else l2)
                else:
                    loss = loss + l2
                    loss.backward()
                    loss_sum = loss_sum + loss.detach()
                cm_sum = cm_sum + cm
        # a parameter the loss does not reach (Xception's unused os-8
        # shortcut) gets a zero gradient, as jax.grad gives it
        for p in optimizer.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if world > 1:
            mesh.all_reduce_tensors_([p.grad for p in optimizer.params])
            loss_sum, cm_sum = _sum_over_ranks(loss_sum, cm_sum)
            loss_sum = loss_sum + l2_sum
        if accum > 1:
            torch._foreach_div_([p.grad for p in optimizer.params], float(accum))
        optimizer.step()
        return {"loss": loss_sum / accum, "cm": cm_sum}

    return train_step


def _resize_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) → (B, size, size, C) as ``jax.image.resize(...,
    "linear")``: half-pixel bilinear, antialiased (a triangle filter
    widened by the scale) where it shrinks."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=size < x.shape[1])
    return y.permute(0, 2, 3, 1)


def _tta_probs_fn(model, conf: Config, scales, flip: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """Multi-scale and horizontal-flip test-time augmentation: each scaled
    size is rounded to a multiple of ``output_stride``, each variant's
    probabilities are resized back to the input size and all are averaged.
    A scale that changes the height resizes to and from squares, as the
    JAX step's does (``jax.image.resize`` to (sz, sz) and back to (H, H)),
    so it takes square images only; a variant at the input height (the
    flip alone, a scale of 1) takes any H × W.  Under ``mesh_space``
    ``images`` are whole: each scale's images are resized whole, the model
    runs on this rank's rows of them (the global heights seeded at the
    variant's size), the flip along W stays on the rank, and its
    probabilities are resized back to its rows of the native size from the
    rows they need (``spatial.resize_rows_linear``); the result is this
    rank's rows."""
    os_ = conf.nn_arch.output_stride
    scales = tuple(float(s) for s in (scales or (1.0,)))

    def tta_probs(images: torch.Tensor) -> torch.Tensor:
        H, W = images.shape[1], images.shape[2]
        sizes = [max(os_, int(round(H * s / os_)) * os_) for s in scales]
        if H != W and any(sz != H for sz in sizes):
            raise ValueError(f"test-time augmentation at a scaled size {sizes} takes square "
                             f"images, got {(H, W)}")
        grid = spatial.active()
        acc, n = 0.0, 0
        for sz in sizes:
            x = images if sz == H else _resize_linear(images, sz)
            x = _image_rows(x, grid)
            variants = [x, x.flip(2)] if flip else [x]
            for i, xv in enumerate(variants):
                with spatial.use_heights({x.shape[2]: sz}):
                    p = model(xv, float32_tail=True)
                if i == 1:
                    p = p.flip(2)  # the prediction, flipped back
                if sz != H and grid is None:
                    p = _resize_linear(p, H)
                elif sz != H:
                    p = spatial.resize_rows_linear(p.permute(0, 3, 1, 2), sz, H, H).permute(
                        0, 2, 3, 1)
                acc = acc + p
                n += 1
        return acc / n

    return tta_probs


@contextlib.contextmanager
def _inference(model, quant):
    """The context of an inference forward: inference mode, and int8 at
    the sites ``quant`` (calibrated ranges) holds."""
    with torch.inference_mode(), (quant_lib.quantized(model, quant) if quant
                                  else contextlib.nullcontext()):
        yield


def build_eval_step(model, conf: Config, class_weights=None, with_probs: bool = True,
                    tta_scales=None, tta_flip: bool = False,
                    quant=None) -> Callable[[dict], dict]:
    """``eval_step(batch) -> {"loss", "cm"[, "probs"]}`` in eval mode.
    ``with_probs=False`` drops the (B, H, W, C) probabilities.  Under a
    process group the loss and the confusion matrix are the global batch's
    (summed over ranks, the loss over the global valid-pixel count); the
    probabilities are this rank's rows' (under ``mesh_space``, its data
    position's samples at their whole height; the batch holds whole images,
    whose rows the step cuts).
    ``tta_scales``/``tta_flip`` (extra keys ``eval_scales``/``eval_flip``)
    turn on test-time augmentation (:func:`_tta_probs_fn`); ``quant``, the
    calibrated int8 ranges, quantizes the eligible sites of each scale.
    ``fused_tail`` without probabilities and without test-time
    augmentation (which wins, as in JAX ``step.py:329-359``) ends in the
    parity-decomposed tail, as the train step."""
    wd = conf.hps.weight_decay
    num_classes = conf.nn_arch.num_classes
    pw, nw = class_weights or default_class_weights(num_classes)
    tta = bool(tta_scales) or tta_flip
    fused = _use_fused_tail(conf) and not with_probs and not tta
    world = mesh.world_size()
    grid = mesh.grid()
    # test-time augmentation cuts the rows of each scale's images itself
    probs_fn = (_tta_probs_fn(model, conf, tta_scales, tta_flip) if tta
                else lambda images: model(_image_rows(images, grid), float32_tail=True))

    def eval_step(batch: dict) -> dict:
        model.eval()
        image, label, valid = batch["image"], batch["label"], batch["valid"]
        H, W = image.shape[1], image.shape[2]
        with _inference(model, quant), spatial.use_heights({W: H}):
            n_valid = None
            if world > 1:
                n_valid = _valid_count(valid.sum().reshape(1), grid)[0]
            if fused:  # the tail takes the whole labels (its sites' rows)
                logits, _ = model(_image_rows(image, grid), return_presample=True)
                loss, cm = tail_loss_cm(logits, label, pw, nw, num_classes, valid,
                                        n_valid=n_valid)
            else:
                probs = probs_fn(image)
                label = _image_rows(label, grid)
                loss = _loss_for(label, probs, pw, nw, valid, n_valid, _pixels(image, grid))
                cm = _cm_for(label, probs, num_classes, valid)
            if world > 1:
                loss, cm = _sum_over_ranks(loss, cm)
            out = {"loss": loss + l2_penalty(model, wd), "cm": cm}
            if with_probs:
                # under mesh_space: this rank's samples at their full height
                out["probs"] = spatial.gather_rows(probs, H, 1)
            return out

    return eval_step


def build_predict_step(model, quant=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """images (B, H, W, 3) → softmax probabilities (B, H, W, classes);
    int8 at the sites of ``quant``.  Under ``mesh_space`` each rank
    computes its rows and every rank returns them all."""

    def predict_step(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        H, W = images.shape[1], images.shape[2]
        with _inference(model, quant), spatial.use_heights({W: H}):
            return spatial.gather_rows(model(_image_rows(images, spatial.active())), H, 1)

    return predict_step


def build_label_step(model, quant=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """images (B, H, W, 3) → class labels (B, H, W) int32.

    argmax∘softmax∘upsample ≡ argmax∘upsample, so labels come from the
    decoder's pre-upsample logits through the fused upsample+argmax kernel
    (``kernels/upsample_argmax``): the (B, H, W, C) probabilities never
    exist.  int8 at the sites of ``quant``.

    Under ``mesh_space`` each rank runs the kernel on the logits rows its
    label rows need (its own and a fetched row or so on each side, clamped
    at the image's edges: TF half-pixel sampling at an integer scale makes
    the kept rows exact), and every rank returns all the labels."""

    def label_step(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with _inference(model, quant), spatial.use_heights(
                {images.shape[2]: images.shape[1]}):
            logits, up = model(_image_rows(images, spatial.active()), return_presample=True)
            if spatial.active() is None:
                return upsample_argmax(logits.contiguous(), up)
            # the logits NHWC; spatial.resize_rows takes NCHW row shards
            labels = spatial.resize_rows(
                logits.permute(0, 3, 1, 2), up,
                lambda xb: upsample_argmax(xb.permute(0, 2, 3, 1).contiguous(), up),
                out_width=logits.shape[2] * up, out_channels=0, row_dim=1)
            return spatial.gather_rows(labels, images.shape[1], 1).to(torch.int32)

    return label_step
