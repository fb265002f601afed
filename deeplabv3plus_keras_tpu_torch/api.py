"""Public facade: JSON-config-driven DeepLabV3+ (port of
``deeplabv3plus_keras_tpu/api.py:71-280, 343-632, 634-648, 732-749``).

It builds and initialises the model (``base_model`` ``mobilenetv2`` or
``xception``), the training state (Keras Adam) and the train, eval and
label steps, as the JAX facade does, and answers the reference's entry
points ``train()``, ``evaluate(mode, result_saving)``, ``test()`` and
``segment(images)``, plus ``train_step(batch)`` and ``eval_step(batch)``
on batches the caller builds.

The epoch loops read a VOC-layout (or Open Images) dataset from
``resource_path``: host threads decode it into uint8 canvases
(``data/pipeline.py``), which cross to the device and are preprocessed
there (``ops/preprocess.py``).  The best-val-loss checkpoint lives in
``work_dir/semantic_segmentation_deeplabv3plus`` (``train/checkpoint.py``)
and ``model_loading`` restores it.

``hps.dtype`` (float32, bfloat16, float16; float64 for parity tests) is
the compute dtype; parameters, BN statistics, optimizer state and
checkpoints stay float32.  The extra keys ``remat`` (recompute the
backbone's activations in the backward pass) and ``cache_device`` /
``cache_device_max_bytes`` (the decoded dataset resident in device
memory, ``data/pipeline.py`` ``DeviceDataset``) are taken as the JAX
facade takes them.  ``convert_to_tf_lite()`` writes a ``torch.export``
program (``EXPORT_MODEL_PATH``).

The extra key ``backbone_weights`` (``"imagenet"`` or an ``.h5`` path)
starts the backbone from Keras weights (``utils/pretrained.py``), after the
random init and before the optimizer and a checkpoint restore, as the JAX
facade does (``api.py:125-135``).  ``int8_infer`` serves ``evaluate()``,
``test()`` and ``segment()`` with the wide convolutions in int8 after a
calibration pass over ``int8_calib_batches`` (default 4) training batches,
or over ``segment()``'s first images (``ops/quant.py``, JAX
``api.py:182-192, 282-337``); training stays float.

``multi_gpu`` with ``num_gpus`` N > 1 trains, evaluates and tests over the
N ranks of a ``torch.distributed`` process group, one device each
(``parallel/mesh.py``): the group the caller has initialised, else the one
torchrun's environment describes (the CLI starts the ranks itself).
``hps.batch_size`` is the global batch; each rank decodes and computes its
own rows, BN statistics, the loss and the gradients are the global batch's,
as on the JAX package's N-device mesh.  Rank 0 alone prints, logs and
writes checkpoints; ``evaluate``'s result panels and ``test``'s PNGs are
written by the rank that owns each sample.  The extra key
``allow_fewer_devices`` shrinks N to the ranks there are, as in JAX.

Under boundary refinement the train step and the probability-free eval
step (``train()``'s validation, ``evaluate()`` without result saving, the
int8 eval step) on a CUDA device end in the parity-decomposed tail: no
full-resolution tensor, one fused forward and one fused backward kernel
(``ops/parity_tail.py``, ``kernels/parity_tail.py``).  The JAX package
keeps it off by default, since XLA on the TPU v5e materialised its four
parity planes and ran slower than its resize; the kernels hold no plane.
On the CPU, whose plain version does build the planes, the
full-resolution tail stays the default.  The extra key ``fused_tail``
overrides the default either way (``parallel/step.py``
``_use_fused_tail``); without refinement it is ignored.

The extra key ``mesh_space`` S > 1 splits the N = ``num_gpus`` ranks into
the JAX package's (N/S) × S ``('data', 'space')`` grid (``parallel/
mesh.py`` ``init_grid``; a ``ValueError`` where S does not divide N): each
rank holds its data position's rows of the global batch and its space
position's image rows, and the model fetches the rows its spatial ops need
from the other ranks (``parallel/spatial.py``).  The steps take the whole
H × W images of the data position and cut the rank's rows themselves, after
``augment`` or a test-time scale's resize; ``fused_tail``, ``remat``,
``augment``, test-time augmentation and ``int8_infer`` (its calibration
images cut into the ranks' rows, its gate on the image's pixels) run
under it, on every backbone.  ``segment()``, ``test()`` and the predict
step return whole labels and probabilities on every rank; the ranks of
space position 0 write ``test()``'s PNGs and ``evaluate()``'s panels.

The environment variable ``DLV3_DW_LAYOUT=bhcw`` routes the 3×3 stride-1
undilated depthwise sites through the channels-first kernels
(``kernels/depthwise.py``), as it does in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import torch

from .config import (
    DEVICE_CPU,
    RESOURCE_TYPE_GOOGLE_OPEN_IMAGES_V5,
    RESOURCE_TYPE_PASCAL_VOC_2012,
    RESOURCE_TYPE_PASCAL_VOC_2012_EXT,
    Config,
)
from .data import pipeline as pipe
from .data import voc
from .models.deeplab import DeepLabV3Plus
from .ops import quant as quant_lib
from .parallel import mesh, spatial
from .parallel.step import (
    build_eval_step,
    build_label_step,
    build_predict_step,
    build_train_step,
    create_train_state,
    resolve_class_weights,
)
from .train import MeanIoU
from .train.callbacks import LRSchedule, ReduceLROnPlateau
from .train.checkpoint import (
    MODEL_DIR,
    checkpoint_exists,
    clear_resume_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from .utils import MetricsLogger, StepTimer, profiler_trace, span
from .utils.preemption import Preempted, PreemptionGuard
from .utils.pretrained import load_pretrained_backbone

_SEED = 1024  # the reference seeds 1024 (semantic_segmentation.py:1797-1802)
# convert_to_tf_lite()'s artifact: the inference forward as a torch.export
# program (the JAX package writes a StableHLO one beside the .tflite)
EXPORT_MODEL_PATH = "semantic_segmentation_deeplabv3plus.pt2"
# ... and, under int8_infer or with representative images, the calibrated
# int8 program beside it (the JAX package's TF_LITE_INT8_MODEL_PATH)
EXPORT_INT8_MODEL_PATH = "semantic_segmentation_deeplabv3plus_int8.pt2"


def resolve_device(device=None) -> torch.device:
    """The given device, else the first CUDA card; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def join_ranks(conf: Config, device=None) -> int:
    """The number of ranks the facade runs over (the JAX facade's mesh size,
    ``api.py:86-108``): ``num_gpus`` under ``multi_gpu``, else 1.  Asked for
    N > 1 with no group initialised, joins the group of torchrun's
    environment where it is set.  A config that asks for more ranks than
    the group has raises, unless the extra key ``allow_fewer_devices``
    shrinks it to the group with a warning; one that asks for fewer than an
    active group has raises."""
    requested = conf.num_gpus if conf.multi_gpu else 1
    if requested > 1 and mesh.world_size() == 1 and mesh.launched_by_torchrun():
        mesh.init_from_env(device)
    available = mesh.world_size()
    if requested > available:
        if conf.extra.get("allow_fewer_devices", False):
            print(f"warning: num_gpus {requested} > available ranks {available}; "
                  "shrinking the group (allow_fewer_devices)")
            return available
        if available == 1:
            raise RuntimeError(
                f"config requests num_gpus={requested} but no process group is initialised: "
                f"start the ranks with `python -m deeplabv3plus_keras_tpu_torch.cli conf.json` "
                f"(it starts {requested}) or `torchrun --nproc_per_node {requested}`, or set the "
                "extra config key 'allow_fewer_devices': true to train on one device")
        raise RuntimeError(
            f"config requests num_gpus={requested} but only {available} rank(s) are in the "
            "process group; set the extra config key 'allow_fewer_devices': true to train on "
            "the smaller group")
    if requested < available:
        raise ValueError(
            f"a process group of {available} ranks is active but the config asks for "
            f"{requested} (set 'multi_gpu': true, 'num_gpus': {available})")
    return available


class SemanticSegmentation:
    """JSON-config-driven DeepLabV3+ semantic segmentation model."""

    MODEL_PATH = MODEL_DIR

    def __init__(self, conf: dict | Config, work_dir: str = ".", device=None):
        self.conf = conf if isinstance(conf, Config) else Config.from_dict(conf)
        self.hps = self.conf.hps
        self.nn_arch = self.conf.nn_arch
        self.work_dir = work_dir
        extra = self.conf.extra
        n_space = max(1, int(extra.get("mesh_space", 1)))
        if n_space > 1:
            requested = self.conf.num_gpus if self.conf.multi_gpu else 1
            if requested % n_space:
                raise ValueError(f"mesh_space {n_space} must divide num devices {requested}")
        # ranks: the process group (multi_gpu), else this process alone
        self.world = join_ranks(self.conf, device)
        # the (data, space) grid under mesh_space (None: a data split alone)
        self.grid = mesh.init_grid(n_space)
        self.device = mesh.rank_device(device) if self.world > 1 else resolve_device(device)
        self._main = mesh.rank() == 0
        # this rank's data position: its rows of each global batch
        self._n_data, self._data_rank = ((self.grid.n_data, self.grid.d) if self.grid is not None
                                         else (self.world, mesh.rank()))
        self._accum = max(1, int(extra.get("grad_accum", 1)))

        self.model = DeepLabV3Plus(self.conf)
        self.model.init_weights(torch.Generator().manual_seed(_SEED))
        # extra key 'backbone_weights' ("imagenet" or an .h5 path): the
        # backbone from Keras weights; every rank converts the same file. A
        # checkpoint restore below still takes precedence
        load_pretrained_backbone(self.conf, self.model)
        self.model.to(self.device, memory_format=torch.channels_last).eval()
        self.optimizer = create_train_state(self.conf, self.model)
        if self.conf.model_loading and checkpoint_exists(work_dir):
            restore_checkpoint(self.model, self.optimizer, work_dir)
        # every rank starts from rank 0's weights and statistics
        mesh.broadcast_tensors_([t for t in self.model.state_dict().values()
                                 if t.is_floating_point()])
        # extra key 'class_weights_npz': the loss's class-balance weights
        self._cw = resolve_class_weights(self.conf)
        self._train_step = build_train_step(
            self.model, self.optimizer, self.conf, class_weights=self._cw, seed=_SEED)
        # extra keys 'eval_scales' / 'eval_flip': test-time augmentation
        self._tta = dict(tta_scales=extra.get("eval_scales"),
                         tta_flip=bool(extra.get("eval_flip", False)))
        self._eval_step = build_eval_step(
            self.model, self.conf, class_weights=self._cw, with_probs=False, **self._tta)
        self._eval_step_probs = None  # built by evaluate(result_saving=True)
        self._label_step = build_label_step(self.model)
        # extra key 'int8_infer': the inference entry points with the
        # eligible convs in int8 (ops/quant.py) after a calibration pass;
        # training and its validation loop stay float
        self._int8 = bool(extra.get("int8_infer", False))
        self._quant = None  # the calibrated ranges
        self._int8_steps = {}

    # ------------------------------------------------------------------
    # Steps on batches the caller builds
    # ------------------------------------------------------------------

    def _writes_samples(self) -> bool:
        """Whether this rank writes its samples' files: every rank, or under
        ``mesh_space`` the ranks of space position 0 (the others hold the
        same samples)."""
        return self.grid is None or self.grid.s == 0

    def train_step(self, batch: dict) -> dict:
        """One Keras-Adam step on ``batch`` (``image`` (B,H,W,3), ``label``
        one-hot (B,H,W,C) or int (B,H,W), optional ``valid`` (B,)), BN in
        training mode.  Returns ``{"loss", "cm"}`` as device tensors, so a
        loop of steps does not wait on each one.  Over N ranks, ``batch`` is
        this rank's rows (``mesh.row_indices`` of its data position) and the
        results are the global batch's; under ``mesh_space`` the images
        are whole and the step cuts this rank's image rows of them."""
        return self._train_step(self._batch(batch))

    def eval_step(self, batch: dict) -> dict:
        """Validation loss (+ L2) and confusion matrix of ``batch``, BN on
        running statistics."""
        return self._eval_step(self._batch(batch))

    def segment(self, images) -> np.ndarray:
        """Programmatic batch inference: images (B,H,W,3) in (−1,1) →
        argmax class-index labels (B,H,W) int32 (reference segment,
        :1207-1227).  Only the labels cross to the host.
        Under ``int8_infer`` the first call calibrates on the given images
        (no dataset needed); call :meth:`calibrate_int8` beforehand to
        calibrate on the training distribution instead."""
        with span("dlv3.segment"):
            with span("dlv3.segment.copy_in"):
                x = self._images(images)
            with span("dlv3.segment.forward"):
                label_step = (self._int8_step("label", calib_images=x) if self._int8
                              else self._label_step)
                labels = label_step(x)
            with span("dlv3.segment.copy_out"):
                return labels.cpu().numpy()

    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"images must be (B, H, W, 3), got {tuple(x.shape)}")
        return x

    def _batch(self, batch: dict) -> dict:
        image = self._images(batch["image"])
        label = torch.as_tensor(batch["label"], device=self.device)
        if label.shape[:3] != image.shape[:3]:
            raise ValueError(f"label {tuple(label.shape)} does not match images {tuple(image.shape)}")
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(image.shape[0], dtype=torch.int32, device=self.device)
        return {"image": image, "label": label,
                "valid": torch.as_tensor(valid, device=self.device)}

    # ------------------------------------------------------------------
    # Data plumbing
    # ------------------------------------------------------------------

    def _specs(self, mode: int):
        rt, rp = self.conf.resource_type, self.conf.resource_path
        if rt == RESOURCE_TYPE_PASCAL_VOC_2012:
            return voc.pascal_voc_2012(rp, mode)
        if rt == RESOURCE_TYPE_PASCAL_VOC_2012_EXT:
            return voc.pascal_voc_2012_ext(rp, mode, self.hps.val_ratio)
        if rt == RESOURCE_TYPE_GOOGLE_OPEN_IMAGES_V5:
            from .data import openimages

            return openimages.google_open_images_v5(rp, mode)
        raise ValueError(f"unknown resource_type {rt!r}")

    def _loader(self, mode: int, shuffle: bool = False, with_labels: bool = True,
                accum: int = 1):
        loader = self._host_loader(mode, shuffle, with_labels, accum)
        # extra key 'cache_device': the decoded dataset resident in device
        # memory (~1 MiB a sample at a 512² canvas); epochs gather their
        # batches there.  Not with the host SciPy path (prepro_device -1),
        # which needs the pixels on the host.
        if self.conf.extra.get("cache_device") and self.conf.prepro_device != DEVICE_CPU:
            # the device cache supersedes the host RAM cache
            loader.cache = False
            # 'cache_device_max_bytes' caps it (default: half the card's
            # free memory); the samples beyond stream each epoch
            max_bytes = self.conf.extra.get("cache_device_max_bytes")
            return pipe.DeviceDataset(
                loader, self.device, max_bytes=None if max_bytes is None else int(max_bytes),
                residual_cache=bool(self.conf.extra.get("cache_decoded", False)))
        return loader

    def _host_loader(self, mode: int, shuffle: bool, with_labels: bool,
                     accum: int = 1) -> pipe.HostLoader:
        return pipe.HostLoader(
            self._specs(mode),
            batch_size=self.hps.batch_size,
            canvas_size=max(512, self.nn_arch.image_size),
            workers=max(1, self.conf.workers),
            max_queue_size=self.conf.max_queue_size,
            shuffle=shuffle,
            with_labels=with_labels,
            # an input larger than the canvas is resized on the host
            # straight to the network geometry (reference :200-280)
            oversize_target=self.nn_arch.image_size,
            label_clamp=self.nn_arch.num_classes,
            # extra key 'cache_decoded': keep decoded uint8 samples in host
            # RAM, so epochs after the first skip the decode
            cache=bool(self.conf.extra.get("cache_decoded", False)),
            # extra key 'loader_backend': auto | native | pil
            backend=str(self.conf.extra.get("loader_backend", "auto")),
            # this rank's rows of each global batch (all rows on one rank)
            rank=self._data_rank, world=self._n_data, accum=accum,
        )

    def _batches(self, loader, with_labels: bool = True):
        return pipe.device_batches(
            loader, self.nn_arch.image_size, self.nn_arch.num_classes, with_labels,
            # extra key 'sparse_labels': integer labels instead of one-hot
            one_hot_labels=not self.conf.extra.get("sparse_labels", False),
            # prepro_device == -1: the reference's host SciPy path
            host_prepro=self.conf.prepro_device == DEVICE_CPU,
            device=self.device,
        )

    # ------------------------------------------------------------------
    # int8 inference (extra keys 'int8_infer' / 'int8_calib_batches')
    # ------------------------------------------------------------------

    def _calib_batches(self, images=None) -> list:
        """Calibration batches for PTQ: slices of ``images`` ((N, H, W, 3)
        in (−1, 1)) of ``hps.batch_size``, or by default
        ``int8_calib_batches`` batches of the training split in order (the
        standard PTQ protocol: calibrate on the training distribution; over
        N ranks, this rank's rows of them)."""
        if images is not None:
            x = self._images(images)
            B = max(1, self.hps.batch_size)
            return [x[i:i + B] for i in range(0, len(x), B)]
        n = int(self.conf.extra.get("int8_calib_batches", 4))
        batches = self._batches(self._loader(voc.MODE_TRAIN, shuffle=False))
        out = []
        try:
            for b in batches:
                if len(out) == n:
                    break
                out.append(b["image"])
        finally:
            batches.close()
        return out

    def calibrate_int8(self, images=None) -> dict:
        """Record the eligible convs' activation ranges for the int8
        inference path (``ops/quant.py``) and drop the int8 steps built
        against older ranges.  ``images``: optional (N, H, W, 3) in (−1, 1);
        by default ``int8_calib_batches`` batches of the training split.
        Over N ranks the ranges are the maximum over the ranks' batches.
        Returns the ranges {site: float32 scalar}."""
        self._quant = quant_lib.calibrate(self.model, self._calib_batches(images))
        self._int8_steps = {}
        return self._quant

    def _int8_step(self, kind: str, calib_images=None, **kw):
        """The quantized step of an inference entry point, built after
        (auto-)calibration; the float steps stay as they are."""
        if self._quant is None:
            self.calibrate_int8(images=calib_images)
        key = (kind, tuple(sorted(kw.items())))
        if key not in self._int8_steps:
            if kind == "eval":
                fn = build_eval_step(self.model, self.conf, class_weights=self._cw,
                                     quant=self._quant, **self._tta, **kw)
            elif kind == "label":
                fn = build_label_step(self.model, quant=self._quant)
            else:
                fn = build_predict_step(self.model, quant=self._quant)
            self._int8_steps[key] = fn
        return self._int8_steps[key]

    # ------------------------------------------------------------------
    # Entry points (reference :956-1187)
    # ------------------------------------------------------------------

    def train(self) -> dict:
        """Train with per-epoch validation, best-val checkpointing and
        ReduceLROnPlateau on the train loss (reference train(), :956-1009).
        Returns the history: per-epoch ``loss``, ``miou``, ``val_loss`` and
        ``val_miou``.

        Extra keys: ``lr_schedule`` (a per-epoch poly or exponential
        schedule in place of the plateau callback), ``metrics_log`` (JSONL
        per epoch), ``profile_logdir`` (a ``torch.profiler`` trace of the
        first epoch), ``nan_guard`` (default on: a non-finite epoch loss
        raises before the checkpoint is touched), ``resume`` (continue at
        the epoch the restored step count gives, with that epoch's shuffle)
        and ``preemption_save`` (default on: SIGTERM finishes the step in
        flight, saves the resume slot and returns).

        The step loop never waits on the device: losses and confusion
        matrices stay device tensors until the epoch's end (over N ranks it
        waits one step late, for the ranks' agreement on a SIGTERM).

        Over N ranks every rank computes the same history (the losses and
        confusion matrices are the global batch's), so ``nan_guard`` and
        ``ReduceLROnPlateau`` decide alike everywhere; rank 0 prints, logs
        and writes the checkpoints, and every rank waits for each write."""
        plateau = ReduceLROnPlateau(self.hps.reduce_lr_factor, patience=5, min_lr=1e-8)
        sched_spec = self.conf.extra.get("lr_schedule")
        schedule = (
            LRSchedule(sched_spec if isinstance(sched_spec, dict) else {}, self.hps.lr,
                       self.hps.epochs, default_factor=self.hps.reduce_lr_factor)
            if sched_spec else None
        )
        main = self._main
        logger = MetricsLogger(self.conf.extra.get("metrics_log") if main else None)
        profile_logdir = self.conf.extra.get("profile_logdir") if main else None
        history = {"loss": [], "miou": [], "val_loss": [], "val_miou": []}
        opt = self.optimizer

        def preemption_save(epoch):
            if main:
                save_checkpoint(self.model, opt, self.work_dir, best_only=False)
                logger.log({"preempted": True, "epoch": epoch + 1, "step": opt.iterations})
                print("SIGTERM received: checkpoint saved, training stopped")
            mesh.barrier(self.device)

        with PreemptionGuard(self.conf.extra.get("preemption_save", True)) as guard:
            try:
                tr_loader = self._loader(voc.MODE_TRAIN, shuffle=True, accum=self._accum)
                val_loader = self._loader(voc.MODE_VAL)
                preempted = False
            except Preempted:
                preempted = True
            if mesh.any_rank(preempted, self.device):
                preemption_save(0)
                return history
            self.hps.tr_step = tr_loader.steps()
            self.hps.val_step = val_loader.steps()
            # extra key 'resume': the start epoch from the restored step
            # count; the loader replays that epoch's shuffle.  A preemption
            # mid-epoch replays its epoch from the top.
            start_epoch = 0
            if self.conf.extra.get("resume", False):
                start_epoch = min(opt.iterations // max(self.hps.tr_step, 1), self.hps.epochs)
                if start_epoch:
                    tr_loader.set_epoch(start_epoch)
                    if main:
                        print(f"resume: continuing at epoch {start_epoch + 1}/{self.hps.epochs} "
                              f"(step {opt.iterations})")
            for epoch in range(start_epoch, self.hps.epochs):
                t0 = time.time()
                if schedule is not None:
                    opt.lr = schedule.lr(epoch)
                losses = []
                miou = MeanIoU(self.nn_arch.num_classes)
                timer = StepTimer(warmup=1, device=self.device)
                stop = mesh.StopAgreement(self.device)
                with profiler_trace(profile_logdir if epoch == 0 else None):
                    for batch in self._batches(tr_loader):
                        batch.pop("names")
                        with timer:
                            metrics = self._train_step(batch)
                        losses.append(metrics["loss"])
                        miou.update_from_cm(metrics["cm"])
                        if stop.poll(guard.triggered):
                            break
                if mesh.any_rank(guard.triggered, self.device):
                    preemption_save(epoch)
                    break
                train_loss = _mean(losses)
                if self.conf.extra.get("nan_guard", True) and not np.isfinite(train_loss):
                    logger.log({"nan_abort": True, "epoch": epoch + 1, "loss": train_loss})
                    raise FloatingPointError(
                        f"non-finite training loss ({train_loss}) at epoch {epoch + 1}; "
                        "checkpoint not updated — resume from the last good checkpoint "
                        "with 'model_loading': true (disable this check with "
                        "'nan_guard': false)"
                    )

                val_losses = []
                val_miou = MeanIoU(self.nn_arch.num_classes)
                stop = mesh.StopAgreement(self.device)
                for batch in self._batches(val_loader):
                    batch.pop("names")
                    metrics = self._eval_step(batch)
                    val_losses.append(metrics["loss"])
                    val_miou.update_from_cm(metrics["cm"])
                    if stop.poll(guard.triggered):
                        break
                if mesh.any_rank(guard.triggered, self.device):
                    # mid-validation: save and stop without recording the
                    # partial epoch
                    preemption_save(epoch)
                    break
                val_loss = _mean(val_losses)

                history["loss"].append(train_loss)
                history["miou"].append(miou.result())
                history["val_loss"].append(val_loss)
                history["val_miou"].append(val_miou.result())

                lr = opt.lr
                if schedule is None:
                    opt.lr = plateau.update(train_loss, lr)
                saved = main and save_checkpoint(self.model, opt, self.work_dir,
                                                 val_loss=val_loss)
                mesh.barrier(self.device)
                logger.log({
                    "epoch": epoch + 1, "loss": train_loss, "miou": history["miou"][-1],
                    "val_loss": val_loss, "val_miou": history["val_miou"][-1], "lr": opt.lr,
                    "checkpoint_saved": saved, "step_time": timer.stats(),
                })
                if main:
                    print(f"epoch {epoch + 1}/{self.hps.epochs} "
                          f"loss {train_loss:.4f} miou {history['miou'][-1]:.4f} "
                          f"val_loss {val_loss:.4f} val_miou {history['val_miou'][-1]:.4f} "
                          f"lr {opt.lr:.2e} {'[ckpt]' if saved else ''} "
                          f"({time.time() - t0:.1f}s)")
            else:
                # every epoch ran: the best-val slot is the run's artifact
                if main:
                    clear_resume_checkpoint(self.work_dir)
                mesh.barrier(self.device)
        return history

    def evaluate(self, mode: int = voc.MODE_VAL, result_saving: bool = False) -> MeanIoU:
        """Streaming mIoU over the split ``mode``; ``result_saving`` writes
        4-panel image | label | prediction | overlay PNGs to
        ``work_dir/results`` (reference evaluate, :1011-1115), named after
        each sample's number in the split's order.  SIGTERM stops after the
        batch in flight and returns the metric so far.  Over N ranks the
        metric is the whole split's (confusion matrices summed over ranks)
        and each rank writes its own samples' panels."""
        with PreemptionGuard(self.conf.extra.get("preemption_save", True)) as guard:
            try:
                loader = self._loader(mode)
                preempted = False
            except Preempted:
                preempted = True
            if mesh.any_rank(preempted, self.device):
                self._say("SIGTERM received: evaluation stopped")
                return MeanIoU(self.nn_arch.num_classes)
            return self._evaluate_inner(loader, result_saving, guard)

    def _say(self, text: str) -> None:
        """Print on rank 0 (every process without a group)."""
        if self._main:
            print(text)

    def _fresh_dir(self, path: str) -> None:
        """``path`` emptied by rank 0, before any rank writes into it."""
        if self._main:
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.makedirs(path, exist_ok=True)
        mesh.barrier(self.device)

    def _evaluate_inner(self, loader, result_saving: bool, guard) -> MeanIoU:
        self.hps.val_step = loader.steps()
        results_dir = os.path.join(self.work_dir, "results")
        if result_saving:
            self._fresh_dir(results_dir)
        if self._int8:
            eval_step = self._int8_step("eval", with_probs=result_saving)
        elif result_saving:
            if self._eval_step_probs is None:
                self._eval_step_probs = build_eval_step(
                    self.model, self.conf, class_weights=self._cw, with_probs=True, **self._tta)
            eval_step = self._eval_step_probs
        else:
            eval_step = self._eval_step

        c_miou = MeanIoU(self.nn_arch.num_classes)
        stop = mesh.StopAgreement(self.device)
        for batch in self._batches(loader):
            if stop.poll(guard.triggered):
                self._say("SIGTERM received: evaluation stopped (partial metric returned)")
                break
            batch.pop("names")
            metrics = eval_step(batch)
            c_miou.update_from_cm(metrics["cm"])
            if result_saving and self._writes_samples():
                probs = metrics["probs"].cpu().numpy()
                images = batch["image"].cpu().numpy()
                labels = batch["label"].cpu().numpy()
                for i, number in enumerate(batch["index"]):
                    if number >= 0:
                        _save_result_panel(images[i], labels[i], probs[i],
                                           self.nn_arch.num_classes,
                                           os.path.join(results_dir, f"result_{number}.png"))
        if self.conf.extra.get("eval_per_class_iou", False):
            names = (voc.CLASS_NAMES
                     if (self.nn_arch.num_classes == len(voc.CLASS_NAMES)
                         and self.conf.resource_type.startswith("pascal_voc"))
                     else None)
            self._say("per-class IoU:\n" + c_miou.report(names))
        self._say(f"mean iou: {c_miou.result():.4f}")
        return c_miou

    def test(self) -> None:
        """Label the test split and write class-index PNGs named after the
        inputs to ``work_dir/test_results`` (reference test(),
        :1117-1187).  SIGTERM stops after the batch in flight; PNGs written
        so far stay.  Over N ranks each rank labels and writes its own
        samples."""
        with PreemptionGuard(self.conf.extra.get("preemption_save", True)) as guard:
            try:
                loader = self._loader(voc.MODE_TEST, with_labels=False)
                preempted = False
            except Preempted:
                preempted = True
            if mesh.any_rank(preempted, self.device):
                self._say("SIGTERM received: test stopped")
                return
            self._test_inner(loader, guard)

    def _test_inner(self, loader, guard) -> None:
        from PIL import Image

        self.hps.test_step = loader.steps()
        out_dir = os.path.join(self.work_dir, "test_results")
        self._fresh_dir(out_dir)
        label_step = self._int8_step("label") if self._int8 else self._label_step
        stop = mesh.StopAgreement(self.device)
        for batch in self._batches(loader, with_labels=False):
            if stop.poll(guard.triggered):
                self._say("SIGTERM received: test stopped (partial results kept)")
                break
            # argmax on the device (K1); only the labels cross to the host
            labels = label_step(batch["image"]).cpu().numpy().astype(np.uint8)
            valid = batch["valid"].cpu().numpy()
            for i, name in enumerate(batch["names"]):
                if valid[i] and self._writes_samples():
                    Image.fromarray(labels[i]).save(os.path.join(out_dir, f"{name}.png"))

    def convert_to_tf_lite(self, representative_images=None) -> list[str]:
        """Model export (reference convert_to_tf_lite, :1189-1205; JAX
        ``api.py:650-729``): writes the inference forward (images (B, S, S,
        3) float32 → softmax probabilities (B, S, S, classes), BN on running
        statistics) as a ``torch.export`` program with a dynamic batch
        dimension, ``work_dir/semantic_segmentation_deeplabv3plus.pt2``
        (``torch.export.save``), and returns the paths written.

        With ``representative_images`` ((N, S, S, 3) in (−1, 1)) or under
        ``int8_infer``, a second program is written beside it:
        ``semantic_segmentation_deeplabv3plus_int8.pt2``, the same forward
        with the eligible convs in int8 (``ops/quant.py``), calibrated on
        those images or on ``int8_calib_batches`` training batches, as the
        JAX package calibrates its int8 ``.tflite`` (``_calib_batches``).

        The JAX package also converts to ``.tflite`` where TensorFlow is
        installed; no torch→TFLite converter is installed here, so no
        ``.tflite`` (float or int8) is written (it says so).  On the card
        the depthwise sites are the custom operators of
        ``kernels/depthwise.py``: load a program with ``torch.export.load``
        after ``import deeplabv3plus_keras_tpu_torch``.  Over N ranks every
        rank takes part in the calibration, rank 0 writes the programs
        (every rank holds the same weights) and the others return no
        path."""
        ranges = None
        if representative_images is not None or self._int8:
            ranges = quant_lib.calibrate(self.model, self._calib_batches(representative_images))
        if not self._main:
            mesh.barrier(self.device)
            return []
        paths = [self._export(EXPORT_MODEL_PATH)]
        if ranges is not None:
            paths.append(self._export(EXPORT_INT8_MODEL_PATH, ranges))
        print(f"no torch->TFLite converter is installed: no .tflite written; "
              f"artifacts written: {[os.path.basename(p) for p in paths]}")
        mesh.barrier(self.device)
        return paths

    def _export(self, name: str, ranges: dict | None = None) -> str:
        size = self.nn_arch.image_size
        self.model.eval()
        example = torch.zeros(2, size, size, 3, device=self.device)
        # under mesh_space the one-device forward: whole images, no exchange
        with torch.no_grad(), spatial.local(), (quant_lib.quantized(self.model, ranges) if ranges
                                                else contextlib.nullcontext()):
            program = torch.export.export(
                _ProbabilityForward(self.model), (example,),
                dynamic_shapes={"images": {0: torch.export.Dim("batch", min=1, max=4096)}})
        os.makedirs(self.work_dir, exist_ok=True)
        path = os.path.join(self.work_dir, name)
        torch.export.save(program, path)
        return path


class _ProbabilityForward(torch.nn.Module):
    """The exported function: the model's eval forward, probabilities."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images)


def _mean(values: list) -> float:
    """The float64 mean of a list of device scalars (one transfer); NaN
    for none."""
    if not values:
        return float("nan")
    return float(np.mean(torch.stack(values).cpu().numpy().astype(np.float64)))


def _save_result_panel(image, label, probs, num_classes, path):
    """4-panel composite: input | label map | prediction map | overlay
    (reference :1090-1106: class map ×255/21 in grey, a 50/50 overlay of
    the prediction on the input).  ``label``: one-hot (S, S, C) or integer
    (S, S)."""
    from PIL import Image

    img = ((image + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    scale = 255.0 / num_classes
    label_idx = label if label.ndim == 2 else label.argmax(-1)
    lab = (label_idx * scale).astype(np.uint8)
    pred = (probs.argmax(-1) * scale).astype(np.uint8)
    lab3 = np.stack([lab] * 3, axis=-1)
    pred3 = np.stack([pred] * 3, axis=-1)
    overlay = (0.5 * img + 0.5 * pred3).astype(np.uint8)
    Image.fromarray(np.concatenate([img, lab3, pred3, overlay], axis=1)).save(path)
