#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``deeplabv3plus_keras_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeplabv3plus_keras_tpu_torch/csrc``
(and prints what ``ptxas`` makes of every instantiation of the five
sources, failing on a register spill), then drives two models, each with random weights from a seed and BN
statistics set from its first batch, at 512², float32, B=16:

- the flagship (MobileNetV2, output stride 16, boundary refinement, 21
  classes, the five-branch dilated ASPP), with the default depthwise
  layout (``DLV3_DW_LAYOUT=nhwc``);
- Xception (output stride 16, boundary refinement, 21 classes, the
  reference's Xception ASPP: rates 1, 6, 12, 18 and image pooling) with
  ``DLV3_DW_LAYOUT=bhcw``, which sends its 33 undilated 3×3 depthwise
  sites per forward through the channels-first kernels K6/K7.

For each model it

1. holds every kernel of its paths against its plain PyTorch version at
   every site shape the serving and training paths give it (TF32 off; the
   backward kernels' dk also bit for bit across two runs), and times
   kernel, plain version and the nearest PyTorch library call with CUDA
   events (K6/K7 also as the whole channels-first route with its two
   layout copies, and beside K2/K4 at the same site, K4 checked there too;
   K6's and K7's site lines carry their plans, and K6's output must be the
   same bits in two runs);
2. serves it through ``SemanticSegmentation(conf, device="cuda").segment()``
   on 4 batches, checks the labels, the kernels' launch counts per call,
   and one image against the same weights served on the CPU, and reports
   images/s with TF32 off and on;
3. trains it through ``SemanticSegmentation.train_step()`` for 6 steps
   (Keras Adam, class-balanced loss + L2, BN in training mode, dropout
   0.5), checks the loss, every parameter's gradient and the launch counts
   per step, and reports the step time, images/s and peak device memory;
   then one step at 2 × 128² on the card and on the CPU from the same
   weights, whose losses must agree with float64's, and whose gradients
   and module outputs with a float64 step taken at the card's own ReLU
   masks and max-pool choices (:func:`check_training_against_cpu`).

After Xception's phases under ``bhcw``, its ``segment()`` and
``train_step()`` run again under ``nhwc`` (K2/K4 at the 33 sites, no
layout copies; the same checks), and the ``xception_route`` line sets the
two layouts' device times and images/s side by side.

After the flagship's phases, under ``nhwc``, the ``data_path`` phase drives
the JSON-config entry points on a VOC-layout tree it writes (64 train, 32
val and 16 test images, sides 300–500): ``train()`` for 2 epochs with flip
and scale augmentation, ``evaluate()`` of a second facade restored by
``model_loading`` (equal to the best epoch's ``val_miou``), ``test()``'s PNGs
against ``segment()``, ``evaluate()`` with test-time augmentation, and
``prepare_batch`` on the card against the CPU; it reports ``train()``'s
images/s beside ``train_step()``'s, the host decode time a batch and the
card's idle share over one profiled epoch.

After Xception, under ``nhwc``, the flagship again with the weights and
BN statistics of its float32 phases:

- in bfloat16, then float16 (``hps.dtype``): K2–K5 against their plain
  versions at every site in that dtype (times beside cuDNN's in that
  dtype and the dtype's byte bound), ``segment()`` on the 4 serving
  batches (labels against the float32 labels, with a floor), 6
  ``train_step()``s, every depthwise launch counted in that dtype, and one
  2 × 128² step against the CPU in the same dtype;
- ``remat``: peak memory and step time with and without it, and one step
  with it against the plain step (and the plain step against itself);
- ``cache_device`` on a 64/32-image VOC tree: an epoch's batches from the
  device cache against the streamed ones, ``train()``'s history, images/s
  and a profiled epoch's idle share streamed and cached, a partial cache
  (40 of 64 samples);
- export: ``convert_to_tf_lite()``, the depthwise operator nodes of the
  ``.pt2``, and ``torch.export.load`` of it at B=1 and B=16 against the
  model;
- ``ddp``: two ranks of a process group (a card each over NCCL where two
  cards exist, else both on the one card over gloo: a correctness check,
  not a speed), spawned with a deadline, against one process: 2 float32
  steps of 16 × 512² (8 rows a rank) and one bfloat16 step (losses,
  first-step gradients, confusion matrices, parameters; ranks bit for
  bit; K2–K5 launches per rank and step), then on a VOC tree ``train()``
  streamed and with a sharded ``cache_device``, ``evaluate()`` and
  ``test()``, images/s and a profiled epoch's idle share; and
  ``int8_infer``'s ``evaluate()`` on the two ranks against one process;
- ``fused_tail`` (after ``int8``, before ``ddp``): the parity-decomposed
  training tail.
  Each T1/T2 instantiation's registers and spills; every instantiation
  (C = 8, 16, 32, 33, 150 at 4 × 64² logits) against the plain version;
  T1/T2 (``csrc/parity_tail.cu``) at the flagship's tail (logits
  16 × 256² × 21, labels at 512², one padded sample) in float32 and
  bfloat16, one-hot and integer labels, against the plain version (the
  per-sample sums, the matrix, dlogits; twice, bit for bit), timed beside
  the plain version, the unfused tail and the byte bound; 6
  ``train_step()``s with the key on and off from the same weights
  (step-1 loss, matrix and gradients, peak memory, step time, launches a
  step: T1 1, T2 1, K2 15, K3 3, K4 15, K5 3) and the probability-free
  ``eval_step()`` (T1 once a call), the same in bfloat16, and one step on
  two ranks (the ``ddp`` layout) against one process;
- ``spatial`` (after ``ddp``): ``mesh_space`` 2. K2–K5 on row
  windows (each rank's output rows and the rows they read) against their
  plain versions at the flagship's sites at 1024² × 4, at NASNet-Mobile's
  and EfficientNet-B0's k = 5 and 7 sites at 1024² × 2 and at Xception's
  odd heights (253, 127, 509, 255, 128; stride 1 and 2, and the K6/K7
  route's symmetric halo under ``bhcw``); then two ranks as a 1 × 2 grid
  (the ``ddp`` layout) against one process from the same weights (seed
  1024) and batches: the flagship at 1024² × 4 (3 ``train_step()``s,
  each loss and each parameter's update, the latter beside one process
  taking the batch rows reversed; ``segment()``'s labels where one
  process's top two logits are clearly apart; an eval step's confusion
  matrix), its step options (3 steps each of ``fused_tail``, ``remat``
  and ``augment``: losses, updates and summed matrices; T1/T2 also
  checked on row windows against their plain versions), a
  test-time-augmented eval step (loss and matrix) and a 1024 × 768
  ``segment()``, Xception at 1024² × 2 (one step and ``segment()`` under
  ``nhwc`` and ``bhcw``: K6/K7 on every rank), NASNet-Mobile,
  EfficientNet-B0 and DenseNet-121 at 1024² × 2 (2 steps and
  ``segment()`` each, held as the flagship, each beside its own
  rows-reversed run; ``spatial_backbones`` line) and ``int8_infer``
  ``segment()`` of the flagship and Xception at 1024² × 2 (the int8 sites
  by name, the ranges and the labels against one process's int8;
  ``spatial_int8`` line); per rank and per one process peak memory, a
  profiled step's and call's device time, the halo exchanges and their
  bytes a step, K1–K7's and T1/T2's launches; and the allocations live
  at the peak of the flagship's second step with ``fused_tail`` off and
  on, in one process and in each rank (``spatial_peak_allocations``);
- ``int8`` (before ``ddp``): ``int8_infer`` on the flagship and on
  Xception (under ``nhwc``) calibrated on the serving batches: the
  quantized sites against the CPU's for the same config, ``segment()``
  (K1–K3 launches and the int8 convs per call, images/s against float32
  and bfloat16 ``segment()`` of the same weights, labels against float32
  and against the CPU's int8 path on 2 images), every distinct int8 site
  timed against cuDNN's float32 and bfloat16 conv (and checked against the
  CPU's int8 conv), the gate edges (a site above the pixel gate, one below
  the channel gate), ``evaluate()`` and ``test()`` under ``int8_infer`` on
  a VOC tree, and the int8 ``.pt2`` against int8 ``segment()``;
- ``pretrained`` (after the other backbones): a random-weight Keras
  MobileNetV2 ``.h5`` through ``backbone_weights`` where TensorFlow
  imports, else the facade's refusal naming TensorFlow;

Then the backbones' pools and their gradients in ``channels_last`` on
the card against float64 (:func:`check_pools`), and the other backbones,
under ``nhwc``, each with the flagship's head (the five-branch ASPP,
boundary refinement, 21 classes):

- EfficientNet-B0, NASNet-Mobile and DenseNet-121 at 512², B=16, float32,
  through the same four phases as the flagship (K2–K5 at every distinct
  k = 3/5/7 site, also in bfloat16 for the first two; ``segment()``; 6
  ``train_step()``s with EfficientNet's stochastic depth on; the 2 × 128²
  step against the CPU with the drop rates 0);
  every depthwise input must already be ``channels_last``;
- a sweep of the nine other variants (EfficientNet B1–B7, NASNet-Large,
  DenseNet-169/201) at 128², B=2: K2–K5 at each one's distinct sites,
  ``segment()`` against the CPU and one ``train_step()``.

Beside ``ddp`` and ``spatial``, whose gates time nothing (two ranks on one
card), ``train_quality`` runs, under ``nhwc`` with TF32 off: the trained
outcome of the learnable synthetic task of ``tests/synthetic_task.py``
(loaded by path, numpy only, so the card draws the CPU suites' batches),
each arm 3 seeds × 250 ``train_step()``s from the port's own weights of
each seed (``init_weights``), dropout 0, lr 1e-3, one-hot labels, scored
by batch-statistics evals of a held-out set at the 5 checkpoints 25 steps
apart (every BN's running statistics restored after each eval):
``parity_conf`` (the CPU suites' configuration, 96², B = 4) in float32
and bfloat16; the flagship at 256², B = 8, in float32 and bfloat16 with
``fused_tail`` off and on, each also serving the held-out set through
``segment()`` (K1; inference-mode mIoU, reported, not gated);
NASNet-Mobile at 256², B = 8, in float32 and bfloat16.  Each (arm,
variant, seed) is a job of its own, 7 spawned processes at a time sharing
the card with those two phases.  Every float32 variant's mean over its 15
evals must reach 0.15 (3× chance), every bfloat16 and ``fused_tail``
variant lie within 0.05 of its arm's float32, tail-off mean, every loss
be finite and K2–K5 (T1/T2 with ``fused_tail``, K1 in the flagship's
``segment()``) be launched; the ``train_quality`` line holds every seed's
checkpoints, the means, the median step ms (between CUDA events, the jobs
sharing card and cores), the wall s and the peak GiB, and the paths
``train_quality_<arm>_<variant>`` join the ``kernels`` line.

Then it prints the forward and backward depthwise summaries against cuDNN
and the byte bound (K7's beside the one-tile-a-block design it replaced),
K2–K5 by kernel size at the new backbones' sites (``depthwise_by_k``),
one JSON line of kernel results (K1-K7 and T1/T2, the fused tail's kernels,
which port a jnp function and no Pallas call; K2-K7 also in bfloat16,
K2-K5 in float16, T1/T2 in bfloat16 and with integer labels; launches by
path, the new phases' paths (``segment_int8``,
``xception_segment_int8``, ``evaluate_int8``, ``test_int8``,
``export_program_int8``), the ddp phase's rank 0 and the spatial phase's
(``spatial_train``, ``spatial_segment``, ``spatial_xception_bhcw``, the
options', ``spatial_<backbone>_train``/``_segment``,
``spatial_int8_<model>_segment``) included), the card's
name and power limit, and as its last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --parity-tail`` builds ``csrc/parity_tail.cu``
alone and runs only the ``fused_tail`` phase's kernel checks and times
(the three lines before its steps), then times T1/T2 against C at the
flagship's map (``parity_tail_by_c``), in about a minute.

``python3 chip_smoke.py --cf`` builds ``csrc/depthwise_cf.cu`` alone and
runs K6 and K7 at Xception's eight sites in float32 and bfloat16 (each
against its plain version, timed beside it, cuDNN and the byte bound),
then their sums over a forward and a train step, in about a minute.  Copied
into an unpacked older tree and run there beside this tree in one call, it
times two versions of the kernels on one card.

``python3 chip_smoke.py --train-quality`` builds the kernels and runs the
``train_quality`` phase alone, in about four minutes.

Any failed check exits non-zero.  Long outputs (the per-site table
``kernel_sites.json``, the profiles ``[xception_]segment_profile.txt`` and
``[xception_]train_profile.txt`` and the other models' ``<model>_*``, the
gradient tables) go to ``chiprun_out/``.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BATCH, SIZE, CLASSES = 16, 512, 21
OUT = Path("chiprun_out")
SEGMENT_CALLS, TRAIN_STEPS = 4, 6
TPU_SOURCES = {
    "depthwise_fwd_s1": "deeplabv3plus_keras_tpu/kernels/depthwise3.py:318",
    "depthwise_fwd_s2": "deeplabv3plus_keras_tpu/kernels/depthwise3.py:684",
    "depthwise_bwd_s1": "deeplabv3plus_keras_tpu/kernels/depthwise3.py:422",
    "depthwise_bwd_s2": "deeplabv3plus_keras_tpu/kernels/depthwise3.py:798",
    "upsample_argmax": "deeplabv3plus_keras_tpu/kernels/upsample_argmax.py:89",
    "depthwise_fwd_cf": "deeplabv3plus_keras_tpu/kernels/depthwise3.py:105",
    "depthwise_bwd_cf": "deeplabv3plus_keras_tpu/kernels/depthwise3.py:185",
    # T1/T2 port the jnp function tail_loss_cm, not a Pallas call
    "parity_tail_fwd": "deeplabv3plus_keras_tpu/ops/parity_tail.py:84",
    "parity_tail_bwd": "deeplabv3plus_keras_tpu/ops/parity_tail.py:84",
}
SOURCES = {
    "depthwise_fwd_s1": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_fwd.cu",
    "depthwise_fwd_s2": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_fwd.cu",
    "depthwise_bwd_s1": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_bwd.cu",
    "depthwise_bwd_s2": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_bwd.cu",
    "upsample_argmax": "deeplabv3plus_keras_tpu_torch/csrc/upsample_argmax.cu",
    "depthwise_fwd_cf": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_cf.cu",
    "depthwise_bwd_cf": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_cf.cu",
    "parity_tail_fwd": "deeplabv3plus_keras_tpu_torch/csrc/parity_tail.cu",
    "parity_tail_bwd": "deeplabv3plus_keras_tpu_torch/csrc/parity_tail.cu",
}
# The path whose launches a kernel's "launches" reports: the one it was
# ported for.
MAIN_PATH = {
    "upsample_argmax": "segment", "depthwise_fwd_s1": "segment", "depthwise_fwd_s2": "segment",
    "depthwise_bwd_s1": "train_step", "depthwise_bwd_s2": "train_step",
    "depthwise_fwd_cf": "xception_segment", "depthwise_bwd_cf": "xception_train_step",
    "parity_tail_fwd": "train_step_fused_tail", "parity_tail_bwd": "train_step_fused_tail",
}


def flagship_conf(image_size: int = SIZE, batch: int = BATCH) -> dict:
    """The JAX package's benchmarked configuration (its ``__graft_entry__``
    flagship): MobileNetV2 + boundary refinement, the reference's five
    split-separable dilated ASPP branches."""
    rates = [(1, 1), (18, 15), (6, 3), (1, 1), (6, 21)]
    inputs = [-1, 0, 1, 0, 0]
    return {
        "base_model": "mobilenetv2",
        "hps": {"dtype": "float32", "batch_size": batch},
        "nn_arch": {
            "boundary_refinement": True,
            "output_stride": 16,
            "image_size": image_size,
            "num_classes": CLASSES,
            "encoder_middle_conf": [
                {"op": "conv", "kernel": 3, "rate": list(r), "input": i}
                for r, i in zip(rates, inputs)
            ],
        },
    }


def xception_conf(image_size: int = SIZE, batch: int = BATCH) -> dict:
    """The flagship's settings with the reference's second headline
    backbone, Xception, and the ASPP the reference pairs with it
    (``encoder_middle_conf_xception``, as ``bench.py:58-74``)."""
    conf = flagship_conf(image_size, batch)
    conf["base_model"] = "xception"
    conf["nn_arch"]["encoder_middle_conf"] = [
        {"op": "conv", "kernel": 3, "rate": [r, r], "input": -1 if r == 1 else 0}
        for r in (1, 6, 12, 18)
    ] + [{"op": "pyramid_pooling", "kernel": 1, "input": 0, "target_size_factor": [1, 1]}]
    return conf


def backbone_conf(base_model: str):
    """The flagship's JSON config (ASPP, boundary refinement, 21 classes)
    with ``base_model`` swapped: a conf factory ``(image_size, batch)``."""

    def conf(image_size: int = SIZE, batch: int = BATCH) -> dict:
        c = flagship_conf(image_size, batch)
        c["base_model"] = base_model
        return c

    return conf


# The three backbones driven at full size (512², B=16), with their depthwise
# launches a forward (backbone and ASPP), and the nine variants swept at
# 128², B=2.
NEW_MODELS = {
    "efficientnetb0": {"depthwise_fwd_s1": 13, "depthwise_fwd_s2": 3},
    "nasnetmobile": {"depthwise_fwd_s1": 93, "depthwise_fwd_s2": 12},
    "densenet121": {"depthwise_fwd_s1": 5},
}
SWEEP = tuple(f"efficientnetb{i}" for i in range(1, 8)) + ("nasnetlarge", "densenet169",
                                                           "densenet201")
SWEEP_BATCH, SWEEP_SIZE = 2, 128


def no_stochastic_depth(model) -> None:
    """Set EfficientNet's stochastic-depth rates to 0 (the JAX module's
    ``drop_connect_rate`` 0), for steps compared across devices whose
    generators differ."""
    from deeplabv3plus_keras_tpu_torch.models.blocks import Dropout

    for m in model.modules():
        if isinstance(m, Dropout) and m.per_sample:
            m.rate = 0.0


@contextlib.contextmanager
def dw_layout(value: str):
    """Set ``DLV3_DW_LAYOUT`` for the block and restore it after."""
    old = os.environ.get("DLV3_DW_LAYOUT")
    os.environ["DLV3_DW_LAYOUT"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DLV3_DW_LAYOUT")
        else:
            os.environ["DLV3_DW_LAYOUT"] = old


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed between two CUDA events, so host-side wrapper time
    (Python, ctypes) does not hide the device time at small shapes."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_mem = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def calibrate_bn(model, images) -> None:
    """Set every BN's running statistics to one batch's statistics (a
    forward in train mode with Keras momentum 0), so random weights give
    activations of a realistic scale instead of ones that shrink layer by
    layer.  Deterministic given the seed."""
    import torch

    from deeplabv3plus_keras_tpu_torch.models.blocks import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(images, generator=torch.Generator(device=images.device).manual_seed(0))
    model.eval()
    for m, mom in zip(bns, saved):
        m.momentum = mom


def depthwise_sites(model, images):
    """(shape, stride, dilation, module) of every depthwise call in one
    forward of ``model`` on ``images``, in call order.  Every input must
    already be ``channels_last`` (``DepthwiseConv.forward``'s
    ``.contiguous`` a no-op, no copy a site)."""
    import torch

    from deeplabv3plus_keras_tpu_torch.models.blocks import DepthwiseConv

    sites, copied = [], []

    def hook(mod, args):
        sites.append((tuple(args[0].shape), mod.strides, mod.dilation, mod))
        if not args[0].is_contiguous(memory_format=torch.channels_last):
            copied.append(sites[-1][:3])

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, DepthwiseConv)]
    try:
        with torch.inference_mode():
            model(images, return_presample=True)
    finally:
        for h in hooks:
            h.remove()
    if copied:
        raise SystemExit(f"depthwise inputs not channels_last (a copy each): {copied[:4]} "
                         f"({len(copied)} of {len(sites)})")
    return sites


def _add_site(agg: dict, row: dict, mult: int) -> None:
    """Add one site's times, ``mult`` times (its calls per pass), to its
    kernel's sums."""
    a = agg.setdefault(row["kernel"], dict(max_abs_err=0.0, bound_by=row["bound_by"]))
    for f in ("ms", "plain_ms", "library_ms", "bound_ms", "route_ms", "nhwc_kernel_ms"):
        if f in row:
            a[f] = a.get(f, 0.0) + mult * row[f]
    a["max_abs_err"] = max(a["max_abs_err"], row["max_abs_err"])


# Bounds of a low-precision kernel against the plain version in float64 on
# the same (rounded) inputs: the output's rounding, 2^-8 (bfloat16) and
# 2^-11 (float16) relative.
LOW_REL = {"bfloat16": 1e-2, "float16": 1e-3}


def check_depthwise(sites, g, rows, dtype="float32"):
    """Kernel vs plain at each distinct site; returns per-kernel sums.  In
    bfloat16/float16 the inputs are in that dtype (taps rounded to it), the
    kernel is held against the plain version in float64 on the same values,
    and the plain and library times are cuDNN's in that dtype."""
    import torch
    import torch.nn.functional as F

    from deeplabv3plus_keras_tpu_torch.kernels import depthwise_conv, depthwise_conv_plain, same_pads
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import _fwd_plan, _ptr_align

    distinct = {}
    for shape, stride, dil, mod in sites:
        key = (shape, stride, dil, tuple(mod.weight.shape))
        distinct.setdefault(key, [mod, 0])[1] += 1
    agg = {}
    for (shape, stride, dil, wshape), (mod, mult) in distinct.items():
        B, C, H, W = shape
        tdt = getattr(torch, dtype)
        x = torch.randn(shape, device="cuda", generator=g).to(tdt).contiguous(
            memory_format=torch.channels_last)
        w = mod.weight.detach().to(tdt)
        k = w.shape[-1]
        y = depthwise_conv(x, w, stride, dil)
        if dtype == "float32":
            ref = depthwise_conv_plain(x, w, stride, dil)
        else:
            ref = depthwise_conv_plain(x.double(), w.double(), stride, dil)
        torch.cuda.synchronize()
        err = (y.double() - ref.double()).abs().max().item()
        scale = ref.abs().max().item()
        ok = y.dtype == tdt and err <= LOW_REL.get(dtype, 1e-5) * scale
        # cuDNN pads symmetrically: where TF pads (0, 1) (stride 2, even
        # size) it gets (1, 1), so that it computes as many outputs as the
        # kernel from the same input (a window one pixel up and left)
        ph = max(same_pads(H, k, stride, dil[0])[1:])
        pw = max(same_pads(W, k, stride, dil[1])[1:])
        lib = lambda: F.conv2d(x, w, stride=stride, padding=(ph, pw), dilation=dil, groups=C)  # noqa: E731
        if lib().shape != y.shape:
            raise SystemExit(f"library call's output {tuple(lib().shape)} is not {tuple(y.shape)}")
        row = {
            "kernel": f"depthwise_fwd_s{stride}", "dtype": dtype, "shape_nchw": list(shape), "k": k,
            "stride": stride, "dilation": list(dil), "per_forward": mult,
            "max_abs_err": err, "max_abs_ref": scale, "ok": ok,
            "ms": cuda_ms(lambda: depthwise_conv(x, w, stride, dil)),
            "plain_ms": cuda_ms(lambda: depthwise_conv_plain(x, w, stride, dil)),
            "library_ms": cuda_ms(lib),
        }
        b_ms, b_by = bound((x.numel() + y.numel()) * x.element_size() + w.numel() * 4,
                           2 * k * k * y.numel())
        plan = _fwd_plan(B, C, H, W, k, stride, tuple(dil), x.dtype, _ptr_align(x, y))
        row.update(bound_ms=b_ms, bound_by=b_by, plan={
            "variant": plan.variant, "vec": plan.vec, "tile_hwc": [plan.th, plan.tw, plan.cb],
            "threads": plan.threads, "grid": list(plan.grid), "smem": plan.smem})
        pt, pl = same_pads(H, k, stride, dil[0])[1], same_pads(W, k, stride, dil[1])[1]
        if (pt, pl) != (ph, pw):
            # the yardstick of earlier runs, timed beside it: the before
            # pads alone, which gives one output row and column fewer
            row["library_before_pads_ms"] = cuda_ms(
                lambda: F.conv2d(x, w, stride=stride, padding=(pt, pl), dilation=dil, groups=C))
        rows.append(row)
        print(json.dumps({"site": row}))
        if not ok:
            raise SystemExit(f"depthwise kernel disagrees with plain at {row}")
        _add_site(agg, row, mult)
    return agg


def check_depthwise_backward(sites, g, rows, dtype="float32"):
    """K4/K5 (dx and dk) vs the plain backward at each distinct site of a
    training step; returns per-kernel sums over one step's sites.  In
    bfloat16/float16, x and g are in that dtype and the weight float32 with
    the dtype's values (so dk stays a float32 sum), held against the plain
    backward in float64 on the same values; plain and library times are
    cuDNN's in that dtype."""
    import torch

    from deeplabv3plus_keras_tpu_torch.kernels import (
        depthwise_conv_backward,
        depthwise_conv_backward_plain,
        same_pads,
    )
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import _bwd_plan, _ptr_align

    cl = torch.channels_last
    distinct = {}
    for shape, stride, dil, mod in sites:
        key = (shape, stride, dil, tuple(mod.weight.shape))
        distinct.setdefault(key, [mod, 0])[1] += 1
    agg = {}
    for (shape, stride, dil, _), (mod, mult) in distinct.items():
        B, C, H, W = shape
        tdt = getattr(torch, dtype)
        w = mod.weight.detach().to(tdt).float()
        k = w.shape[-1]
        Ho, pt, pb = same_pads(H, k, stride, dil[0])
        Wo, pl, pr = same_pads(W, k, stride, dil[1])
        x = torch.randn(shape, device="cuda", generator=g).to(tdt).contiguous(memory_format=cl)
        gout = torch.randn((B, C, Ho, Wo), device="cuda", generator=g).to(tdt).contiguous(
            memory_format=cl)
        dx, dk = depthwise_conv_backward(x, w, gout, stride, dil)
        dx2, dk2 = depthwise_conv_backward(x, w, gout, stride, dil)
        f64 = dtype != "float32"  # the plain backward in float64 on the same values
        cast = (lambda t: t.double()) if f64 else (lambda t: t)
        rdx, rdk = depthwise_conv_backward_plain(cast(x), cast(w), cast(gout), stride, dil)
        _, dk_abs = depthwise_conv_backward_plain(cast(x).abs(), cast(w), cast(gout).abs(), stride, dil)
        torch.cuda.synchronize()
        dx_err = (dx.double() - rdx.double()).abs().max().item()
        dx_scale = rdx.abs().max().item()
        dk_err = (dk.double() - rdk.double()).abs().max().item()
        # dk: 1e-4 of Σ|x·g| per tap and channel, the float32 sum's scale;
        # no atomics, so two runs give the same bits
        dk_ok = bool(((dk.double() - rdk.double()).abs() <= 1e-4 * dk_abs.double()).all())
        same_bits = torch.equal(dk, dk2) and torch.equal(dx, dx2)
        ok = dx.dtype == tdt and dx_err <= LOW_REL.get(dtype, 1e-5) * dx_scale and dk_ok and same_bits
        del dx2, dk2
        if pt == pb and pl == pr:  # cuDNN pads symmetrically itself
            lib_x, lib_pad = x, [pt, pl]
        else:  # stride 2, TF SAME (0, 1): pad once, outside the timed call
            lib_x, lib_pad = torch.nn.functional.pad(x, (pl, pr, pt, pb)), [0, 0]
        wt = w.to(tdt)  # cuDNN and the plain version take the weight in x's dtype
        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            gout, lib_x, wt, None, [stride, stride], lib_pad, list(dil), False, [0, 0], C,
            [True, True, False])
        name = f"depthwise_bwd_s{stride}"
        row = {
            "kernel": name, "dtype": dtype, "shape_nchw": list(shape), "k": k, "stride": stride,
            "dilation": list(dil), "per_step": mult, "max_abs_err": max(dx_err, dk_err),
            "dx_max_abs_err": dx_err, "dx_max_abs_ref": dx_scale, "dk_max_abs_err": dk_err,
            "dk_max_abs_ref": rdk.abs().max().item(), "dk_bit_reproducible": same_bits, "ok": ok,
            "ms": cuda_ms(lambda: depthwise_conv_backward(x, w, gout, stride, dil)),
            "plain_ms": cuda_ms(lambda: depthwise_conv_backward_plain(x, wt, gout, stride, dil)),
            "library_ms": cuda_ms(lib),
        }
        # x and g read once, dx written once; k² multiply-adds per output
        # element for dx and again for dk
        b_ms, b_by = bound((x.numel() + gout.numel() + dx.numel()) * x.element_size()
                           + 2 * w.numel() * 4, 4 * k * k * gout.numel())
        plan = _bwd_plan(B, C, H, W, k, stride, tuple(dil), x.dtype, _ptr_align(x, gout, dx))
        row.update(bound_ms=b_ms, bound_by=b_by, plan={
            "variant": plan.variant, "vec": plan.vec, "tile_hwc": [plan.th, plan.tw, plan.cb],
            "threads": plan.threads, "walk": plan.walk, "grid": list(plan.grid), "smem": plan.smem,
            "dk_buffer": list(plan.dk_buffer)})
        rows.append(row)
        print(json.dumps({"site": row}))
        if not ok:
            raise SystemExit(f"depthwise backward kernel disagrees with plain at {row}")
        _add_site(agg, row, mult)
    return agg


# Xception's 8 distinct K6/K7 sites at B=16, 512², output stride 16, with
# their calls a forward (K6) and a train step (K7)
XCEPTION_CF_SITES = {
    (16, 64, 253, 253): 1, (16, 128, 253, 253): 1, (16, 128, 127, 127): 1, (16, 256, 127, 127): 1,
    (16, 256, 64, 64): 1, (16, 728, 64, 64): 1, (16, 728, 32, 32): 26, (16, 1024, 32, 32): 1,
}


def plan_fields(p) -> dict:
    """A K6 plan as the site lines show it."""
    return {"mode": p.mode, "block": [p.ncx, p.nry], "r": p.r, "tile_rows": p.th, "planes": p.planes,
            "tiles": p.tiles, "walk": p.walk, "grid": list(p.grid), "smem": p.smem}


def cf_site_rows(shape, mult: int, w, g, alone: bool) -> list:
    """K6/K7 (the channels-first kernels) vs the plain forward and backward
    at one k3 stride-1 undilated site in float32, NCHW-contiguous inputs;
    y, dx and dk of two runs must agree bit for bit.  Timed beside the
    plain versions and cuDNN's grouped conv and ``convolution_backward``
    on the NCHW-contiguous input; in a model's phase (not ``alone``), also
    as the whole route (``depthwise_conv`` under ``bhcw``: x and g made
    NCHW-contiguous, dx and y returned to ``channels_last``) and as K2/K4
    on the same site in ``channels_last`` (K4 checked there too).  Returns
    the (K6, K7) rows."""
    import torch
    import torch.nn.functional as F

    from deeplabv3plus_keras_tpu_torch.kernels import (
        depthwise_cf,
        depthwise_cf_backward,
        depthwise_conv,
        depthwise_conv_backward,
        depthwise_conv_backward_plain,
        depthwise_conv_plain,
    )
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import _cf_bwd_plan, _cf_fwd_plan, _ptr_align

    cl = torch.channels_last
    B, C, H, W = shape
    x = torch.randn(shape, device="cuda", generator=g)
    gout = torch.randn(shape, device="cuda", generator=g)
    y = depthwise_cf(x, w)
    y2 = depthwise_cf(x, w)
    ref = depthwise_conv_plain(x, w)
    dx, dk = depthwise_cf_backward(x, w, gout)
    dx2, dk2 = depthwise_cf_backward(x, w, gout)
    rdx, rdk = depthwise_conv_backward_plain(x, w, gout)
    _, dk_abs = depthwise_conv_backward_plain(x.abs(), w, gout.abs())
    torch.cuda.synchronize()
    y_err, y_scale = (y - ref).abs().max().item(), ref.abs().max().item()
    dx_err, dx_scale = (dx - rdx).abs().max().item(), rdx.abs().max().item()
    dk_err = (dk - rdk).abs().max().item()
    same_bits = torch.equal(dk, dk2) and torch.equal(dx, dx2)
    y_same = torch.equal(y, y2)
    # forward as K2, dx as K4: float32 rounding of 9-term sums; dk 1e-4
    # of Σ|x·g| per tap and channel, the float32 sum's scale
    fwd_ok = y_err <= 1e-5 * y_scale and y_same
    bwd_ok = dx_err <= 1e-5 * dx_scale and bool(((dk - rdk).abs() <= 1e-4 * dk_abs).all())
    k4_ok = None
    if not alone:
        x_cl, g_cl = x.contiguous(memory_format=cl), gout.contiguous(memory_format=cl)
        with dw_layout("nhwc"):  # K4 at the same site, by the same rule, two runs
            ndx, ndk = depthwise_conv_backward(x_cl, w, g_cl)
            ndx2, ndk2 = depthwise_conv_backward(x_cl, w, g_cl)
        k4_ok = ((ndx - rdx).abs().max().item() <= 1e-5 * dx_scale
                 and bool(((ndk - rdk).abs() <= 1e-4 * dk_abs).all())
                 and torch.equal(ndk, ndk2) and torch.equal(ndx, ndx2))
        del ndx, ndk, ndx2, ndk2
    del y, y2, ref, dx, dx2, dk2, rdx, dk_abs
    common = {"shape_nchw": list(shape), "k": 3, "stride": 1, "dilation": [1, 1], "model": "xception"}
    fwd = dict(
        common, kernel="depthwise_fwd_cf", per_forward=mult, max_abs_err=y_err,
        max_abs_ref=y_scale, y_bit_reproducible=y_same, ok=fwd_ok,
        ms=cuda_ms(lambda: depthwise_cf(x, w)),
        plain_ms=cuda_ms(lambda: depthwise_conv_plain(x, w)),
        library_ms=cuda_ms(lambda: F.conv2d(x, w, padding=1, groups=C)))
    b_ms, b_by = bound((x.numel() * 2 + w.numel()) * 4, 2 * 9 * x.numel())
    fwd.update(bound_ms=b_ms, bound_by=b_by,
               plan=plan_fields(_cf_fwd_plan(B, C, H, W, x.dtype, _ptr_align(x))))
    lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        gout, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], C, [True, True, False])
    bwd = dict(
        common, kernel="depthwise_bwd_cf", per_step=mult, max_abs_err=max(dx_err, dk_err),
        dx_max_abs_err=dx_err, dx_max_abs_ref=dx_scale, dk_max_abs_err=dk_err,
        dk_max_abs_ref=rdk.abs().max().item(), dk_bit_reproducible=same_bits,
        ok=bwd_ok and same_bits,
        ms=cuda_ms(lambda: depthwise_cf_backward(x, w, gout)),
        plain_ms=cuda_ms(lambda: depthwise_conv_backward_plain(x, w, gout)),
        library_ms=cuda_ms(lib))
    # x and g read once, dx written once; 9 multiply-adds per element
    # for dx and again for dk
    b_ms, b_by = bound((x.numel() * 3 + 2 * w.numel()) * 4, 4 * 9 * x.numel())
    plan = _cf_bwd_plan(B, C, H, W, x.dtype, _ptr_align(x, gout))
    bwd.update(bound_ms=b_ms, bound_by=b_by, plan={
        "mode": plan.mode, "block": [plan.ncx, plan.nry], "r": plan.r,
        "tile_rows": plan.th, "tiles": plan.tiles, "walk": plan.walk,
        "groups": plan.groups, "grid": list(plan.grid), "smem": plan.smem})
    if not alone:
        bwd["nhwc_kernel_ok"] = k4_ok
        with dw_layout("bhcw"):
            fwd["route_ms"] = cuda_ms(lambda: depthwise_conv(x_cl, w))
            bwd["route_ms"] = cuda_ms(lambda: depthwise_conv_backward(x_cl, w, g_cl))
        with dw_layout("nhwc"):
            fwd["nhwc_kernel_ms"] = cuda_ms(lambda: depthwise_conv(x_cl, w))
            bwd["nhwc_kernel_ms"] = cuda_ms(lambda: depthwise_conv_backward(x_cl, w, g_cl))
        fwd["nhwc_kernel"], bwd["nhwc_kernel"] = "depthwise_fwd_s1", "depthwise_bwd_s1"
    return [fwd, bwd]


def cf_site_rows_bf16(shape, mult: int, w, g) -> list:
    """K6/K7 in bfloat16 (not on the float32 paths) at one site, against
    the plain version in float64 on the same values (1e-2 of the largest
    output); y the same bits in two runs; times beside cuDNN's in bfloat16
    and the 16-bit byte bound.  Returns the (K6, K7) rows."""
    import torch
    import torch.nn.functional as F

    from deeplabv3plus_keras_tpu_torch.kernels import (
        depthwise_cf,
        depthwise_cf_backward,
        depthwise_conv_backward_plain,
        depthwise_conv_plain,
    )
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import _cf_fwd_plan, _ptr_align

    B, C, H, W = shape
    x = torch.randn(shape, device="cuda", generator=g).bfloat16()
    gout = torch.randn(shape, device="cuda", generator=g).bfloat16()
    w = w.bfloat16().float()
    wr, wt = w.double(), w.bfloat16()
    y = depthwise_cf(x, w)
    y2 = depthwise_cf(x, w)
    dx, dk = depthwise_cf_backward(x, w, gout)
    ref = depthwise_conv_plain(x.double(), wr)
    rdx, rdk = depthwise_conv_backward_plain(x.double(), wr, gout.double())
    _, dk_abs = depthwise_conv_backward_plain(x.double().abs(), wr, gout.double().abs())
    y_err = (y.double() - ref).abs().max().item()
    dx_err = (dx.double() - rdx).abs().max().item()
    ok = (y_err <= 1e-2 * ref.abs().max().item() and dx_err <= 1e-2 * rdx.abs().max().item()
          and bool(((dk.double() - rdk).abs() <= 1e-4 * dk_abs).all()) and torch.equal(y, y2))
    del y, y2, dx, dk, ref, rdx, rdk, dk_abs
    common = {"shape_nchw": list(shape), "k": 3, "stride": 1, "dilation": [1, 1],
              "model": "xception_bfloat16", "dtype": "bfloat16", "ok": ok}
    lib_b = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        gout, x, wt, None, [1, 1], [1, 1], [1, 1], False, [0, 0], C, [True, True, False])
    fwd = dict(common, kernel="depthwise_fwd_cf", per_forward=mult, max_abs_err=y_err,
               ms=cuda_ms(lambda: depthwise_cf(x, w)),
               plain_ms=cuda_ms(lambda: depthwise_conv_plain(x, w)),
               library_ms=cuda_ms(lambda: F.conv2d(x, wt, padding=1, groups=C)))
    fwd.update(zip(("bound_ms", "bound_by"), bound(x.numel() * 2 * 2 + w.numel() * 4,
                                                   2 * 9 * x.numel())))
    fwd["plan"] = plan_fields(_cf_fwd_plan(B, C, H, W, x.dtype, _ptr_align(x)))
    bwd = dict(common, kernel="depthwise_bwd_cf", per_step=mult, max_abs_err=dx_err,
               ms=cuda_ms(lambda: depthwise_cf_backward(x, w, gout)),
               plain_ms=cuda_ms(lambda: depthwise_conv_backward_plain(x, wt, gout)),
               library_ms=cuda_ms(lib_b))
    bwd.update(zip(("bound_ms", "bound_by"), bound(x.numel() * 3 * 2 + 2 * w.numel() * 4,
                                                   4 * 9 * x.numel())))
    return [fwd, bwd]


def check_cf(sites, g, rows):
    """K6/K7 at each distinct k3 stride-1 undilated site of ``sites``: in
    float32 by :func:`cf_site_rows` (beside the route and K2/K4), then in
    bfloat16 by :func:`cf_site_rows_bf16`.  Returns per-kernel sums over
    one pass (a forward for K6, a train step for K7), the bfloat16 sums
    under ``"bfloat16"``."""
    distinct = {}
    for shape, stride, dil, mod in sites:
        if (mod.weight.shape[-1], stride, tuple(dil)) == (3, 1, (1, 1)):
            distinct.setdefault(shape, [mod, 0])[1] += 1
    agg, low = {}, {}
    for dtype, sums in (("float32", agg), ("bfloat16", low)):
        for shape, (mod, mult) in distinct.items():
            w = mod.weight.detach()
            site = (cf_site_rows(shape, mult, w, g, alone=False) if dtype == "float32"
                    else cf_site_rows_bf16(shape, mult, w, g))
            for row in site:
                rows.append(row)
                print(json.dumps({"site": row}))
                if not row["ok"] or not row.get("nhwc_kernel_ok", True):
                    raise SystemExit(f"channels-first kernel (or K4 beside it) disagrees with plain at {row}")
                _add_site(sums, row, mult)
    for name, sums in low.items():
        agg[name]["bfloat16"] = sums
    return agg


def check_upsample_argmax(shape, scale, g, rows):
    import torch
    import torch.nn.functional as F

    from deeplabv3plus_keras_tpu_torch.kernels import upsample_argmax, upsample_argmax_plain
    from deeplabv3plus_keras_tpu_torch.kernels.upsample_argmax import _upsample_argmax_plan

    B, h, w, C = shape
    logits = torch.randn(shape, device="cuda", generator=g)
    lab = upsample_argmax(logits, scale)
    ref = upsample_argmax_plain(logits, scale)
    up = F.interpolate(logits.permute(0, 3, 1, 2), scale_factor=scale, mode="bilinear",
                       align_corners=False)
    top2 = up.topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 1e-5
    diff = lab != ref
    n = diff.numel()
    bad = int((diff & ~near_tie).sum())
    ties = int((diff & near_tie).sum())
    # error as the logit value lost: plain's choice minus the kernel's,
    # nonzero only where the two picked different classes
    v_k = up.gather(1, lab[:, None].long())
    v_r = up.gather(1, ref[:, None].long())
    err = (v_r - v_k).abs().max().item()
    del up, top2, v_k, v_r
    row = {
        "kernel": "upsample_argmax", "shape_nhwc": list(shape), "scale": scale, "per_forward": 1,
        "mismatch_not_tie": bad, "mismatch_near_tie": ties, "pixels": n,
        "ok": bad == 0 and ties <= 1e-5 * n,
        "ms": cuda_ms(lambda: upsample_argmax(logits, scale)),
        "plain_ms": cuda_ms(lambda: upsample_argmax_plain(logits, scale)),
        # F.interpolate + argmax: the same two calls as the plain version
        "library_ms": cuda_ms(lambda: F.interpolate(
            logits.permute(0, 3, 1, 2), scale_factor=scale, mode="bilinear",
            align_corners=False).argmax(1)),
    }
    b_ms, b_by = bound(logits.numel() * 4 + lab.numel() * 4, 7 * C * lab.numel())
    plan = _upsample_argmax_plan(B, h, w, C, scale)
    row.update(bound_ms=b_ms, bound_by=b_by, max_abs_err=err, plan={
        "band_rows": plan.bh, "tile_cols": plan.bw, "grid": list(plan.grid), "smem": plan.smem})
    rows.append(row)
    print(json.dumps({"site": row}))
    if not row["ok"]:
        raise SystemExit(f"upsample_argmax disagrees with plain: {row}")
    return {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}


def train_batches(n: int, batch: int, size: int, device: str, seed: int) -> list[dict]:
    """Random images in (−1, 1) and one-hot labels (the reference's label
    layout), made on ``device`` from a seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        image = torch.rand(batch, size, size, 3, device=device, generator=gen) * 2 - 1
        label = torch.randint(0, CLASSES, (batch, size, size), device=device, generator=gen)
        out.append({"image": image,
                    "label": torch.nn.functional.one_hot(label, CLASSES).float(),
                    "valid": torch.ones(batch, dtype=torch.int32, device=device)})
    return out


def profile_device(fn, path: Path, header: str, rows: int) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the table to ``path``,
    and the device time by kernel (device-side events are the kernels and
    copies themselves)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows)
    path.write_text(f"{header}\n{table}\n")
    dev = {e.key: e.self_device_time_total for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": sum(dev.values()) / 1e3,
            "top_kernels_ms": [[k[:60], v / 1e3] for k, v in top]}


# "<prefix>segment" / "<prefix>train_step": a profiled call's device ms and
# images/s with TF32 off, as run_serving and run_training measured them
PATH_TIMES: dict[str, dict] = {}


def run_serving(seg, kernels, card: str, batches, expect: dict, name: str) -> dict:
    """The serving path: ``segment()`` on each of ``batches`` with TF32 off;
    checks the labels and the launches of every call, then the labels of
    one image against the same weights served on the CPU.  Returns the
    launch counts of those calls."""
    import torch

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, first_labels = [], None
    for i, images in enumerate(batches):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        labels = seg.segment(images)
        times.append(time.perf_counter() - t)
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != expect:
            raise SystemExit(f"{name} segment() call {i}: launches {delta}, expected {expect}")
        if labels.shape != (BATCH, SIZE, SIZE) or labels.dtype.name != "int32":
            raise SystemExit(f"labels {labels.shape} {labels.dtype}")
        if labels.min() < 0 or labels.max() >= CLASSES:
            raise SystemExit(f"labels outside [0, {CLASSES}): {labels.min()}..{labels.max()}")
        if i == 0:
            first_labels = labels
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    img_s = BATCH / statistics.median(times[1:])

    # TF32 on (torch's default for cuDNN convs): throughput only
    torch.backends.cudnn.allow_tf32 = True
    tf32_times = []
    for images in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        seg.segment(images)
        tf32_times.append(time.perf_counter() - t)
    torch.backends.cudnn.allow_tf32 = False

    prefix = "" if name == "mobilenetv2" else f"{name}_"
    prof = profile_device(lambda: seg.segment(batches[1]), OUT / f"{prefix}segment_profile.txt",
                          f"{card}\n{name}, TF32 off, B={BATCH}, {SIZE}^2", 25)
    print(json.dumps({"model": name, "segment_device_ms": prof["device_ms"],
                      "top_kernels_ms": prof["top_kernels_ms"]}))
    PATH_TIMES[f"{prefix}segment"] = {"device_ms": prof["device_ms"], "img_per_s": img_s}

    # one image against the same weights served on the CPU
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    cpu = SemanticSegmentation(seg.conf, device="cpu")
    cpu.model.load_state_dict(seg.model.state_dict())
    torch.set_num_threads(8)
    cpu_labels = cpu.segment(batches[0][:1])
    agree = float((cpu_labels[0] == first_labels[0]).mean())
    classes_seen = int(len(set(first_labels[0].ravel().tolist())))
    print(json.dumps({"segment": {
        "model": name, "batch": BATCH, "image": SIZE, "dtype": "float32", "calls": len(batches),
        "img_per_s_tf32_off": img_s, "img_per_s_tf32_on": BATCH / statistics.median(tf32_times),
        "call_s_tf32_off": times, "call_s_tf32_on": tf32_times,
        "cpu_agreement": agree, "classes_in_image0": classes_seen, "launches": launches,
        "max_memory_allocated_gib": peak / 2**30, "card": card}}))
    if agree < 0.999:
        raise SystemExit(f"{name}: card vs CPU labels agree on {agree:.5f} < 0.999 of pixels")
    return launches


def run_training(seg, kernels, card: str, expect: dict, name: str,
                 unreached=frozenset()) -> tuple[dict, float]:
    """The training path: ``TRAIN_STEPS`` steps of ``seg.train_step``
    with TF32 off; checks the loss, the gradients (finite and nonzero, or
    exactly zero for the ``unreached`` parameters, as ``jax.grad`` gives
    them) and the launches of every step.  Returns the launch counts of
    those steps and the images/s."""
    import torch

    batches = train_batches(TRAIN_STEPS, BATCH, SIZE, "cuda", seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    for i, batch in enumerate(batches):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = seg.train_step(batch)
        loss = out["loss"].item()  # waits for the step
        times.append(time.perf_counter() - t)
        losses.append(loss)
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != expect:
            raise SystemExit(f"{name} train_step {i}: launches {delta}, expected {expect}")
        if not math.isfinite(loss) or int(out["cm"].sum()) != BATCH * SIZE * SIZE:
            raise SystemExit(f"{name} train_step {i}: loss {loss}, cm sum {int(out['cm'].sum())}")
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    bad = [n for n, p in seg.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or bool(p.grad.any()) == (n in unreached)]
    if bad:
        raise SystemExit(f"{name}: parameters without a finite nonzero gradient: {bad[:8]} ({len(bad)})")
    step_s = statistics.median(times[1:])

    # TF32 on (torch's default for cuDNN convs): throughput only
    torch.backends.cudnn.allow_tf32 = True
    tf32_times = []
    for batch in batches[1:4]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        seg.train_step(batch)["loss"].item()
        tf32_times.append(time.perf_counter() - t)
    torch.backends.cudnn.allow_tf32 = False

    prefix = "" if name == "mobilenetv2" else f"{name}_"
    prof = profile_device(lambda: seg.train_step(batches[1])["loss"].item(),
                          OUT / f"{prefix}train_profile.txt",
                          f"{card}\n{name}, TF32 off, B={BATCH}, {SIZE}^2, one train_step", 30)
    print(json.dumps({"model": name, "train_step_device_ms": prof["device_ms"],
                      "top_kernels_ms": prof["top_kernels_ms"]}))
    PATH_TIMES[f"{prefix}train_step"] = {"device_ms": prof["device_ms"], "img_per_s": BATCH / step_s}
    print(json.dumps({"train_step": {
        "model": name, "batch": BATCH, "image": SIZE, "dtype": "float32", "steps": TRAIN_STEPS,
        "losses": losses, "step_s_tf32_off": times, "median_step_s_2_on": step_s,
        "img_per_s_tf32_off": BATCH / step_s, "step_s_tf32_on": tf32_times,
        "img_per_s_tf32_on": BATCH / statistics.median(tf32_times),
        "max_memory_allocated_gib": peak / 2**30, "launches": launches, "card": card}}))
    return launches, BATCH / step_s


def _record_outputs(model, outs: list) -> list:
    """Forward hooks appending, in call order, (name, output on the CPU) of
    every module that holds parameters of its own (convs, depthwise convs,
    BN, the classifier); returns the hooks."""
    return [m.register_forward_hook(lambda m, a, o, n=n: outs.append((n, o.detach().cpu())))
            for n, m in model.named_modules() if list(m.parameters(recurse=False))]


def _float64_step(conf, state: dict, batch: dict, outs: list | None = None):
    """The float64 train step on the CPU of ``conf`` from ``state``.  With
    ``outs`` (a float32 step's, :func:`_record_outputs`), every
    parametrised module's output *value* is taken from it and its gradient
    path kept in float64 (``o + (v − o).detach()``): the exact gradient at
    the float32 step's own ReLU masks and max-pool choices.  Returns (the
    model, its gradients in ``.grad``; the loss; the largest relative
    difference between a recorded output and the float64 module's output on
    the same inputs)."""
    import torch

    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.models import DeepLabV3Plus
    from deeplabv3plus_keras_tpu_torch.parallel.step import build_train_step, create_train_state

    ref_conf = Config.from_dict({**conf, "hps": {**conf["hps"], "dtype": "float64"}})
    ref = DeepLabV3Plus(ref_conf)
    ref.load_state_dict(state)
    ref = ref.double().to(memory_format=torch.channels_last)
    no_stochastic_depth(ref)
    worst = [0.0]
    if outs is not None:
        recorded = iter(outs)

        def take(m, a, o, n):
            n_rec, v = next(recorded)
            if n_rec != n:
                raise SystemExit(f"aligned float64 step: module {n} where the float32 step ran {n_rec}")
            v = v.to(o.dtype)
            worst[0] = max(worst[0], ((v - o).norm() / o.norm().clamp_min(1e-300)).item())
            return o + (v - o).detach()

        for n, m in ref.named_modules():
            if list(m.parameters(recurse=False)):
                m.register_forward_hook(lambda m, a, o, n=n: take(m, a, o, n))
    loss = build_train_step(ref, create_train_state(ref_conf, ref), ref_conf)(
        {"image": torch.from_numpy(batch["image"]).double(),
         "label": torch.from_numpy(batch["label"]), "valid": torch.ones(2)})["loss"].item()
    return ref, loss, worst[0]


ALIGNED_FWD_REL = 1e-5


def check_training_against_cpu(conf: dict, name: str) -> None:
    """One train step of ``conf`` (at 2 × 128²) on the card (float32, TF32
    off, the default cuDNN path) and on the CPU in float32 and float64,
    from the same weights and batch (dropout and stochastic depth 0: the
    two devices' generators differ).  The float64 step is the reference for
    the loss: the card's agrees with it to 1e-4 relative.

    Gradients: the train-mode gradient of these nets is discontinuous at
    every ReLU mask and max-pool choice, and float32 rounding moves some
    inputs of those across, so float32 steps on the same weights and batch
    (the CPU's, the card's) lie at unrelated distances from plain float64
    (this function prints both; PERF.md §6).  So the gradients are
    held against float64 at the float32 step's own masks and choices
    (:func:`_float64_step`, one for the card and one for the CPU
    float32 step), where float32 rounding alone is left and a wrong kernel
    or op still gives errors of order 1:
    - every parametrised module's forward on the card within
      ``ALIGNED_FWD_REL`` of float64's on the same inputs;
    - all gradients together: a relative 2-norm error of at most the
      larger of 3e-3 and 3× the CPU float32's;
    - each parameter: max(3e-3·scale, 5e-7) on its largest error, the JAX
      package's bound for its Pallas-vs-lax gradients
      (tests/test_kernels.py:543), or a relative 2-norm error of at most
      0.25;
    and the distances to the plain float64 gradients are printed beside."""
    import numpy as np

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    conf["nn_arch"]["dropout_rate"] = 0.0
    gpu = SemanticSegmentation(conf, device="cuda")
    cpu = SemanticSegmentation(conf, device="cpu")
    state = {k: v.detach().cpu().clone() for k, v in gpu.model.state_dict().items()}
    cpu.model.load_state_dict(state)
    for model in (gpu.model, cpu.model):
        no_stochastic_depth(model)
    rng = np.random.default_rng(5)
    batch = {"image": rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, (2, 128, 128))}
    outs_card, outs_cpu = [], []
    hooks = _record_outputs(gpu.model, outs_card) + _record_outputs(cpu.model, outs_cpu)
    lg = gpu.train_step(batch)["loss"].item()
    lc = cpu.train_step(batch)["loss"].item()
    for h in hooks:
        h.remove()
    ref, l64, _ = _float64_step(conf, state, batch)
    al_card, _, fwd_card = _float64_step(conf, state, batch, outs_card)
    del outs_card
    al_cpu, _, fwd_cpu = _float64_step(conf, state, batch, outs_cpu)
    del outs_cpu
    rows, failed = [], []
    sq = dict.fromkeys(("card", "cpu", "ref", "card_plain", "cpu_plain", "ref_plain"), 0.0)
    for (pname, pg), pc, pa, pac, pr in zip(gpu.model.named_parameters(), cpu.model.parameters(),
                                            al_card.parameters(), al_cpu.parameters(),
                                            ref.parameters()):
        g_card, g_cpu = pg.grad.cpu().double(), pc.grad.double()
        d_card, d_cpu = g_card - pa.grad, g_cpu - pac.grad
        e_card, e_cpu = d_card.abs().max().item(), d_cpu.abs().max().item()
        scale = pa.grad.abs().max().item()
        sq["card"] += d_card.square().sum().item()
        sq["cpu"] += d_cpu.square().sum().item()
        sq["ref"] += pa.grad.square().sum().item()
        sq["card_plain"] += (g_card - pr.grad).square().sum().item()
        sq["cpu_plain"] += (g_cpu - pr.grad).square().sum().item()
        sq["ref_plain"] += pr.grad.square().sum().item()
        rel2 = d_card.norm().item() / max(pa.grad.norm().item(), 1e-30)
        tight = e_card <= max(3e-3 * scale, 5e-7)
        rows.append({"param": pname, "card_err": e_card, "cpu_f32_err": e_cpu,
                     "scale": scale, "card_rel_2norm": rel2, "within_3e-3_scale": tight})
        if not (tight or rel2 <= 0.25):
            failed.append(rows[-1])
    prefix = "" if name == "mobilenetv2" else f"{name}_"
    (OUT / f"{prefix}train_grads.json").write_text(json.dumps(rows, indent=1))
    rel = abs(lg - l64) / abs(l64)
    norm_card, norm_cpu = (math.sqrt(sq[k] / sq["ref"]) for k in ("card", "cpu"))
    plain_card, plain_cpu = (math.sqrt(sq[k] / sq["ref_plain"]) for k in ("card_plain", "cpu_plain"))
    print(json.dumps({"train_step_cpu_agreement": {
        "model": name, "batch": 2, "image": 128, "loss_card": lg, "loss_cpu_f32": lc, "loss_cpu_f64": l64,
        "loss_rel": rel, "params": len(rows),
        "within_3e-3_scale": sum(r["within_3e-3_scale"] for r in rows),
        "cpu_f32_within_3e-3_scale": sum(r["cpu_f32_err"] <= max(3e-3 * r["scale"], 5e-7)
                                         for r in rows),
        "worst_rel_2norm_outside_3e-3_scale": max(
            [r["card_rel_2norm"] for r in rows if not r["within_3e-3_scale"]], default=0.0),
        "grad_rel_2norm_card": norm_card, "grad_rel_2norm_cpu_f32": norm_cpu,
        "module_fwd_rel_card": fwd_card, "module_fwd_rel_cpu_f32": fwd_cpu,
        "plain_f64_grad_rel_2norm_card": plain_card, "plain_f64_grad_rel_2norm_cpu_f32": plain_cpu}}))
    if not fwd_card <= ALIGNED_FWD_REL:
        raise SystemExit(f"{name}: a module's forward on the card is {fwd_card} from float64's")
    if failed:
        raise SystemExit(f"{name}: card gradients off the float64 ones: {failed[:4]} ({len(failed)})")
    if not norm_card <= max(3e-3, 3 * norm_cpu):
        raise SystemExit(f"{name}: card gradients' relative 2-norm error {norm_card} vs CPU float32's {norm_cpu}")
    if not rel <= 1e-4:
        raise SystemExit(f"{name}: card loss {lg} vs CPU float64 {l64}: rel {rel}")


def kernel_summary(rows, name: str, per: str) -> dict:
    """One kernel against its library call and the byte bound, from the
    site rows: sums over one pass of each model's sites that run it
    (``per``: the rows' calls a pass), the worst undilated site whose bound
    is at least 0.015 ms, and every dilated site."""
    out = {}
    krows = [r for r in rows if r["kernel"] == name]
    for model in sorted({r["model"] for r in krows}):
        sites = [r for r in krows if r["model"] == model]
        ms, lib, bnd = (sum(r[per] * r[f] for r in sites) for f in ("ms", "library_ms", "bound_ms"))
        out[f"{name}/{model}"] = {"ms": ms, "library_ms": lib, "bound_ms": bnd,
                                  "x_library": ms / lib, "x_bound": ms / bnd}
    big = [r for r in krows if r["dilation"] == [1, 1] and r["bound_ms"] >= 0.015]
    if big:
        worst = max(big, key=lambda r: r["ms"] / r["library_ms"])
        out[f"{name}/worst_undilated_x_library"] = [worst["shape_nchw"], worst["ms"] / worst["library_ms"]]
    dil = [[r["shape_nchw"], r["dilation"], r["ms"] / r["library_ms"]]
           for r in krows if r["dilation"] != [1, 1]]
    if dil:
        out[f"{name}/dilated_x_library"] = dil
    return out


def forward_summary(rows) -> dict:
    """K2/K3 by :func:`kernel_summary` over one forward of each model;
    ``library_before_pads_ms`` sums the library call as earlier runs timed
    it (before pads only, where they differ from the symmetric pads)."""
    out = {}
    for name in ("depthwise_fwd_s1", "depthwise_fwd_s2"):
        out.update(kernel_summary(rows, name, "per_forward"))
        for model in sorted({r["model"] for r in rows if r["kernel"] == name}):
            out[f"{name}/{model}"]["library_before_pads_ms"] = sum(
                r["per_forward"] * r.get("library_before_pads_ms", r["library_ms"])
                for r in rows if r["kernel"] == name and r["model"] == model)
    return out


def backward_summary(rows) -> dict:
    """K4/K5 by :func:`kernel_summary` over one train step of each model,
    against cuDNN's ``convolution_backward``, and K4 at Xception's
    undilated sites under ``nhwc`` (``nhwc_kernel_ms``, beside K7 and the
    ``bhcw`` route)."""
    out = {}
    for name in ("depthwise_bwd_s1", "depthwise_bwd_s2"):
        out.update(kernel_summary(rows, name, "per_step"))
    cf = [r for r in rows if r["kernel"] == "depthwise_bwd_cf" and "dtype" not in r]
    if cf:
        out["depthwise_bwd_s1/xception_undilated_nhwc"] = {
            f: sum(r["per_step"] * r[k] for r in cf)
            for f, k in (("nhwc_kernel_ms", "nhwc_kernel_ms"), ("k7_ms", "ms"), ("bhcw_route_ms", "route_ms"),
                         ("library_ms", "library_ms"))}
    return out


# K7 before its plan, when a block took one 32 x 32 tile of one plane:
# each Xception site's time and the sum over a train step, chip_smoke.py on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6)
K7_ONE_TILE_MS = {
    (16, 64, 253, 253): 0.5604, (16, 128, 253, 253): 1.0998, (16, 128, 127, 127): 0.2851,
    (16, 256, 127, 127): 0.5550, (16, 256, 64, 64): 0.1496, (16, 728, 64, 64): 0.4012,
    (16, 728, 32, 32): 0.1113, (16, 1024, 32, 32): 0.1516,
}
K7_ONE_TILE_STEP_MS = 6.097


def cf_backward_summary(rows) -> dict:
    """K7 summed over one Xception train step against the byte bound and
    cuDNN's ``convolution_backward``, with each site's plan mode and
    ratios, and beside the one-tile-a-block design's times as recorded
    (``K7_ONE_TILE_MS``, constants of an earlier run, not measured here:
    the ``*_recorded`` fields)."""
    cf = [r for r in rows if r["kernel"] == "depthwise_bwd_cf" and "dtype" not in r]
    ms, lib, bnd = (sum(r["per_step"] * r[f] for r in cf) for f in ("ms", "library_ms", "bound_ms"))
    sites = []
    for r in cf:
        before = K7_ONE_TILE_MS.get(tuple(r["shape_nchw"]))
        sites.append({"shape_nchw": r["shape_nchw"], "per_step": r["per_step"], "ms": r["ms"],
                      "bound_ms": r["bound_ms"], "x_bound": r["ms"] / r["bound_ms"],
                      "x_library": r["ms"] / r["library_ms"], "one_tile_ms_recorded": before,
                      "x_one_tile_recorded": None if before is None else r["ms"] / before,
                      "mode": r["plan"]["mode"], "groups": r["plan"]["groups"]})
    return {"ms": ms, "bound_ms": bnd, "library_ms": lib, "x_bound": ms / bnd, "x_library": ms / lib,
            "one_tile_ms_recorded": K7_ONE_TILE_STEP_MS,
            "x_one_tile_recorded": ms / K7_ONE_TILE_STEP_MS, "sites": sites}


def cf_forward_summary(rows) -> dict:
    """K6 summed over one Xception forward, float32 and bfloat16, against
    the byte bound and cuDNN's grouped conv, with each site's plan and
    ratios."""
    out = {}
    for dtype, model in (("float32", "xception"), ("bfloat16", "xception_bfloat16")):
        cf = [r for r in rows if r["kernel"] == "depthwise_fwd_cf" and r["model"] == model]
        ms, lib, bnd = (sum(r["per_forward"] * r[f] for r in cf) for f in ("ms", "library_ms", "bound_ms"))
        sites = [{"shape_nchw": r["shape_nchw"], "per_forward": r["per_forward"], "ms": r["ms"],
                  "bound_ms": r["bound_ms"], "library_ms": r["library_ms"], "x_bound": r["ms"] / r["bound_ms"],
                  "route_ms": r.get("route_ms"), "plan": r["plan"]} for r in cf]
        out[dtype] = {"ms": ms, "bound_ms": bnd, "library_ms": lib, "x_bound": ms / bnd, "x_library": ms / lib,
                      "bound_share": bnd / ms, "sites": sites}
    return out


def stats_only_cell(model):
    """NASNet's last normal cell runs in training for its BN statistics
    only: the cut reads that cell's input, so the loss reaches none of its
    parameters (``jax.grad`` gives them zeros) and its depthwise sites get
    no backward launch.  Returns (that cell's parameter-name prefix, the
    cell) for a NASNet backbone, else ("", None)."""
    from deeplabv3plus_keras_tpu_torch.models.backbones.nasnet import NASNetBackbone

    if not isinstance(model.base, NASNetBackbone):
        return "", None
    name = model.base.cells[-1][0]
    return f"base.{name}.", getattr(model.base, name)


def depthwise_expect(sites, train: bool = False, stats_only=None) -> dict:
    """Launches per ``segment()`` call (K1 once) or per train step (no K1,
    a backward launch beside each forward one) of a model whose forward
    gives the depthwise kernels ``sites``, under the current layout; in a
    train step also a forward launch, and no backward one, at each
    depthwise module of ``stats_only`` (:func:`stats_only_cell`)."""
    from deeplabv3plus_keras_tpu_torch.kernels import depthwise_route, launch_counts
    from deeplabv3plus_keras_tpu_torch.models.blocks import DepthwiseConv

    def kind(mod, stride, dil):
        return "cf" if depthwise_route(mod.weight, stride, dil) == "cf" else f"s{stride}"

    expect = dict.fromkeys(launch_counts(), 0)
    expect["upsample_argmax"] = 0 if train else 1
    for _, stride, dil, mod in sites:
        k = kind(mod, stride, dil)
        expect[f"depthwise_fwd_{k}"] += 1
        if train:
            expect[f"depthwise_bwd_{k}"] += 1
    if train and stats_only is not None:
        for mod in stats_only.modules():
            if isinstance(mod, DepthwiseConv):
                expect[f"depthwise_fwd_{kind(mod, mod.strides, mod.dilation)}"] += 1
    return expect


def serving_batches() -> list:
    import torch

    return [
        torch.empty(BATCH, SIZE, SIZE, 3).uniform_(-1, 1, generator=torch.Generator().manual_seed(i)).numpy()
        for i in range(SEGMENT_CALLS)
    ]


def drive_model(name: str, conf_fn, kernels, card: str, g, rows, n_sites: dict,
                site_dtypes=()) -> dict:
    """Every phase of one model under the current ``DLV3_DW_LAYOUT``: the
    kernels at its sites, ``segment()``, ``train_step()`` and the 2 × 128²
    step against the CPU.  ``conf_fn(image_size, batch)`` gives the model's
    conf; ``n_sites`` is the expected count of forward launches per kernel;
    ``site_dtypes`` are further dtypes (bfloat16, float16) in which K2–K5
    are held against their plain versions at the model's sites.  Returns
    (per-kernel site sums, launches by path, train_step() images/s with
    TF32 off)."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    t0 = time.perf_counter()
    seg = SemanticSegmentation(conf_fn(), device="cuda")
    batches = serving_batches()
    first = torch.from_numpy(batches[0]).cuda()
    calibrate_bn(seg.model, first)
    sites = depthwise_sites(seg.model, first)
    with torch.inference_mode():
        logits, up = seg.model(first, return_presample=True)
    presample = tuple(logits.shape)
    prefix, stats_only = stats_only_cell(seg.model)
    train_expect = depthwise_expect(sites, True, stats_only)
    unreached = {n for n, _ in seg.model.named_parameters() if prefix and n.startswith(prefix)}
    del logits, first
    expect = depthwise_expect(sites)
    got = {k: v for k, v in expect.items() if k.startswith("depthwise_fwd") and v}
    print(json.dumps({"model": name, "layout": os.environ.get("DLV3_DW_LAYOUT"),
                      "depthwise_launches_per_forward": got,
                      "presample_logits": list(presample), "upsample": up}))
    if got != n_sites:
        raise SystemExit(f"{name}: depthwise launches per forward {got}, expected {n_sites}")

    # ---- each kernel against its plain version, at this model's shapes ----
    n0 = len(rows)
    agg = {}
    if name != "xception":
        agg.update(check_depthwise(sites, g, rows))
        agg["upsample_argmax"] = check_upsample_argmax(presample, up, g, rows)
        agg.update(check_depthwise_backward(sites, g, rows))
    else:  # K6/K7 at the undilated sites; K2/K4 at the dilated ASPP sites
        agg.update(check_cf(sites, g, rows))
        nhwc = [s for s in sites if tuple(s[2]) != (1, 1) or s[1] != 1 or s[3].weight.shape[-1] != 3]
        with dw_layout("nhwc"):
            check_depthwise(nhwc, g, rows)
            check_depthwise_backward(nhwc, g, rows)
    for row in rows[n0:]:
        row.setdefault("model", name)
    for dtype in site_dtypes:
        n1 = len(rows)
        check_depthwise(sites, g, rows, dtype)
        check_depthwise_backward(sites, g, rows, dtype)
        for row in rows[n1:]:
            row["model"] = f"{name}_{dtype}"
    torch.cuda.empty_cache()
    print(json.dumps({"model": name, "phase": "kernel_sites", "s": time.perf_counter() - t0}))

    # ---- the main paths: segment(), then train_step() ----
    by_path = {}
    key = "" if name == "mobilenetv2" else f"{name}_"
    by_path[f"{key}segment"] = run_serving(seg, kernels, card, batches, expect, name)
    print(json.dumps({"model": name, "phase": "segment", "s": time.perf_counter() - t0}))
    by_path[f"{key}train_step"], train_img_s = run_training(seg, kernels, card, train_expect, name,
                                                            unreached)
    print(json.dumps({"model": name, "phase": "train_step", "s": time.perf_counter() - t0}))
    del seg
    torch.cuda.empty_cache()
    check_training_against_cpu(conf_fn(128, batch=2), name)
    print(json.dumps({"model": name, "phase": "cpu_step", "s": time.perf_counter() - t0}))
    return agg, by_path, train_img_s


def check_pools(card: str) -> None:
    """The backbones' pools (``models/blocks.py``) and their gradients on
    ``channels_last`` float32 inputs on the card at NASNet's cell sizes,
    against float64 on the CPU, within 1e-5 of the largest value; beside
    them torch's padded ``F.avg_pool2d``, whose backward of such an input
    ``avg_pool_same_s1`` avoids (printed, not held)."""
    import torch
    import torch.nn.functional as F

    from deeplabv3plus_keras_tpu_torch.models import blocks

    pools = {
        "avg_pool_same_s1": blocks.avg_pool_same_s1,
        "pool_s2_keras_avg": lambda x: blocks.pool_s2_keras(x, 3, "avg"),
        "pool_s2_keras_max": lambda x: blocks.pool_s2_keras(x, 3, "max"),
        "max_pool_same": lambda x: blocks.max_pool_same(x, 3, 2),
        "avg_pool_valid": lambda x: blocks.avg_pool_valid(x, 2),
        "torch_avg_pool2d_padded": lambda x: F.avg_pool2d(x, 3, 1, 1, count_include_pad=False),
    }
    out = {}
    for shape in ((2, 88, 8, 8), (2, 11, 32, 32), (16, 44, 128, 128), (2, 22, 17, 15)):
        g = torch.Generator().manual_seed(1)
        x64 = torch.randn(shape, generator=g, dtype=torch.float64)
        for name, fn in pools.items():
            x = x64.clone().requires_grad_()
            y64 = fn(x)
            g64 = torch.randn(y64.shape, generator=g, dtype=torch.float64)
            y64.backward(g64)
            xc = x64.float().cuda().contiguous(memory_format=torch.channels_last).requires_grad_()
            y = fn(xc)
            y.backward(g64.float().cuda().contiguous(memory_format=torch.channels_last))
            errs = [((y.detach().double().cpu() - y64.detach()).abs().max() / y64.abs().max()).item(),
                    ((xc.grad.double().cpu() - x.grad).abs().max() / x.grad.abs().max()).item()]
            key = f"{name}/{'x'.join(map(str, shape))}"
            out[key] = {"y_rel": errs[0], "dx_rel": errs[1]}
    print(json.dumps({"pools_channels_last": out, "card": card}))
    bad = {k: v for k, v in out.items()
           if not k.startswith("torch_") and not max(v.values()) <= 1e-5}
    if bad:
        raise SystemExit(f"pools on the card off float64: {bad}")


def run_sweep(kernels, card: str, g, rows) -> dict:
    """The nine other variants (EfficientNet B1–B7, NASNet-Large, DenseNet
    169/201) with the flagship's head at ``SWEEP_SIZE``², B=``SWEEP_BATCH``:
    K2–K5 against their plain versions at each variant's distinct sites,
    ``segment()`` (launches, labels against the same weights on the CPU)
    and one ``train_step()`` (launches, finite loss and gradients).
    Returns the launches of the paths ``<variant>_segment`` and
    ``<variant>_train_step``."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    by_path, out = {}, {}
    for variant in SWEEP:
        t0 = time.perf_counter()
        conf = backbone_conf(variant)(SWEEP_SIZE, SWEEP_BATCH)
        seg = SemanticSegmentation(conf, device="cuda")
        images = torch.empty(SWEEP_BATCH, SWEEP_SIZE, SWEEP_SIZE, 3).uniform_(
            -1, 1, generator=torch.Generator().manual_seed(7))
        calibrate_bn(seg.model, images.cuda())
        sites = depthwise_sites(seg.model, images.cuda())
        n0 = len(rows)
        check_depthwise(sites, g, rows)
        check_depthwise_backward(sites, g, rows)
        for row in rows[n0:]:
            row["model"] = f"{variant}_{SWEEP_SIZE}"

        kernels.reset_launch_counts()
        labels = seg.segment(images.numpy())
        by_path[f"{variant}_segment"] = kernels.launch_counts()
        if by_path[f"{variant}_segment"] != depthwise_expect(sites):
            raise SystemExit(f"{variant} segment(): launches {by_path[f'{variant}_segment']}")
        cpu = SemanticSegmentation(conf, device="cpu")
        cpu.model.load_state_dict(seg.model.state_dict())
        agree = float((cpu.segment(images.numpy()) == labels).mean())

        batch = train_batches(1, SWEEP_BATCH, SWEEP_SIZE, "cuda", seed=2)[0]
        kernels.reset_launch_counts()
        loss = seg.train_step(batch)["loss"].item()
        by_path[f"{variant}_train_step"] = kernels.launch_counts()
        bad = [n for n, p in seg.model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        out[variant] = {"sites": len(sites), "distinct_sites": len({s[:3] + (s[3].weight.shape,)
                                                                     for s in sites}),
                        "cpu_agreement": agree, "loss": loss, "s": time.perf_counter() - t0}
        print(json.dumps({"sweep": {variant: out[variant]}}))
        if agree < 0.999:
            raise SystemExit(f"{variant}: card vs CPU labels agree on {agree:.5f} < 0.999 of pixels")
        if by_path[f"{variant}_train_step"] != depthwise_expect(sites, True,
                                                                stats_only_cell(seg.model)[1]):
            raise SystemExit(f"{variant} train_step(): launches {by_path[f'{variant}_train_step']}")
        if not math.isfinite(loss) or bad:
            raise SystemExit(f"{variant} train_step(): loss {loss}, bad gradients {bad[:4]}")
        del seg, cpu
        torch.cuda.empty_cache()
    print(json.dumps({"sweep_summary": {"batch": SWEEP_BATCH, "image": SWEEP_SIZE,
                                        "variants": out, "card": card}}))
    return by_path


def depthwise_by_k(rows, models) -> dict:
    """K2–K5 over one pass of each of ``models`` (a forward for K2/K3, a
    train step for K4/K5), split by kernel size: summed time, cuDNN's
    and the bound, and the sites that lose to cuDNN or run above twice
    their bound."""
    out = {}
    per = {"depthwise_fwd_s1": "per_forward", "depthwise_fwd_s2": "per_forward",
           "depthwise_bwd_s1": "per_step", "depthwise_bwd_s2": "per_step"}
    for model in models:
        for name, field in per.items():
            for k in (3, 5, 7):
                sites = [r for r in rows if r.get("model") == model and r["kernel"] == name
                         and r["k"] == k]
                if not sites:
                    continue
                ms, lib, bnd = (sum(r[field] * r[f] for r in sites)
                                for f in ("ms", "library_ms", "bound_ms"))
                out[f"{model}/{name}/k{k}"] = {
                    "sites": len(sites), "launches": sum(r[field] for r in sites), "ms": ms,
                    "library_ms": lib, "bound_ms": bnd, "x_library": ms / lib, "x_bound": ms / bnd,
                    "lose_to_library": [[r["shape_nchw"], r["stride"], r["dilation"], r["ms"],
                                         r["library_ms"]] for r in sites
                                        if r["ms"] > r["library_ms"]],
                    "above_2x_bound": [[r["shape_nchw"], r["stride"], r["dilation"], r["ms"],
                                        r["bound_ms"]] for r in sites
                                       if r["ms"] > 2 * r["bound_ms"]]}
    return out


def device_idle_share(prof, wall_s: float) -> dict:
    """Device busy time (the union of the CUDA kernels' and copies'
    intervals in a ``torch.profiler`` run) against the host's wall time of
    the profiled block."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_s = busy_us / 1e6
    return {"wall_s": wall_s, "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall_s}


def data_path_conf(root: str, **extra) -> dict:
    """The flagship conf reading a VOC-layout tree at ``root``: 2 epochs,
    flip + scale 0.5–2.0 augmentation, the reference's 4 loader workers."""
    conf = flagship_conf()
    conf.update(resource_type="pascal_voc_2012", resource_path=root, workers=4,
                augment={"random_flip": True, "scale_range": [0.5, 2.0]}, **extra)
    conf["hps"]["epochs"] = 2
    return conf


def run_data_path(kernels, card: str, train_step_img_s: float) -> dict:
    """The JSON-config entry points on a VOC-layout tree written here (64
    train, 32 val and 16 test images, sides 300–500, as VOC's): ``train()``
    for 2 epochs with augmentation, a second facade restored by
    ``model_loading`` whose ``evaluate()`` must give the best epoch's
    ``val_miou`` exactly, ``test()``'s PNGs against ``segment()`` of the same
    preprocessed images, ``evaluate()`` with test-time augmentation, and
    ``prepare_batch`` on the card against the CPU.  Returns the launches of
    the paths ``train_loop``, ``evaluate`` and ``test``."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, native
    from deeplabv3plus_keras_tpu_torch.data import (
        MODE_TEST,
        MODE_TRAIN,
        MODE_VAL,
        HostLoader,
        device_batches,
        make_synthetic_voc,
        pascal_voc_2012,
    )
    from deeplabv3plus_keras_tpu_torch.ops.preprocess import prepare_batch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, work = os.path.join(tmp, "resource"), os.path.join(tmp, "work")
        make_synthetic_voc(root, n_train=64, n_val=32, n_test=16, min_size=300, max_size=501)
        t_written = time.perf_counter() - t0

        # host decode alone: the train split's 4 batches, one worker and four
        decode = {"backend": "native" if native.native_available() else "pil"}
        for workers in (1, 4):
            loader = HostLoader(pascal_voc_2012(root, MODE_TRAIN), BATCH, SIZE, workers=workers)
            t = time.perf_counter()
            n = sum(1 for _ in loader)
            decode[f"ms_per_batch_{workers}_workers"] = (time.perf_counter() - t) * 1e3 / n

        # ---- train(): 2 epochs with augmentation ----
        seg = SemanticSegmentation(data_path_conf(root), work_dir=work, device="cuda")
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        history = seg.train()
        train_s = time.perf_counter() - t
        by_path["train_loop"] = kernels.launch_counts()
        if len(history["loss"]) != 2 or not all(math.isfinite(v) for k in history
                                                for v in history[k]):
            raise SystemExit(f"train(): history {history}")
        slot = os.path.join(work, seg.MODEL_PATH, "state", "state.pt")
        if not os.path.isfile(slot):
            raise SystemExit(f"train() left no checkpoint at {slot}")
        best = int(np.argmin(history["val_loss"]))
        del seg

        # ---- restore (model_loading) and evaluate(): the best epoch's CM ----
        seg = SemanticSegmentation(data_path_conf(root, model_loading=True), work_dir=work,
                                   device="cuda")
        kernels.reset_launch_counts()
        miou = seg.evaluate().result()
        by_path["evaluate"] = kernels.launch_counts()
        if miou != history["val_miou"][best]:
            raise SystemExit(f"restored evaluate() mIoU {miou} != epoch {best + 1}'s val_miou "
                             f"{history['val_miou'][best]}")

        # ---- test(): PNGs named after the inputs, equal to segment() ----
        kernels.reset_launch_counts()
        seg.test()
        by_path["test"] = kernels.launch_counts()
        out_dir = os.path.join(work, "test_results")
        specs = pascal_voc_2012(root, MODE_TEST)
        if sorted(os.listdir(out_dir)) != sorted(f"{s.name}.png" for s in specs):
            raise SystemExit(f"test() wrote {sorted(os.listdir(out_dir))[:4]}...")
        mismatched = 0
        for batch in device_batches(HostLoader(specs, BATCH, SIZE, with_labels=False), SIZE,
                                    CLASSES, with_labels=False, device="cuda"):
            labels = seg.segment(batch["image"])
            for name, lab in zip(batch["names"], labels):
                png = np.asarray(Image.open(os.path.join(out_dir, f"{name}.png")))
                mismatched += int((png != lab.astype(np.uint8)).sum())
        if mismatched:
            raise SystemExit(f"test() PNGs differ from segment() on {mismatched} pixels")
        del seg

        # ---- evaluate() with test-time augmentation ----
        seg = SemanticSegmentation(
            data_path_conf(root, model_loading=True, eval_scales=[0.75, 1.0, 1.25],
                           eval_flip=True), work_dir=work, device="cuda")
        tta_miou = seg.evaluate().result()
        if not math.isfinite(tta_miou):
            raise SystemExit(f"evaluate() with TTA: mIoU {tta_miou}")
        del seg

        # ---- one profiled training epoch: the card's idle share ----
        seg = SemanticSegmentation(data_path_conf(root), work_dir=os.path.join(tmp, "prof"),
                                   device="cuda")
        seg.hps.epochs = 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            seg.train()
            torch.cuda.synchronize()
            epoch_wall = time.perf_counter() - t
        idle = device_idle_share(prof, epoch_wall)
        del seg, prof

        # ---- prepare_batch on the card against the CPU, one val batch ----
        host = next(iter(HostLoader(pascal_voc_2012(root, MODE_VAL), BATCH, SIZE)))
        args = [torch.from_numpy(host[k]) for k in ("image_canvas", "sizes", "label_canvas")]
        kw = dict(size=SIZE, num_classes=CLASSES, one_hot_labels=False)
        gi, gl = prepare_batch(*[a.cuda() for a in args], **kw)
        ci, cl = prepare_batch(*args, **kw)
        img_err = (gi.cpu() - ci).abs().max().item()
        label_agree = float((gl.cpu() == cl).float().mean())
    torch.cuda.empty_cache()

    n_train, epochs = 64, 2
    print(json.dumps({"data_path": {
        "model": "mobilenetv2", "batch": BATCH, "image": SIZE, "dtype": "float32",
        "tree": {"train": 64, "val": 32, "test": 16, "sides": [300, 500], "write_s": t_written},
        "history": history, "best_epoch": best + 1, "restored_evaluate_miou": miou,
        "tta_miou": tta_miou, "test_pngs": len(specs),
        "train_s": train_s, "epoch_s": train_s / epochs,
        "train_img_per_s": n_train * epochs / train_s,
        "train_step_img_per_s": train_step_img_s,
        "host_decode": decode, "profiled_epoch": idle,
        "prepare_batch_card_vs_cpu": {"image_max_abs_err": img_err, "label_agreement": label_agree},
        "launches": by_path, "s": time.perf_counter() - t0, "card": card}}))
    if not img_err <= 1e-5:
        raise SystemExit(f"prepare_batch images on the card vs the CPU: {img_err} > 1e-5")
    if not label_agree >= 0.9999:
        raise SystemExit(f"prepare_batch labels on the card vs the CPU agree on {label_agree}")
    return by_path


LOW_PRECISION = ("bfloat16", "float16")
# Random weights leave many pixels' top two classes within a low-precision
# rounding of each other (on the CPU, JAX's own bfloat16 labels agree with
# its float32 ones on 66-90 % of pixels, tests/test_torch_dtype.py); a
# kernel or a rounding in the wrong place gives chance agreement (1/21).
LOW_LABEL_FLOOR = {"bfloat16": 0.5, "float16": 0.8}
# One 2 x 128² step on the card against the CPU in the same dtype: the loss
# to 1e-3 relative (both round the same way; the sums' order differs).
# Gradients of this random net in training mode are dominated by the
# dtype's rounding (on the CPU the bfloat16 step's gradients are 1.09 away
# from float64 in relative 2-norm, float16's 0.47), so the card's distance
# to float64 must be of the CPU's size: at most twice it.
LOW_CPU_LOSS_REL = 1e-3
LOW_CPU_GRAD_FACTOR = 2.0


def calibrated_flagship(batches) -> tuple[dict, list]:
    """The float32 flagship's weights from the seed with BN statistics set
    from the first serving batch, as ``drive_model`` sets them, and its
    ``segment()`` labels of ``batches``."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    seg = SemanticSegmentation(flagship_conf(), device="cuda")
    calibrate_bn(seg.model, torch.from_numpy(batches[0]).cuda())
    labels = [seg.segment(images) for images in batches]
    return {k: v.detach().clone() for k, v in seg.model.state_dict().items()}, labels


def _dtype_launches(kernels, dtype: str, names) -> dict:
    """Launches of ``names`` in ``dtype`` since the last reset; every
    depthwise launch of the phase must be in ``dtype``."""
    by_dtype = kernels.launch_counts_by_dtype()
    other = {k: v for k, v in by_dtype.items() if not k.endswith(f"/{dtype}") and v}
    if other:
        raise SystemExit(f"{dtype} phase launched kernels in another dtype: {other}")
    got = {n: by_dtype.get(f"{n}/{dtype}", 0) for n in names}
    missing = [n for n, v in got.items() if v < 1]
    if missing:
        raise SystemExit(f"{dtype} phase: no {dtype} launch of {missing}: {by_dtype}")
    return got


def check_low_precision_against_cpu(dtype: str) -> dict:
    """One 2 × 128² train step of the flagship in ``dtype`` on the card and
    on the CPU, and in float64 on the CPU, from the same weights and batch
    (dropout 0): the loss against the CPU in the same dtype, the gradients'
    relative 2-norm distance to float64 against the CPU's own."""
    import numpy as np
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    conf = flagship_conf(128, batch=2)
    conf["nn_arch"]["dropout_rate"] = 0.0
    conf["hps"]["dtype"] = dtype
    gpu = SemanticSegmentation(conf, device="cuda")
    cpu = SemanticSegmentation(conf, device="cpu")
    ref = SemanticSegmentation({**conf, "hps": {**conf["hps"], "dtype": "float64"}}, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    ref.model.load_state_dict(gpu.model.state_dict())
    ref.model.double()
    rng = np.random.default_rng(5)
    batch = {"image": rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, (2, 128, 128))}
    losses = {name: seg.train_step(batch)["loss"].item()
              for name, seg in (("card", gpu), ("cpu", cpu), ("f64", ref))}
    sq = {"card": 0.0, "cpu": 0.0, "ref": 0.0}
    for pg, pc, pr in zip(gpu.model.parameters(), cpu.model.parameters(), ref.model.parameters()):
        sq["card"] += (pg.grad.cpu().double() - pr.grad).square().sum().item()
        sq["cpu"] += (pc.grad.double() - pr.grad).square().sum().item()
        sq["ref"] += pr.grad.square().sum().item()
    rel_card, rel_cpu = (math.sqrt(sq[k] / sq["ref"]) for k in ("card", "cpu"))
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    out = {"dtype": dtype, "batch": 2, "image": 128, "losses": losses, "loss_rel_card_cpu": loss_rel,
           "grad_rel_2norm_vs_f64_card": rel_card, "grad_rel_2norm_vs_f64_cpu": rel_cpu,
           "bounds": {"loss_rel": LOW_CPU_LOSS_REL, "grad_factor": LOW_CPU_GRAD_FACTOR}}
    print(json.dumps({"low_precision_cpu_step": out}))
    if not loss_rel <= LOW_CPU_LOSS_REL:
        raise SystemExit(f"{dtype}: card loss {losses['card']} vs CPU {losses['cpu']}")
    if not rel_card <= LOW_CPU_GRAD_FACTOR * rel_cpu:
        raise SystemExit(f"{dtype}: card gradients {rel_card} from float64, CPU's {rel_cpu}")
    return out


def run_low_precision(kernels, card: str, dtype: str, state: dict, labels32, g, rows) -> dict:
    """The flagship in ``dtype`` (``hps.dtype``; parameters float32, the
    float32 phase's weights and BN statistics): K2–K5 against their plain
    versions at every site in that dtype, ``segment()`` on the serving
    batches (labels against the float32 labels, K1 on float32 logits),
    ``train_step()`` for ``TRAIN_STEPS`` steps and one 2 × 128² step
    against the CPU.  Returns the launches of the paths
    ``segment_<dtype>`` and ``train_step_<dtype>``."""
    import numpy as np
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    t0 = time.perf_counter()
    conf = flagship_conf()
    conf["hps"]["dtype"] = dtype
    seg = SemanticSegmentation(conf, device="cuda")
    seg.model.load_state_dict(state)
    batches = serving_batches()
    first = torch.from_numpy(batches[0]).cuda()
    sites = depthwise_sites(seg.model, first)
    with torch.inference_mode():
        logits, _ = seg.model(first, return_presample=True)
    if logits.dtype != torch.float32:  # K1 takes float32 logits in every dtype
        raise SystemExit(f"{dtype}: pre-upsample logits are {logits.dtype}")
    train_expect = depthwise_expect(sites, train=True)
    del logits, first
    n0 = len(rows)
    agg = check_depthwise(sites, g, rows, dtype)
    agg.update(check_depthwise_backward(sites, g, rows, dtype))
    for row in rows[n0:]:
        row["model"] = f"mobilenetv2_{dtype}"
    by_path = {}

    # ---- segment() ----
    expect = depthwise_expect(sites)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, agree = [], []
    for i, images in enumerate(batches):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        labels = seg.segment(images)
        times.append(time.perf_counter() - t)
        delta = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if delta != expect:
            raise SystemExit(f"{dtype} segment() call {i}: launches {delta}, expected {expect}")
        agree.append(float((labels == labels32[i]).mean()))
    by_path[f"segment_{dtype}"] = kernels.launch_counts()
    seg_dtype = _dtype_launches(kernels, dtype, ("depthwise_fwd_s1", "depthwise_fwd_s2"))
    seg_peak = torch.cuda.max_memory_allocated()
    prof = profile_device(lambda: seg.segment(batches[1]), OUT / f"segment_{dtype}_profile.txt",
                          f"{card}\nmobilenetv2 {dtype}, B={BATCH}, {SIZE}^2", 25)
    agreement = float(np.mean(agree))
    serve = {"img_per_s": BATCH / statistics.median(times[1:]), "call_s": times,
             "device_ms": prof["device_ms"], "top_kernels_ms": prof["top_kernels_ms"],
             "max_memory_allocated_gib": seg_peak / 2**30, "launches_in_dtype": seg_dtype,
             "label_agreement_with_float32": agreement, "label_floor": LOW_LABEL_FLOOR[dtype]}
    if agreement < LOW_LABEL_FLOOR[dtype]:
        raise SystemExit(f"{dtype} labels agree with float32 on {agreement:.4f} of pixels")

    # ---- train_step() ----
    train = train_batches(TRAIN_STEPS, BATCH, SIZE, "cuda", seed=1)
    expect = train_expect
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    for i, batch in enumerate(train):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = seg.train_step(batch)
        loss = out["loss"].item()
        times.append(time.perf_counter() - t)
        losses.append(loss)
        delta = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if delta != expect or not math.isfinite(loss):
            raise SystemExit(f"{dtype} train_step {i}: loss {loss}, launches {delta}, expected {expect}")
    by_path[f"train_step_{dtype}"] = kernels.launch_counts()
    train_dtype = _dtype_launches(kernels, dtype, ("depthwise_fwd_s1", "depthwise_fwd_s2",
                                                   "depthwise_bwd_s1", "depthwise_bwd_s2"))
    train_peak = torch.cuda.max_memory_allocated()
    wrong = [n for n, p in seg.model.named_parameters() if p.dtype != torch.float32
             or p.grad is None or p.grad.dtype != torch.float32 or not bool(torch.isfinite(p.grad).all())]
    wrong += [f"moment {i}" for i, m in enumerate(seg.optimizer.m + seg.optimizer.v)
              if m.dtype != torch.float32]
    if wrong:
        raise SystemExit(f"{dtype}: training state not float32 and finite: {wrong[:6]}")
    prof = profile_device(lambda: seg.train_step(train[1])["loss"].item(),
                          OUT / f"train_{dtype}_profile.txt",
                          f"{card}\nmobilenetv2 {dtype}, B={BATCH}, {SIZE}^2, one train_step", 30)
    step = {"img_per_s": BATCH / statistics.median(times[1:]), "step_s": times, "losses": losses,
            "device_ms": prof["device_ms"], "top_kernels_ms": prof["top_kernels_ms"],
            "max_memory_allocated_gib": train_peak / 2**30, "launches_in_dtype": train_dtype}
    del seg, train
    torch.cuda.empty_cache()
    cpu_step = check_low_precision_against_cpu(dtype)
    print(json.dumps({"low_precision": {
        "model": "mobilenetv2", "dtype": dtype, "batch": BATCH, "image": SIZE, "segment": serve,
        "train_step": step, "cpu_step": cpu_step, "kernels": agg,
        "s": time.perf_counter() - t0, "card": card}}))
    return by_path, agg


def run_remat(kernels, card: str, state: dict) -> dict:
    """The flagship's ``train_step()`` at B=16, 512², float32 with and
    without the extra key ``remat``, from the same weights: peak memory and
    step time of steps 2–4, and one step's loss, gradients and BN running
    statistics compared with cuDNN in deterministic mode, beside the plain
    step run twice.  Returns the launches of the path
    ``train_step_remat``."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.models.blocks import DepthwiseConv

    t0 = time.perf_counter()
    train = train_batches(4, BATCH, SIZE, "cuda", seed=3)
    result, first = {}, {}
    by_path = {}
    # "again": the plain step a second time, the yardstick of run-to-run
    # differences (the bilinear resizes' backward adds atomically)
    for variant in ("plain", "again", "remat"):
        remat = variant == "remat"
        conf = flagship_conf()
        conf["remat"] = remat
        seg = SemanticSegmentation(conf, device="cuda")
        seg.model.load_state_dict(state)
        torch.backends.cudnn.deterministic = True
        out = seg.train_step(train[0])
        torch.backends.cudnn.deterministic = False
        first[variant] = {
            "loss": out["loss"].item(),
            "grads": [p.grad.detach().clone() for p in seg.model.parameters()],
            "stats": [b.detach().clone() for b in seg.model.buffers() if b.is_floating_point()]}
        if variant == "again":
            del seg, out
            continue
        # the depthwise launches a step: with remat the backbone's sites
        # run their forward twice (the recompute)
        base_dw = sum(isinstance(m, DepthwiseConv) for m in seg.model.base.modules())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for batch in train[1:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            seg.train_step(batch)["loss"].item()
            times.append(time.perf_counter() - t)
        counts = kernels.launch_counts()
        fwd = (counts["depthwise_fwd_s1"] + counts["depthwise_fwd_s2"]) // len(times)
        bwd = (counts["depthwise_bwd_s1"] + counts["depthwise_bwd_s2"]) // len(times)
        if fwd != bwd + (base_dw if remat else 0):
            raise SystemExit(f"remat={remat}: {fwd} forward and {bwd} backward depthwise launches "
                             f"a step ({base_dw} in the backbone)")
        if remat:
            by_path["train_step_remat"] = counts
        result[variant] = {
            "step_s": times, "img_per_s": BATCH / statistics.median(times),
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "depthwise_forward_launches_a_step": fwd}
        del seg, out
        torch.cuda.empty_cache()

    def diff(a, b):
        """Loss and BN statistics: the largest relative difference; the
        gradients: their relative 2-norm distance over all parameters."""
        grad = math.sqrt(sum((x - y).double().square().sum().item()
                             for x, y in zip(a["grads"], b["grads"])))
        grad /= math.sqrt(sum(x.double().square().sum().item() for x in a["grads"]))
        stat = max(((x - y).abs().max() / x.abs().max().clamp_min(1e-30)).item()
                   for x, y in zip(a["stats"], b["stats"]))
        return {"loss_rel": abs(a["loss"] - b["loss"]) / abs(a["loss"]), "grad_rel_2norm": grad,
                "bn_stat_max_rel": stat,
                "grads_bitwise_equal": all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"]))}

    remat_vs_plain = diff(first["plain"], first["remat"])
    plain_vs_again = diff(first["plain"], first["again"])
    # cuDNN deterministic: the recompute gives the forward's activations,
    # so the remat step is the plain one up to the run-to-run differences
    # of the atomic adds: the loss and the statistics equal, the gradients
    # within 10x the plain step's own spread (and 1e-5)
    bound = max(10 * plain_vs_again["grad_rel_2norm"], 1e-5)
    out = {**result, "remat_vs_plain": remat_vs_plain, "plain_vs_plain": plain_vs_again,
           "grad_bound": bound, "s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"remat": out}))
    if not (remat_vs_plain["loss_rel"] == 0 and remat_vs_plain["bn_stat_max_rel"] == 0
            and remat_vs_plain["grad_rel_2norm"] <= bound):
        raise SystemExit(f"remat step differs from the plain step: {out}")
    if not result["remat"]["max_memory_allocated_gib"] < result["plain"]["max_memory_allocated_gib"]:
        raise SystemExit(f"remat did not lower the peak memory: {result}")
    return by_path


def run_cache_device(kernels, card: str) -> dict:
    """``cache_device`` on the data path's tree (64 train, 32 val images,
    sides 300–500; flip + scale augmentation): an epoch's batches from the
    device cache equal the streamed ones bit for bit; ``train()`` for 2
    epochs gives the streamed history (cuDNN deterministic, within the
    streamed history's own run-to-run spread); then, for the
    streamed and the cached loader (built once, outside the timed calls),
    one profiled epoch (idle share) and 2 timed epochs (images/s of epochs
    that decode nothing on the host when cached); a partial cache (40 of
    64 samples) trains.  Returns the launches of the path
    ``train_loop_cache_device``."""
    import contextlib
    import io
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.data import MODE_TRAIN, MODE_VAL, DeviceDataset, make_synthetic_voc

    t0 = time.perf_counter()
    by_path, out = {}, {}
    n_train = 64
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "resource")
        make_synthetic_voc(root, n_train=n_train, n_val=32, n_test=0, min_size=300, max_size=501)

        def facade(name, **extra):
            return SemanticSegmentation(data_path_conf(root, **extra),
                                        work_dir=os.path.join(tmp, name), device="cuda")

        streamed, cached = facade("s"), facade("c", cache_device=True)
        t = time.perf_counter()
        ds_train = cached._loader(MODE_TRAIN, shuffle=True)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t
        ds_val = cached._loader(MODE_VAL)
        if not isinstance(ds_train, DeviceDataset) or ds_train.n != n_train:
            raise SystemExit(f"cache_device: train loader {type(ds_train).__name__}")
        same, n = True, 0
        for a, b in zip(streamed._batches(streamed._loader(MODE_TRAIN, shuffle=True)),
                        cached._batches(ds_train)):
            same &= a["names"] == b["names"] and all(
                torch.equal(a[k], b[k]) for k in ("image", "label", "valid"))
            n += 1
        out["epoch_batches_bit_equal"] = bool(same) and n == n_train // BATCH

        # the histories (cuDNN deterministic), beside the streamed run
        # twice: the bilinear resizes' backward adds atomically
        torch.backends.cudnn.deterministic = True
        h_stream = facade("s2").train()
        h_again = facade("s3").train()
        h_cache = facade("c2", cache_device=True).train()
        torch.backends.cudnn.deterministic = False

        def max_rel(h1, h2):
            return max(abs(a - b) / max(abs(a), 1e-30) for k in h1 for a, b in zip(h1[k], h2[k]))

        worst, spread = max_rel(h_stream, h_cache), max_rel(h_stream, h_again)
        history_bound = max(10 * spread, 1e-6)
        out.update(history_stream=h_stream, history_cache=h_cache,
                   histories_equal=h_stream == h_cache, history_max_rel=worst,
                   stream_twice_max_rel=spread, history_bound=history_bound)

        # the cached facade reads the loaders built above: its epochs
        # decode nothing on the host
        cached._loader = lambda mode, shuffle=False, with_labels=True, accum=1: (
            ds_train if mode == MODE_TRAIN else ds_val)
        for name, seg in (("stream", streamed), ("cache", cached)):
            seg.hps.epochs = 1
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                seg.train()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            idle = device_idle_share(prof, wall)
            del prof
            seg.hps.epochs = 2
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            seg.train()
            torch.cuda.synchronize()
            timed = time.perf_counter() - t
            if name == "cache":
                by_path["train_loop_cache_device"] = kernels.launch_counts()
            out[name] = {"profiled_epoch": idle, "two_epochs_s": timed,
                         "train_img_per_s": 2 * n_train / timed}

        # a partial cache: 40 of the 64 samples
        log = io.StringIO()
        partial = facade("p", cache_device=True,
                         cache_device_max_bytes=40 * (SIZE * SIZE * 4 + 8))
        partial.hps.epochs = 1
        with contextlib.redirect_stdout(log):
            h_partial = partial.train()
        out.update(partial_history=h_partial, partial_log=[
            line for line in log.getvalue().splitlines() if line.startswith("cache_device")])
        del streamed, cached, partial, ds_train, ds_val
    torch.cuda.empty_cache()
    out.update(s=time.perf_counter() - t0, card=card)
    print(json.dumps({"cache_device": out}))
    if not out["epoch_batches_bit_equal"]:
        raise SystemExit("cache_device: an epoch's batches differ from the streamed ones")
    # the same batches through the same steps: within 10x the streamed
    # path's own run-to-run spread (and 1e-6)
    if not worst <= history_bound:
        raise SystemExit(f"cache_device history differs from streaming by {worst} "
                         f"(streamed twice: {spread})")
    if (not any("fits 40/64" in line for line in out["partial_log"])
            or not all(math.isfinite(v) for k in h_partial for v in h_partial[k])):
        raise SystemExit(f"partial cache: {out['partial_log']} {h_partial}")
    return by_path


def run_export(kernels, card: str, state: dict) -> dict:
    """``convert_to_tf_lite()`` of the float32 flagship on the card: the
    ``.pt2`` holds the depthwise custom operators, and ``torch.export.load``
    of it gives the model's probabilities at B=1 and B=16 (the same
    kernels; cuDNN may choose other algorithms, so within 1e-6).  Returns the launches of the path
    ``export_program`` (the loaded program's two calls)."""
    import tempfile

    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        seg = SemanticSegmentation(flagship_conf(), work_dir=tmp, device="cuda")
        seg.model.load_state_dict(state)
        t = time.perf_counter()
        paths = seg.convert_to_tf_lite()
        export_s = time.perf_counter() - t
        program = torch.export.load(paths[0])
        size_mb = os.path.getsize(paths[0]) / 2**20
    ops = {torch.ops.dlv3_port.depthwise_fwd.default, torch.ops.dlv3_port.depthwise_cf_fwd.default}
    nodes = sum(n.target in ops for n in program.graph.nodes)
    errs, launches = {}, {}
    module = program.module()
    for b in (1, BATCH):
        x = torch.rand(b, SIZE, SIZE, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(b))
        x = x * 2 - 1
        with torch.no_grad():
            kernels.reset_launch_counts()
            got = module(x)
            for k, v in kernels.launch_counts().items():
                launches[k] = launches.get(k, 0) + v
            ref = seg.model.eval()(x)
        errs[b] = (got - ref).abs().max().item()
    by_path = {"export_program": launches}
    out = {"artifact": os.path.basename(paths[0]), "mb": size_mb, "export_s": export_s,
           "depthwise_op_nodes": nodes, "max_abs_err_by_batch": errs,
           "launches": by_path["export_program"], "s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"export": out}))
    if nodes < 1 or not all(e <= 1e-6 for e in errs.values()):
        raise SystemExit(f"export: {out}")
    return by_path


# ---- the int8 phase: int8_infer on the flagship and Xception ----

INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
# Label agreement floors of the int8 path (random weights, BN set from a
# batch).  int8 is a discontinuous function of the float pre-activations:
# where the card's float32 rounds otherwise than the CPU's, a quantized
# value moves one step and carries to every later site (tests/
# test_torch_int8.py counts them against JAX), so the card's int8 labels
# are held to sanity floors, far above chance (1/21), not to the float
# path's 0.999.
INT8_LABEL_FLOOR = {"float32": 0.5, "cpu_int8": 0.5}


def _quant_shapes(model, fn) -> dict:
    """{QuantConv name: (input shape, cin, cout, k, stride, padding)} of
    every QuantConv call while ``fn()`` runs."""
    from deeplabv3plus_keras_tpu_torch.models.blocks import QuantConv

    names = {m: n for n, m in model.named_modules()}
    shapes = {}

    def hook(mod, args):
        shapes[names[mod]] = (tuple(args[0].shape), mod.weight.shape[1], mod.weight.shape[0],
                              mod.kernel, mod.strides, mod.padding)

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, QuantConv)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return shapes


def int8_site_row(card_w, shape, k, stride, padding, amax, site: str, calls: int) -> dict:
    """One int8 site: the int8 conv (quantize, ``_int_mm``, dequantize)
    against cuDNN's float32 and bfloat16 conv at the same shape, its bound
    (float32 x read and y written, int8 operations at the int8 rate), and
    the card's result against the CPU's plain version on 2 images."""
    import torch

    from deeplabv3plus_keras_tpu_torch.models.blocks import Conv
    from deeplabv3plus_keras_tpu_torch.ops import quant

    B, C, H, W = shape
    x = torch.randn(shape, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    x = x.contiguous(memory_format=torch.channels_last)
    conv = Conv(C, card_w.shape[0], k, strides=stride, padding=padding).cuda()
    w = card_w.detach()
    xb, wb = x.bfloat16(), w.bfloat16()
    amax = torch.as_tensor(amax, device="cuda", dtype=torch.float32)
    y = quant.int8_conv(x, w, amax, strides=stride, padding=padding, site=site)
    ref = quant.int8_conv(x[:2].cpu(), w.cpu(), amax.cpu(), strides=stride, padding=padding)
    err = (y[:2].cpu() - ref).abs().max().item()
    _, O, Ho, Wo = y.shape
    macs = B * Ho * Wo * C * k * k * O
    t_mem = (x.numel() * 4 + y.numel() * 4 + w.numel() * 4) / MEM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
    with torch.inference_mode():
        row = {
            "site": site, "shape": list(shape), "cout": O, "k": k, "stride": stride,
            "calls": calls, "eligible": quant.eligible(C, O, H * W),
            "ms": cuda_ms(lambda: quant.int8_conv(x, w, amax, strides=stride, padding=padding)),
            "library_ms_float32": cuda_ms(lambda: conv._conv(x, w)),
            "library_ms_bfloat16": cuda_ms(lambda: conv._conv(xb, wb)),
            "bound_ms": max(t_mem, t_ops), "bound_by": "bytes" if t_mem >= t_ops else "operations",
            "max_abs_err_vs_cpu": err,
        }
    row["speedup_vs_float32"] = row["library_ms_float32"] / row["ms"]
    row["speedup_vs_bfloat16"] = row["library_ms_bfloat16"] / row["ms"]
    return row


def run_int8_model(kernels, card: str, name: str, conf: dict, batches, t0: float) -> dict:
    """``int8_infer`` on one model under ``nhwc``: calibration on the
    serving batches, the sites against the CPU's for the same config,
    ``segment()`` (launches, images/s) against float32 and bfloat16
    ``segment()`` of the same weights, labels against float32 and against
    the CPU's int8 path on 2 images, and every distinct eligible site timed.
    Returns (result, launches of ``segment_int8``, facade, site shapes)."""
    import numpy as np
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.ops import quant
    from deeplabv3plus_keras_tpu_torch.parallel.step import build_label_step

    seg = SemanticSegmentation({**conf, "int8_infer": True}, device="cuda")
    first = torch.from_numpy(batches[0]).cuda()
    calibrate_bn(seg.model, first)
    expect = {k: v for k, v in depthwise_expect(depthwise_sites(seg.model, first)).items() if v}
    del first
    shapes = _quant_shapes(seg.model, lambda: seg.calibrate_int8(np.concatenate(batches)))
    ranges = seg._quant
    # the CPU's sites for the same config: names depend on shapes alone
    cpu = SemanticSegmentation({**conf, "int8_infer": True}, device="cpu")
    cpu.model.load_state_dict(seg.model.state_dict())
    cpu_sites = sorted(quant.calibrate(cpu.model, [batches[0][:1]]))
    if sorted(ranges) != cpu_sites:
        raise SystemExit(f"{name} int8: card sites {sorted(ranges)} != CPU's {cpu_sites}")

    def timed(facade):
        times, labels = [], []
        for images in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            labels.append(facade.segment(images))
            times.append(time.perf_counter() - t)
        return BATCH / statistics.median(times[1:]), labels, times

    def device_ms(facade, tag: str) -> float:
        """Device busy ms of one call (the host clock's images/s vary
        between runs: serving is host-bound)."""
        return profile_device(lambda: facade.segment(batches[1]),
                              OUT / f"int8_{name}_segment_{tag}_profile.txt",
                              f"{card}\n{name}, int8 phase, {tag}, B={BATCH}, {SIZE}^2", 30)["device_ms"]

    kernels.reset_launch_counts()
    quant.reset_counts()
    labels8, times = [], []
    for i, images in enumerate(batches):
        before, q0 = kernels.launch_counts(), quant.counts["int8_conv"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        labels8.append(seg.segment(images))
        times.append(time.perf_counter() - t)
        delta = {k: v - before[k] for k, v in kernels.launch_counts().items() if v - before[k]}
        if delta != expect or quant.counts["int8_conv"] - q0 != len(ranges):
            raise SystemExit(f"{name} int8 segment() call {i}: launches {delta} (expected "
                             f"{expect}), {quant.counts['int8_conv'] - q0} int8 convs "
                             f"(expected {len(ranges)})")
    launches = kernels.launch_counts()
    int8_img_s = BATCH / statistics.median(times[1:])
    busy = {"int8": device_ms(seg, "int8")}
    f32 = SemanticSegmentation(conf, device="cuda")
    f32.model.load_state_dict(seg.model.state_dict())
    f32_img_s, labels32, _ = timed(f32)
    busy["float32"] = device_ms(f32, "float32")
    bf16 = SemanticSegmentation({**conf, "hps": {**conf["hps"], "dtype": "bfloat16"}},
                                device="cuda")
    bf16.model.load_state_dict(seg.model.state_dict())
    bf16_img_s, _, _ = timed(bf16)
    busy["bfloat16"] = device_ms(bf16, "bfloat16")
    del f32, bf16
    agree32 = float(np.mean([(a == b).mean() for a, b in zip(labels8, labels32)]))
    cpu_labels = build_label_step(cpu.model, {k: v.cpu() for k, v in ranges.items()})(
        torch.from_numpy(batches[0][:2])).numpy()
    agree_cpu = float((cpu_labels == labels8[0][:2]).mean())
    del cpu

    # every distinct eligible site, timed at its shape with its weight
    mods = dict(seg.model.named_modules())
    distinct = {}
    for site in ranges:
        shape, cin, cout, k, stride, padding = shapes[site]
        key = (shape, cout, k, stride, str(padding))
        distinct.setdefault(key, [site, 0])[1] += 1
    rows = [int8_site_row(mods[site].weight, key[0], key[2], key[3], shapes[site][5],
                          ranges[site], site, calls) for key, (site, calls) in distinct.items()]
    torch.cuda.empty_cache()
    out = {"model": name, "batch": BATCH, "image": SIZE, "sites": len(ranges),
           "sites_equal_cpu": True, "img_per_s": {"int8": int8_img_s, "float32": f32_img_s,
                                                  "bfloat16": bf16_img_s},
           "int8_over_float32": int8_img_s / f32_img_s, "int8_over_bfloat16": int8_img_s / bf16_img_s,
           "device_busy_ms_per_call": busy,
           "call_s_int8": times, "label_agreement": {"float32": agree32, "cpu_int8_2_images": agree_cpu},
           "launches_per_call": expect, "sum_site_ms": {
               f: sum(r[f] * r["calls"] for r in rows)
               for f in ("ms", "library_ms_float32", "library_ms_bfloat16", "bound_ms")},
           "s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"int8": out}))
    (OUT / f"int8_sites_{name}.json").write_text(json.dumps({"card": card, "sites": rows}, indent=1))
    print(json.dumps({"int8_sites": [{k: r[k] for k in ("site", "shape", "cout", "calls", "ms",
                                                        "library_ms_float32", "library_ms_bfloat16",
                                                        "bound_ms", "max_abs_err_vs_cpu")}
                                     for r in rows], "model": name, "card": card}))
    # the same quantized values, an exact product, the same float32
    # dequantization: equal
    bad = [r["site"] for r in rows if r["max_abs_err_vs_cpu"] != 0.0]
    if bad:
        raise SystemExit(f"{name} int8: card vs CPU int8 conv differ at {bad}")
    if agree32 < INT8_LABEL_FLOOR["float32"] or agree_cpu < INT8_LABEL_FLOOR["cpu_int8"]:
        raise SystemExit(f"{name} int8 labels: {out['label_agreement']} below {INT8_LABEL_FLOOR}")
    return out, launches, seg, shapes


def run_int8(kernels, card: str) -> dict:
    """The ``int8`` phase, under ``nhwc`` and TF32 off, at 16×512²: the
    flagship and Xception calibrated on the serving batches and served
    (:func:`run_int8_model`); the gate edges on the card (a site above the
    pixel gate, Xception's 256→256 pointwise at 127², and one below the
    channel gate, the flagship's 320→48 refinement conv at 32², timed as
    int8 against cuDNN); ``evaluate()`` and ``test()`` under ``int8_infer``
    on a VOC tree (PNGs against int8 ``segment()``); the int8 ``.pt2``
    loaded and run against int8 ``segment()``.  Returns the launches of the
    paths ``segment_int8``, ``xception_segment_int8``, ``evaluate_int8``,
    ``test_int8`` and ``export_program_int8``."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.data import MODE_TEST, make_synthetic_voc
    from deeplabv3plus_keras_tpu_torch.ops import quant
    from deeplabv3plus_keras_tpu_torch.parallel.step import build_predict_step

    t0 = time.perf_counter()
    batches = serving_batches()
    by_path = {}
    flag, by_path["segment_int8"], seg, flag_shapes = run_int8_model(
        kernels, card, "mobilenetv2", flagship_conf(), batches, t0)
    xcp, by_path["xception_segment_int8"], xseg, x_shapes = run_int8_model(
        kernels, card, "xception", xception_conf(), batches, t0)

    # the gate edges: above the pixel gate and below the channel gate
    mods, xmods = dict(seg.model.named_modules()), dict(xseg.model.named_modules())
    edges = []
    for facade_mods, shapes, site in ((xmods, x_shapes, "base.block3_sepconv2.pointwise"),
                                      (mods, flag_shapes, "decoder.refine_conv48.conv_l2")):
        shape, cin, cout, k, stride, padding = shapes[site]
        row = int8_site_row(facade_mods[site].weight, shape, k, stride, padding, 4.0, site, 1)
        edges.append(row)
    print(json.dumps({"int8_gate_edges": edges, "gates": {
        "MIN_QUANT_CHANNELS": quant.MIN_QUANT_CHANNELS, "MAX_QUANT_PIXELS": quant.MAX_QUANT_PIXELS},
        "card": card}))
    if any(r["eligible"] for r in edges):
        raise SystemExit(f"int8 gate edges: a timed edge site is eligible: {edges}")
    del xseg
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # ---- evaluate() and test() under int8_infer on a VOC tree ----
        root, work = os.path.join(tmp, "resource"), os.path.join(tmp, "work")
        make_synthetic_voc(root, n_train=16, n_val=16, n_test=16, min_size=300, max_size=501)
        dseg = SemanticSegmentation({**data_path_conf(root), "int8_infer": True},
                                    work_dir=work, device="cuda")
        dseg.model.load_state_dict(seg.model.state_dict())
        kernels.reset_launch_counts()
        quant.reset_counts()
        miou = dseg.evaluate().result()
        by_path["evaluate_int8"] = kernels.launch_counts()
        eval_int8 = quant.counts["int8_conv"]
        kernels.reset_launch_counts()
        dseg.test()
        by_path["test_int8"] = kernels.launch_counts()
        mismatched = 0
        pngs = sorted(os.listdir(os.path.join(work, "test_results")))
        for b in dseg._batches(dseg._loader(MODE_TEST, with_labels=False), with_labels=False):
            labels = dseg.segment(b["image"])
            for n, lab in zip(b["names"], labels):
                png = np.asarray(Image.open(os.path.join(work, "test_results", f"{n}.png")))
                mismatched += int((png != lab.astype(np.uint8)).sum())
        del dseg

        # ---- the int8 .pt2 against int8 segment() ----
        t = time.perf_counter()
        eseg = SemanticSegmentation({**flagship_conf(), "int8_infer": True}, work_dir=tmp,
                                    device="cuda")
        eseg.model.load_state_dict(seg.model.state_dict())
        paths = eseg.convert_to_tf_lite(representative_images=np.concatenate(batches))
        export_s = time.perf_counter() - t
        exported = torch.export.load(paths[1])
        program = exported.module()
    int_mm_nodes = sum(n.target == torch.ops.aten._int_mm.default for n in exported.graph.nodes)
    same_ranges = all(torch.equal(seg._quant[k], v) for k, v in
                      quant.calibrate(eseg.model, eseg._calib_batches(np.concatenate(batches))).items())
    x = torch.from_numpy(batches[0]).cuda()
    kernels.reset_launch_counts()
    with torch.no_grad():
        probs = program(x)
    by_path["export_program_int8"] = kernels.launch_counts()
    ref = build_predict_step(seg.model, seg._quant)(x)
    probs_err = (probs - ref).abs().max().item()
    top2 = probs.topk(2, dim=-1).values
    ties = (top2[..., 0] == top2[..., 1]).cpu().numpy()
    labels = probs.argmax(-1).cpu().numpy()
    seg_labels = seg.segment(batches[0])
    differ = labels != seg_labels
    export = {"artifact": os.path.basename(paths[1]), "export_s": export_s,
              "ranges_equal_segment": same_ranges, "probs_max_abs_err_vs_int8_forward": probs_err,
              "labels_differ": int(differ.sum()), "labels_differ_outside_ties": int((differ & ~ties).sum()),
              "probability_ties": int(ties.sum()), "int_mm_nodes": int_mm_nodes,
              "sites": len(seg._quant)}
    result = {"data_path": {"evaluate_miou": miou, "int8_convs_evaluate": eval_int8,
                            "test_pngs": len(pngs), "test_mismatched_pixels": mismatched},
              "export": export, "s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"int8_entry_points": result}))
    failures = []
    if not (math.isfinite(miou) and eval_int8 > 0 and len(pngs) == 16 and not mismatched):
        failures.append(f"evaluate()/test() under int8_infer: {result['data_path']}")
    if not (same_ranges and probs_err <= 1e-6 and not export["labels_differ_outside_ties"]
            and int_mm_nodes == len(seg._quant)):
        failures.append(f"int8 .pt2: {export}")
    # evaluate() takes the probabilities (no K1); test() labels through K1
    for path, names in (("evaluate_int8", ("depthwise_fwd_s1", "depthwise_fwd_s2")),
                        ("test_int8", ("upsample_argmax", "depthwise_fwd_s1", "depthwise_fwd_s2"))):
        if not all(by_path[path][k] for k in names):
            failures.append(f"{path} launches {by_path[path]}")
    if failures:
        raise SystemExit("int8: " + "; ".join(failures))
    return by_path


def run_pretrained(card: str) -> dict:
    """The ``pretrained`` line: where TensorFlow imports, a random-weight
    Keras MobileNetV2 ``.h5`` at 512² loaded through the facade's
    ``backbone_weights`` (every backbone tensor against the Keras source's,
    converted, then one batch served); where it does not, the facade must
    raise naming TensorFlow (a missing host dependency, not a device
    fallback)."""
    import importlib.util
    import tempfile

    import numpy as np

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.utils import keras_weights, pretrained
    from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables

    t0 = time.perf_counter()
    has_tf = importlib.util.find_spec("tensorflow") is not None
    out = {"tensorflow": has_tf, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        h5 = os.path.join(tmp, "mobilenetv2.weights.h5")
        conf = {**flagship_conf(), "backbone_weights": h5}
        if not has_tf:
            open(h5, "wb").close()
            try:
                SemanticSegmentation(conf, device="cuda")
                raise SystemExit("pretrained: the facade loaded weights without TensorFlow")
            except RuntimeError as e:
                if "TensorFlow" not in str(e):
                    raise
                out["refused"] = str(e)[:200]
        else:
            source = pretrained.keras_builder("mobilenetv2", SIZE)()
            source.save_weights(h5)
            seg = SemanticSegmentation(conf, device="cuda")
            got = export_jax_variables(seg.model)
            ref = keras_weights.convert_keras_backbone(source, got)[0]
            n = mismatched = 0
            for c in ("params", "batch_stats"):
                stack = [(ref[c]["base"], got[c]["base"])]
                while stack:
                    a, b = stack.pop()
                    for k in a:
                        if isinstance(a[k], dict):
                            stack.append((a[k], b[k]))
                        else:
                            n += 1
                            mismatched += not np.array_equal(a[k], b[k])
            labels = seg.segment(serving_batches()[0])
            out.update(tensors=n, mismatched=mismatched, labels_shape=list(labels.shape))
            if mismatched or n < 100 or labels.shape != (BATCH, SIZE, SIZE):
                raise SystemExit(f"pretrained: {out}")
    out["s"] = time.perf_counter() - t0
    print(json.dumps({"pretrained": out}))
    return out


# ---- the ddp phase: two ranks of a process group against one process ----

DDP_STEPS = 2
# the data path's VOC tree (train, val, test images): half the data_path
# phase's training images
DDP_TREE = (32, 16, 16)
# the step at 16 × 512², float32, TF32 off, cuDNN deterministic, against
# one process.  The first step: the bounds of the JAX package's
# N-against-1-device check (__graft_entry__.py:182-200, one step): the loss
# to 1e-5 relative, the confusion matrix to max(8, pixels/4096); parameters
# after the steps to 3e-3.  Float32 rounding alone moves the gradient: a
# pre-activation that rounds across a ReLU6 kink changes every gradient
# upstream of it (PERF.md §6: 2.6e-3 in relative 2-norm between the
# flagship's float32 and float64 steps), and Keras Adam at β₁ = 0.5 turns a
# gradient that rounds across zero into a whole ±lr update.  The yardstick
# of that is one process taking the same batches with their rows in
# reverse order (the same sums, in another order): the first step's
# gradients and every later step's loss and confusion matrix are held to
# the larger of those bounds (1e-5 for gradients) and 10× that run's
# distance (for the loss, its largest after an update), as the remat
# phase holds its gradients to its own spread
DDP_LOSS_REL, DDP_PARAM_ATOL, DDP_SPREAD = 1e-5, 3e-3, 10
# train() for 2 epochs (4 steps) against one process: float32 steps drift
# apart chaotically (Keras Adam at β₁ = 0.5 turns a gradient that rounds
# across zero into a whole ±lr update), so per epoch: losses to 2e-2
# relative, mIoUs to 2e-2; the sharded cache draws other global batches
# than one process's single stream (every sample once an epoch all the
# same), so 5e-2 for both
DDP_HISTORY = {"streamed": (2e-2, 2e-2), "cache_device": (5e-2, 5e-2)}
DDP_MIOU_ABS = 1e-4  # evaluate() of one checkpoint, 2 ranks against one process
# int8 evaluate(): each rank's abs-max of its 8 rows, the maximum over the
# ranks, against one process's of 16 rows: a row's activations round alike
# in either batch to float32 rounding
DDP_INT8_RANGE_REL = 1e-6


def ddp_conf(conf: dict) -> dict:
    """``conf`` with the encoder's dropout at 0: element-wise dropout draws
    from each rank's own stream (ROADMAP.md, known divergences), so N ranks
    equal one process only without it, as the JAX package's own sharding
    test sets it (tests/test_sharding.py:33)."""
    conf["nn_arch"]["dropout_rate"] = 0.0
    return conf


def ddp_layout() -> dict:
    """Two ranks: a card each over NCCL where two cards exist, else both on
    the one card over gloo (NCCL refuses two ranks on one device); a
    correctness check then, not a speed."""
    import torch

    cards = torch.cuda.device_count()
    if cards >= 2:
        return {"backend": "nccl", "cards": cards, "world": 2, "devices": ["cuda:0", "cuda:1"]}
    return {"backend": "gloo", "cards": cards, "world": 2, "devices": ["cuda:0", "cuda:0"]}


def ddp_numerics() -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def ddp_batches(n: int, seed: int = 7) -> list[dict]:
    """Global batches of 16 × 512² made on the CPU from a seed, the same in
    every process: images in (−1, 1), integer labels."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return [{"image": torch.rand(BATCH, SIZE, SIZE, 3, generator=gen) * 2 - 1,
             "label": torch.randint(0, CLASSES, (BATCH, SIZE, SIZE), generator=gen)}
            for _ in range(n)]


def ddp_steps(state: dict, device, rows=None, dtype: str = "float32",
              steps: int = DDP_STEPS, **extra) -> dict:
    """``train_step()`` of the flagship from ``state`` on ``steps`` global
    batches (this rank's ``rows`` of each under a group, all of them
    otherwise), with the config keys ``extra``: per step the loss, the
    confusion matrix, the kernels' launches and the wall time; then the
    weights and statistics."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    conf = {**ddp_conf(flagship_conf()), **extra}
    conf["hps"]["dtype"] = dtype
    if mesh.is_active():
        conf.update(multi_gpu=True, num_gpus=mesh.world_size())
    seg = SemanticSegmentation(conf, device=device)
    seg.model.load_state_dict(state)
    out = {"losses": [], "cms": [], "launches": [], "step_s": []}
    for b in ddp_batches(steps):
        local = {k: (v if rows is None else v[rows]).to(device) for k, v in b.items()}
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = seg.train_step(local)
        out["losses"].append(m["loss"].item())
        out["step_s"].append(time.perf_counter() - t)
        out["launches"].append(kernels.launch_counts())
        out["cms"].append(m["cm"].cpu())
        if len(out["cms"]) == 1:
            out["grads"] = {n: p.grad.detach().cpu() for n, p in seg.model.named_parameters()}
    out["state"] = {k: v.detach().cpu() for k, v in seg.model.state_dict().items()}
    return out


def _ddp_step_rank(state_path: str, out_dir: str) -> None:
    """A rank of the ddp phase's step check: 2 float32 steps and one
    bfloat16 step on its 8 rows of each global batch."""
    import torch

    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    ddp_numerics()
    device = torch.device("cuda", torch.cuda.current_device())
    state = torch.load(state_path, map_location=device)
    rows = torch.as_tensor(mesh.row_indices(BATCH))
    out = {"float32": ddp_steps(state, device, rows),
           "bfloat16": ddp_steps(state, device, rows, "bfloat16", steps=1)}
    # what one collective of the step costs: a BN layer's (2 rank slots of
    # 2 × 320 channels) and the gradients' flat all-reduce, waited for
    n_params = sum(v.numel() for k, v in state.items()
                   if not k.endswith(("running_mean", "running_var")))
    out["collective_ms"] = {}
    for name, numel in (("bn_slots", 2 * 2 * 320), ("gradients", n_params)):
        t = torch.zeros(numel, device=device)
        for _ in range(3):
            mesh.all_reduce_(t)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(20):
            mesh.all_reduce_(t)
        torch.cuda.synchronize()
        out["collective_ms"][name] = (time.perf_counter() - start) * 1e3 / 20
    torch.save(out, os.path.join(out_dir, f"step_r{mesh.rank()}.pt"))


def _ddp_data_rank(root: str, work: str, out_dir: str) -> None:
    """A rank of the ddp phase's data path: ``train()`` streamed and with a
    sharded ``cache_device``, ``evaluate()`` and ``test()`` of the
    streamed run's checkpoint (the rank's PNGs against its ``segment()``),
    and one epoch profiled on rank 0 (the card's idle share)."""
    import numpy as np
    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.data import MODE_TEST
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    ddp_numerics()
    device = torch.device("cuda", torch.cuda.current_device())
    conf = {**ddp_conf(data_path_conf(root)), "multi_gpu": True, "num_gpus": mesh.world_size()}
    out, by_path = {}, {}
    for name, extra in (("streamed", {}), ("cache_device", {"cache_device": True})):
        seg = SemanticSegmentation({**conf, **extra}, work_dir=os.path.join(work, name),
                                   device=device)
        if name == "streamed":
            # this process's first step (cuDNN's and gloo's set-up) outside
            # the timed call; its update is overwritten from rank 0 below
            seg.train_step({"image": torch.zeros(BATCH // 2, SIZE, SIZE, 3, device=device),
                            "label": torch.zeros(BATCH // 2, SIZE, SIZE, dtype=torch.long,
                                                 device=device)})
            seg = SemanticSegmentation({**conf, **extra}, work_dir=os.path.join(work, name),
                                       device=device)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        history = seg.train()
        out[name] = {"history": history, "train_s": time.perf_counter() - t}
        if name == "streamed":
            by_path["train_loop_ddp"] = kernels.launch_counts()
        del seg
    seg = SemanticSegmentation({**conf, "model_loading": True},
                               work_dir=os.path.join(work, "streamed"), device=device)
    kernels.reset_launch_counts()
    out["evaluate_miou"] = seg.evaluate().result()
    by_path["evaluate_ddp"] = kernels.launch_counts()
    # int8_infer: calibrated on this rank's rows, the ranges the maximum over
    # the ranks
    q = SemanticSegmentation({**conf, "model_loading": True, "int8_infer": True},
                             work_dir=os.path.join(work, "streamed"), device=device)
    kernels.reset_launch_counts()
    out["evaluate_int8"] = {"miou": q.evaluate().result(),
                            "ranges": {k: v.item() for k, v in q._quant.items()}}
    by_path["evaluate_int8_ddp"] = kernels.launch_counts()
    del q
    seg.test()
    mismatched, mine = 0, []
    png_dir = os.path.join(work, "streamed", "test_results")
    for batch in seg._batches(seg._loader(MODE_TEST, with_labels=False), with_labels=False):
        labels = seg.segment(batch["image"])
        for name, lab in zip(batch["names"], labels):
            png = np.asarray(Image.open(os.path.join(png_dir, f"{name}.png")))
            mismatched += int((png != lab.astype(np.uint8)).sum())
            mine.append(name)
    out["test"] = {"names": mine, "mismatched_pixels": mismatched}
    del seg
    seg = SemanticSegmentation(conf, work_dir=os.path.join(work, "profiled"), device=device)
    seg.hps.epochs = 1
    profiler = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                if mesh.rank() == 0 else contextlib.nullcontext())
    with profiler as prof:
        t = time.perf_counter()
        seg.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    if mesh.rank() == 0:
        out["profiled_epoch"] = device_idle_share(prof, wall)
    out["launches"] = by_path
    with open(os.path.join(out_dir, f"data_r{mesh.rank()}.json"), "w") as f:
        json.dump(out, f)


def run_ddp(kernels, card: str, state: dict) -> dict:
    """Two ranks of a process group (:func:`ddp_layout`) against one
    process, from the flagship's weights ``state``.  The step: 2 float32
    steps of 16 × 512² (8 rows a rank) and one bfloat16 step (the
    synchronised 16-bit BN backward on the card); losses, parameters and
    confusion matrices against one process, parameters and statistics bit
    for bit across ranks, K2–K5 launches per rank and step.  The data path
    on a VOC tree of ``DDP_TREE`` images: ``train()`` 2 epochs streamed and with a
    sharded ``cache_device`` against one process's, ``evaluate()`` of one
    checkpoint against one process's, ``test()``'s PNGs against the
    ranks' ``segment()``; images/s and a profiled epoch's idle share.  The
    ranks are spawned processes with a deadline; the one process runs
    here, after them.  Returns the launches of the paths
    ``train_step_ddp``, ``train_loop_ddp`` and ``evaluate_ddp`` (rank 0's)."""
    import tempfile

    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.data import make_synthetic_voc
    from deeplabv3plus_keras_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    layout = ddp_layout()
    print(json.dumps({"ddp_layout": {k: layout[k] for k in ("backend", "cards", "world")},
                      "card": card}))
    deterministic = torch.backends.cudnn.deterministic
    ddp_numerics()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        state_path = os.path.join(tmp, "state.pt")
        torch.save(state, state_path)
        # the ranks alone on the card, then the one process
        launch.spawn(_ddp_step_rank, 2, (state_path, tmp), devices=layout["devices"],
                     backend=layout["backend"], timeout_s=240, group_timeout_s=180)
        one = ddp_steps(state, torch.device("cuda"))
        reordered = ddp_steps(state, torch.device("cuda"), torch.arange(BATCH - 1, -1, -1))
        one16 = ddp_steps(state, torch.device("cuda"), dtype="bfloat16", steps=1)
        r0, r1 = (torch.load(os.path.join(tmp, f"step_r{r}.pt")) for r in (0, 1))
        t_step = time.perf_counter() - t0

        root, work = os.path.join(tmp, "resource"), os.path.join(tmp, "work")
        n_train, n_val, n_test = DDP_TREE
        make_synthetic_voc(root, n_train=n_train, n_val=n_val, n_test=n_test, min_size=300,
                           max_size=501)
        launch.spawn(_ddp_data_rank, 2, (root, work, tmp), devices=layout["devices"],
                     backend=layout["backend"], timeout_s=420, group_timeout_s=180)
        one_hist = {}
        for name, extra in (("streamed", {}), ("cache_device", {"cache_device": True})):
            seg = SemanticSegmentation({**ddp_conf(data_path_conf(root)), **extra},
                                       work_dir=os.path.join(tmp, f"one_{name}"), device="cuda")
            one_hist[name] = seg.train()
            del seg
        data = [json.loads(Path(tmp, f"data_r{r}.json").read_text()) for r in (0, 1)]
        # one process evaluating the two ranks' checkpoint
        seg = SemanticSegmentation({**ddp_conf(data_path_conf(root)), "model_loading": True},
                                   work_dir=os.path.join(work, "streamed"), device="cuda")
        one_miou = seg.evaluate().result()
        pngs = sorted(os.listdir(os.path.join(work, "streamed", "test_results")))
        del seg
        seg = SemanticSegmentation({**ddp_conf(data_path_conf(root)), "model_loading": True,
                                    "int8_infer": True},
                                   work_dir=os.path.join(work, "streamed"), device="cuda")
        one_int8 = {"miou": seg.evaluate().result(),
                    "ranges": {k: v.item() for k, v in seg._quant.items()}}
        del seg
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic

    # ---- checks ----
    names = ("depthwise_fwd_s1", "depthwise_fwd_s2", "depthwise_bwd_s1", "depthwise_bwd_s2")
    pixels = BATCH * SIZE * SIZE

    def loss_rel(run):
        return [abs(a - b) / abs(b) for a, b in zip(run["losses"], one["losses"])]

    def cm_diff(run):
        return [int((a - b).abs().sum()) for a, b in zip(run["cms"], one["cms"])]

    def param_err(run):
        return max((run["state"][k] - v).abs().max().item()
                   for k, v in one["state"].items() if v.is_floating_point())

    def grad_rel(run):
        diff = sum((run["grads"][n] - g).double().square().sum() for n, g in one["grads"].items())
        return math.sqrt(diff / sum(g.double().square().sum() for g in one["grads"].values()))

    def grad_worst(run, k=8):
        """The tensors that hold most of the gradients' squared distance:
        (name, share of it, the tensor's own relative distance)."""
        sq = {n: (run["grads"][n] - g).double().square().sum().item()
              for n, g in one["grads"].items()}
        total = sum(sq.values()) or 1.0
        top = sorted(sq, key=lambda n: -sq[n])[:k]
        return [(n, sq[n] / total, math.sqrt(sq[n]) / max(one["grads"][n].norm().item(), 1e-30))
                for n in top]

    spread = {"loss_rel": loss_rel(reordered), "cm_abs_diff": cm_diff(reordered),
              "param_max_abs_err": param_err(reordered), "grad_rel_2norm": grad_rel(reordered)}
    grad_bound = max(1e-5, DDP_SPREAD * spread["grad_rel_2norm"])
    # after an update the loss distance is chaotic from step to step: the
    # reordered run's largest one
    loss_bound = [DDP_LOSS_REL] + [max(DDP_LOSS_REL, DDP_SPREAD * max(spread["loss_rel"][1:]))
                                   ] * (DDP_STEPS - 1)
    cm_bound = [max(8, pixels // 4096)] + [max(8, pixels // 4096, DDP_SPREAD * d)
                                           for d in spread["cm_abs_diff"][1:]]
    identical = {dtype: all(torch.equal(r0[dtype]["state"][k], r1[dtype]["state"][k])
                            for k in r0[dtype]["state"]) for dtype in ("float32", "bfloat16")}
    per_rank = [[[c[k] for k in names] for c in r["float32"]["launches"]] for r in (r0, r1)]
    one_launches = [[c[k] for k in names] for c in one["launches"]]
    # bfloat16: the bounds tests/test_torch_dtype.py states against JAX
    lr = flagship_conf()["hps"].get("lr", 1e-4)
    b_loss = abs(r0["bfloat16"]["losses"][0] - one16["losses"][0]) / one16["losses"][0]
    stats = [k for k in one16["state"] if k.endswith(("running_mean", "running_var"))]
    s2 = torch.cat([r0["bfloat16"]["state"][k].flatten() for k in stats])
    s1 = torch.cat([one16["state"][k].flatten() for k in stats])
    b_stats = ((s2 - s1).norm() / s1.norm()).item()
    params = [k for k in one16["state"] if k not in stats and one16["state"][k].is_floating_point()
              and not k.endswith("num_batches_tracked")]
    p0 = torch.cat([state[k].cpu().flatten() for k in params])
    d2 = torch.cat([r0["bfloat16"]["state"][k].flatten() for k in params]) - p0
    d1 = torch.cat([one16["state"][k].flatten() for k in params]) - p0
    b_update = (d2 - d1).abs().max().item()
    b_sign = (torch.sign(d2) == torch.sign(d1)).double().mean().item()

    hist_err = {}
    for name in ("streamed", "cache_device"):
        h2, h1 = data[0][name]["history"], one_hist[name]
        hist_err[name] = {
            "loss_rel": max(abs(a - b) / abs(b) for k in ("loss", "val_loss")
                            for a, b in zip(h2[k], h1[k])),
            "miou_abs": max(abs(a - b) for k in ("miou", "val_miou") for a, b in zip(h2[k], h1[k]))}
    r8, o8 = data[0]["evaluate_int8"]["ranges"], one_int8["ranges"]
    int8_rel = (max(abs(r8[k] - v) / v for k, v in o8.items()) if sorted(r8) == sorted(o8)
                else math.inf)
    n_img = DDP_TREE[0] * 2
    result = {
        **{k: layout[k] for k in ("backend", "cards", "world")},
        "note": ("two ranks on one card: a correctness check, not a speed" if layout["cards"] < 2
                 else "a card a rank"),
        "step": {"batch": BATCH, "image": SIZE, "rows_per_rank": BATCH // 2,
                 "loss_rel": loss_rel(r0["float32"]), "loss_bound": loss_bound,
                 "grad_rel_2norm": grad_rel(r0["float32"]), "grad_bound": grad_bound,
                 "grad_worst_tensors": grad_worst(r0["float32"]),
                 "param_max_abs_err": param_err(r0["float32"]),
                 "cm_abs_diff": cm_diff(r0["float32"]), "cm_bound": cm_bound,
                 "one_process_rows_reversed": spread,
                 "ranks_bit_identical": identical, "launches_per_rank_step": per_rank,
                 "one_process_launches_per_step": one_launches,
                 "step_s_rank0": r0["float32"]["step_s"], "step_s_one_process": one["step_s"],
                 "collective_ms": r0["collective_ms"],
                 "bfloat16": {"loss_rel": b_loss, "bn_stats_rel_norm": b_stats,
                              "update_max_abs_err": b_update, "update_sign_agreement": b_sign},
                 "s": t_step},
        "data_path": {"histories": {n: data[0][n]["history"] for n in ("streamed", "cache_device")},
                      "one_process": one_hist, "history_err": hist_err,
                      "ranks_equal_histories": all(data[0][n]["history"] == data[1][n]["history"]
                                                   for n in ("streamed", "cache_device")),
                      "evaluate_miou": data[0]["evaluate_miou"], "one_process_miou": one_miou,
                      "evaluate_int8_miou": data[0]["evaluate_int8"]["miou"],
                      "one_process_int8_miou": one_int8["miou"],
                      "int8_ranges_max_rel_diff": int8_rel,
                      "test_pngs": len(pngs),
                      "test_mismatched_pixels": [d["test"]["mismatched_pixels"] for d in data],
                      "train_img_per_s": {n: n_img / data[0][n]["train_s"]
                                          for n in ("streamed", "cache_device")},
                      "profiled_epoch": data[0]["profiled_epoch"]},
        "s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"ddp": result}))

    failures = []
    step = result["step"]
    if not all(d <= b for d, b in zip(step["loss_rel"], loss_bound)):
        failures.append(f"step losses {step['loss_rel']} > {loss_bound}")
    if not step["grad_rel_2norm"] <= grad_bound:
        failures.append(f"first step's gradients {step['grad_rel_2norm']} > {grad_bound}")
    if not step["param_max_abs_err"] <= DDP_PARAM_ATOL:
        failures.append(f"parameters after {DDP_STEPS} steps {step['param_max_abs_err']} > "
                        f"{DDP_PARAM_ATOL}")
    if not all(d <= b for d, b in zip(step["cm_abs_diff"], cm_bound)):
        failures.append(f"confusion matrices differ by {step['cm_abs_diff']} > {cm_bound}")
    if not all(identical.values()):
        failures.append(f"ranks hold different parameters or statistics: {identical}")
    expect = [15, 3, 15, 3]
    if any(step != expect for rank in per_rank for step in rank) or any(
            step != expect for step in one_launches):
        failures.append(f"K2-K5 launches a step {per_rank} (one process {one_launches})")
    if not (b_loss <= 1e-3 and b_stats <= 3e-2 and b_update <= 2 * lr * 1.01 and b_sign >= 0.6):
        failures.append(f"bfloat16 step: {result['step']['bfloat16']}")
    for name, (loss_b, miou_b) in DDP_HISTORY.items():
        e = hist_err[name]
        if not (e["loss_rel"] <= loss_b and e["miou_abs"] <= miou_b):
            failures.append(f"{name} train() history against one process: {e}")
    if not result["data_path"]["ranks_equal_histories"]:
        failures.append("the ranks' train() histories differ")
    if not abs(data[0]["evaluate_miou"] - one_miou) <= DDP_MIOU_ABS:
        failures.append(f"evaluate() mIoU {data[0]['evaluate_miou']} vs one process {one_miou}")
    if not (data[0]["evaluate_int8"] == data[1]["evaluate_int8"] and int8_rel <= DDP_INT8_RANGE_REL
            and abs(data[0]["evaluate_int8"]["miou"] - one_int8["miou"]) <= DDP_MIOU_ABS):
        failures.append(f"int8 evaluate() on two ranks {data[0]['evaluate_int8']['miou']} "
                        f"(ranges {int8_rel} apart) vs one process {one_int8['miou']}")
    if len(pngs) != DDP_TREE[2] or any(d["test"]["mismatched_pixels"] for d in data) or sorted(
            data[0]["test"]["names"] + data[1]["test"]["names"]) != [p[:-4] for p in pngs]:
        failures.append(f"test(): {len(pngs)} PNGs, {result['data_path']['test_mismatched_pixels']}")
    if failures:
        raise SystemExit("ddp: " + "; ".join(failures))
    return {"train_step_ddp": r0["float32"]["launches"][0], **data[0]["launches"]}


# ---------------------------------------------------------------------------
# spatial: mesh_space 2, each rank some rows of every image

SPATIAL_SIZE, SPATIAL_BATCH, SPATIAL_STEPS = 1024, 4, 3
SPATIAL_XCEPTION_BATCH = 2
# two ranks (1 data × 2 space) against one process, float32, TF32 off,
# cuDNN deterministic: each step's loss to 1e-4 relative; each parameter's
# update after the steps to 1e-2 of one process's in relative 2-norm
# (float32 summation order alone moved the first step's gradients by
# 2.9e-3 across a data split, PERF.md §6), or to 10× (DDP_SPREAD)
# the distance of one process taking the same batches with their rows
# reversed where that is larger: a parameter whose exact gradient is zero
# (a BN bias before a conv and another BN, which removes it) gets a
# gradient of rounding noise, which Keras Adam turns into ±lr updates of
# any sign in any run; segment()'s labels equal wherever one process's top
# two upsampled logits differ by more than 1e-3 relative; the eval step's
# confusion matrix over every pixel
SPATIAL_LOSS_REL, SPATIAL_UPDATE_REL, SPATIAL_MARGIN_REL = 1e-4, 1e-2, 1e-3
# a rank's confusion matrices against one process's, in L1 distance (a
# pixel whose class moves moves two entries by one): an eval step's (the
# plain and the test-time-augmented one) to 2 × 1e-5 of its pixels (84 at
# 4 × 1024²; read 0, and one row at a rank boundary wrong throughout is
# 4096 pixels); a train step's (plain and each option) as the ddp phase
# holds its steps: to 1/4096 of the pixels or DDP_SPREAD × the distance of
# one process taking the batch rows reversed at that step, where larger
# (after the first step Keras Adam's ±lr updates of the zero-gradient
# biases move pixels' classes in any run: the ranks' three option steps
# moved 14,656–19,480 in all)
SPATIAL_CM_MOVED = 1e-5


def _cm_l1(a, b) -> int:
    """The L1 distance of two confusion matrices."""
    return int((a.long() - b.long()).abs().sum())


def _cm_bound(cm, spread: int | None = None) -> float:
    """The bound of a matrix's distance from one process's ``cm``: an eval
    step's (``spread`` None) ``SPATIAL_CM_MOVED`` of its pixels; a train
    step's 1/4096 of them or ``DDP_SPREAD`` × ``spread`` (the rows-reversed
    run's distance at that step), where larger."""
    pixels = int(cm.sum())
    if spread is None:
        return 2 * SPATIAL_CM_MOVED * pixels
    return max(pixels // 4096, DDP_SPREAD * spread)
# the row-window kernel checks: Xception's odd heights at 512² (253, 127)
# and 1024² (509, 255, 128), B = 2, stride 1 (its sites) and 2
SPATIAL_XCEPTION_HEIGHTS = ((253, 128), (127, 256), (509, 64), (255, 128), (128, 256))
# the step options under mesh_space, each SPATIAL_STEPS train_step()s of
# the flagship from the plain run's weights and batches, held to one
# process by its bounds (the plain run's rows-reversed distances the
# yardstick of the updates)
SPATIAL_OPTIONS = {"fused_tail": {"fused_tail": True}, "remat": {"remat": True},
                   "augment": {"augment": {"random_flip": True, "scale_range": [0.5, 2.0]}}}
# test-time augmentation in one eval_step(); segment() of a non-square batch
SPATIAL_TTA = {"eval_scales": [0.75, 1.0, 1.25], "eval_flip": True}
SPATIAL_NONSQUARE = (SPATIAL_SIZE, 768)


# the other backbones' families under mesh_space, each at 1024² × 2: a
# segment() from the initial weights and 2 train_step()s, held to one
# process by the flagship's bounds (each with its own rows-reversed run
# as the yardstick).  segment() after the steps would compare other
# weights: 3 steps of ±lr on the zero-gradient BN parameters move the
# ranks' weights up to 0.44 (relative 2-norm) from one process's, each
# within its rows-reversed bound, which moves labels at clear pixels (on
# an H100, 311 of NASNet-Mobile's 2,078,093 and 8 of DenseNet-121's).
# Stochastic depth off (EfficientNet): reversed rows would draw another
# image's per-sample mask; its draws under a space split are held on the
# CPU (tests/test_torch_spatial_backbones.py, float64, 1e-12)
SPATIAL_BACKBONES = ("nasnetmobile", "efficientnetb0", "densenet121")
SPATIAL_BACKBONE_BATCH, SPATIAL_BACKBONE_STEPS = 2, 2
# int8_infer segment() at 1024² × 2 (calibrated on its images), the
# flagship and Xception.  The ranks' int8 products are exact and equal
# one process's for equal int8 inputs; what differs is the float32 work
# before each quantize (cuDNN on a row window, the whole image in one
# process), whose rounding can move an activation that lies at a rounding
# boundary of x/s by one int8 step (1/127 of the site's range), which
# moves the logits by far more than float32 rounding.  So: the same sites
# by name and calls; the ranges (abs-max of the same activations) to
# 1e-5 relative; the labels equal wherever one process's int8 top two
# upsampled logits differ by more than 1e-2 relative (10× the float
# paths' margin), and at no more than 1e-3 of all pixels anywhere
SPATIAL_INT8 = ("mobilenetv2", "xception")
SPATIAL_INT8_RANGE_REL, SPATIAL_INT8_MARGIN_REL, SPATIAL_INT8_LABEL_SHARE = 1e-5, 1e-2, 1e-3
# the allocations live at a step's peak (torch.cuda.memory's history of one
# integer-label step): the largest, grouped by the innermost frame of the
# port or this script
PEAK_TOP = 8


def spatial_conf(conf: dict, ranks: int) -> dict:
    """``conf`` with dropout 0 (element-wise dropout draws from each rank's
    own stream), over ``ranks`` ranks split along the image height alone."""
    conf = ddp_conf(conf)
    if ranks > 1:
        conf.update(multi_gpu=True, num_gpus=ranks, mesh_space=ranks)
    return conf


def spatial_batches(n: int, batch: int, seed: int = 11) -> list[dict]:
    """Global batches of ``batch`` × 1024² made on the CPU from a seed, the
    same in every process: images in (−1, 1), integer labels."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    size = SPATIAL_SIZE
    return [{"image": torch.rand(batch, size, size, 3, generator=gen) * 2 - 1,
             "label": torch.randint(0, CLASSES, (batch, size, size), generator=gen)}
            for _ in range(n)]


def spatial_run(conf: dict, device, steps: int, tag: str, evaluate: bool, margins: bool,
                reverse: bool = False, steps_only: bool = False, history: bool = False) -> dict:
    """The facade on ``conf`` (random weights from seed 1024, stochastic
    depth off: :func:`no_stochastic_depth`): ``segment()`` of the first
    batch (the second call profiled), from the same weights in every
    process (after the steps, the ranks' and one process's weights differ
    by their steps' rounding, which Keras Adam turns into ±lr on
    zero-gradient parameters), then ``steps`` ``train_step()``s on whole
    images (a rank takes its rows), the last profiled, and, with
    ``evaluate``, one ``eval_step()``.  Per step the loss, the kernels'
    launches and the halo exchanges; peak memory of the steps; each
    parameter's update; the labels; with ``margins`` (one process) where
    its top two upsampled logits differ by more than
    ``SPATIAL_MARGIN_REL`` relative.  ``steps_only``: the steps alone,
    none profiled; ``reverse`` (which implies it): the batches' rows in
    reverse order (the yardstick of summation order).  ``history``: the
    second step under the allocator's history (:func:`peak_allocations`)."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.parallel import mesh, spatial

    steps_only = steps_only or reverse
    seg = SemanticSegmentation(conf, device=device)
    no_stochastic_depth(seg.model)
    before = {n: p.detach().clone() for n, p in seg.model.named_parameters()}
    data = spatial_batches(steps, conf["hps"]["batch_size"])
    gpu = [{k: (v.flip(0) if reverse else v).to(device) for k, v in b.items()} for b in data]
    out = {"losses": [], "cms": [], "launches": [], "exchanges": [], "step_s": [],
           "step_peak_gib": []}

    def serve():
        images = gpu[0]["image"]
        kernels.reset_launch_counts()
        spatial.reset_counts()
        out["labels"] = torch.from_numpy(seg.segment(images))
        out["segment_launches"] = kernels.launch_counts()
        out["segment_exchanges"] = dict(spatial.counts)
        prof = profile_device(lambda: seg.segment(images),
                              OUT / f"spatial_{tag}_segment_r{mesh.rank()}.txt",
                              f"{tag} segment, rank {mesh.rank()}", 30)
        out["segment_device_ms"] = prof["device_ms"]
        if margins:
            out["clear"] = clear_pixels(seg.model, images, SPATIAL_MARGIN_REL)

    if not steps_only:
        serve()
    torch.cuda.synchronize()
    for i, b in enumerate(gpu):
        kernels.reset_launch_counts()
        spatial.reset_counts()
        torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        if i == steps - 1 and not steps_only:  # the last step profiled (its wall time too)
            res = {}
            prof = profile_device(lambda: res.update(seg.train_step(b)),
                                  OUT / f"spatial_{tag}_train_r{mesh.rank()}.txt",
                                  f"{tag} train_step, rank {mesh.rank()}", 30)
            out["step_device_ms"] = prof["device_ms"]
        elif i == 1 and history:
            res = {}
            out["peak_allocations"] = peak_allocations(lambda: res.update(seg.train_step(b)),
                                                       device)
        else:
            res = seg.train_step(b)
        out["losses"].append(res["loss"].item())
        out["cms"].append(res["cm"].cpu())
        out["step_s"].append(time.perf_counter() - t)
        if i == 0:  # the first step's gradients (summed over the ranks)
            out["grads1"] = {n: p.grad.detach().cpu() for n, p in seg.model.named_parameters()}
        out["launches"].append(kernels.launch_counts())
        out["exchanges"].append(dict(spatial.counts))
        out["step_peak_gib"].append(torch.cuda.max_memory_allocated(device) / 2**30)
    out["peak_gib"] = max(out["step_peak_gib"])
    out["updates"] = {n: (p.detach() - before[n]).cpu() for n, p in seg.model.named_parameters()}
    if steps_only:
        return out
    if evaluate:
        m = seg.eval_step(gpu[0])
        out["eval"] = {"loss": m["loss"].item(), "cm": m["cm"].cpu()}
    return out


def clear_pixels(model, images, rel: float):
    """Where ``model``'s top two upsampled logits of ``images`` (in eval
    mode) differ by more than ``rel`` of the top one: the pixels whose
    label rounding cannot move, on the CPU."""
    import torch
    import torch.nn.functional as F

    with torch.inference_mode():
        model.eval()
        logits, up = model(images, return_presample=True)
        upl = F.interpolate(logits.permute(0, 3, 1, 2), scale_factor=up, mode="bilinear",
                            align_corners=False)
        top = upl.topk(2, dim=1).values
        return ((top[:, 0] - top[:, 1]) > rel * top[:, 0].abs()).cpu()


def peak_allocations(fn, device, top: int = PEAK_TOP) -> dict:
    """Run ``fn`` with the CUDA caching allocator's history on (Python
    stacks) and replay its trace of allocations and frees to the moment
    the bytes allocated since the start peak: the allocations live then,
    summed by the innermost frame in the port or this script, the largest
    ``top``; beside the bytes allocated before ``fn`` (weights, optimizer
    state, batches) and ``torch.cuda.max_memory_allocated``.  Allocations
    made on autograd's device thread carry no Python frame: those are
    summed by size.  ``peak_at_event_share``: where in the step's trace
    the peak falls (the forward first, then the backward)."""
    import torch

    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    try:
        fn()
        torch.cuda.synchronize(device)
        trace = torch.cuda.memory._snapshot(device)["device_traces"][device.index or 0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = [e for e in trace if e["action"] in ("alloc", "free_requested", "free_completed")]
    live, total, peak, at = {}, 0, 0, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            total += e["size"]
            if total > peak:
                peak, at = total, i
        elif e["addr"] in live:
            total -= live.pop(e["addr"])["size"]
    live = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        else:
            live.pop(e["addr"], None)
    where = {}
    for e in live.values():
        frames = e.get("frames") or []
        ours = [f for f in frames if "deeplabv3plus_keras_tpu_torch" in f["filename"]
                or f["filename"].endswith("chip_smoke.py")]
        if ours or frames:
            f = (ours or frames)[0]
            key = f"{f['filename'].split('deeplabv3plus_keras_tpu_torch/')[-1]}:{f['line']} {f['name']}"
        else:  # made on autograd's device thread: no Python frame; by size
            key = f"(no Python frame) {e['size'] / 2**20:.1f} MiB each"
        w = where.setdefault(key, [0, 0])
        w[0] += e["size"]
        w[1] += 1
    largest = sorted(where.items(), key=lambda kv: -kv[1][0])[:top]
    return {"before_step_gib": base / 2**30, "step_peak_gib": torch.cuda.max_memory_allocated(device)
            / 2**30, "trace_peak_gib": (base + peak) / 2**30, "events": len(events),
            "peak_at_event_share": (at + 1) / max(len(events), 1), "live_at_peak": len(live),
            "top": [{"where": k, "gib": v[0] / 2**30, "allocations": v[1]} for k, v in largest]}


def spatial_int8(conf: dict, device, margins: bool) -> dict:
    """``int8_infer`` on ``conf``: ``calibrate_int8()`` on the first
    batch's images (whole images: a rank calibrates on its rows), then
    ``segment()`` of them: the ranges, the sites that ran int8 (name →
    calls), the labels, the kernels' launches and the exchanges of the
    call; with ``margins`` (one process), where the int8 top two upsampled
    logits differ by more than ``SPATIAL_INT8_MARGIN_REL`` relative."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.ops import quant
    from deeplabv3plus_keras_tpu_torch.parallel import spatial

    seg = SemanticSegmentation({**conf, "int8_infer": True}, device=device)
    images = spatial_batches(1, conf["hps"]["batch_size"])[0]["image"].to(device)
    ranges = seg.calibrate_int8(images)
    kernels.reset_launch_counts()
    spatial.reset_counts()
    quant.reset_counts()
    out = {"labels": torch.from_numpy(seg.segment(images)), "sites": dict(quant.sites),
           "int8_convs": quant.counts["int8_conv"],
           "ranges": {k: float(v) for k, v in ranges.items()},
           "launches": kernels.launch_counts(), "exchanges": dict(spatial.counts)}
    if margins:
        with quant.quantized(seg.model, ranges):
            out["clear"] = clear_pixels(seg.model, images, SPATIAL_INT8_MARGIN_REL)
    return out


def spatial_serve(conf: dict, device, margins: bool) -> dict:
    """The facade on ``conf`` with test-time augmentation
    (:data:`SPATIAL_TTA`): one ``eval_step()`` of the first batch (its
    loss and matrix, peak memory, exchanges, launches), then ``segment()``
    of a :data:`SPATIAL_NONSQUARE` batch (its labels, exchanges, launches;
    with ``margins``, where one process's top two upsampled logits differ
    by more than ``SPATIAL_MARGIN_REL`` relative)."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.parallel import spatial

    seg = SemanticSegmentation({**conf, **SPATIAL_TTA}, device=device)
    batch = {k: v.to(device) for k, v in spatial_batches(1, conf["hps"]["batch_size"])[0].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    spatial.reset_counts()
    m = seg.eval_step(batch)
    out = {"tta": {"loss": m["loss"].item(), "cm": m["cm"].cpu(),
                   "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
                   "launches": kernels.launch_counts(), "exchanges": dict(spatial.counts)}}
    H, W = SPATIAL_NONSQUARE
    gen = torch.Generator().manual_seed(17)
    images = (torch.rand(conf["hps"]["batch_size"], H, W, 3, generator=gen) * 2 - 1).to(device)
    kernels.reset_launch_counts()
    spatial.reset_counts()
    out["nonsquare"] = {"labels": torch.from_numpy(seg.segment(images)),
                        "launches": kernels.launch_counts(), "exchanges": dict(spatial.counts)}
    if margins:
        out["nonsquare"]["clear"] = clear_pixels(seg.model, images, SPATIAL_MARGIN_REL)
    return out


def spatial_flagship(device, world: int, margins: bool) -> dict:
    """The flagship's runs of the spatial phase over ``world`` ranks (1: one
    process): 3 steps, ``segment()`` and an eval step; the 3 steps of each
    of :data:`SPATIAL_OPTIONS`; test-time augmentation and a non-square
    ``segment()`` (:func:`spatial_serve`)."""
    conf = spatial_conf(flagship_conf(SPATIAL_SIZE, SPATIAL_BATCH), world)
    out = {"flagship": spatial_run(conf, device, SPATIAL_STEPS, "flagship", evaluate=True,
                                   margins=margins, history=True)}
    for name, extra in SPATIAL_OPTIONS.items():
        out[name] = spatial_run({**conf, **extra}, device, SPATIAL_STEPS, name, evaluate=False,
                                margins=False, steps_only=True, history=name == "fused_tail")
    out.update(spatial_serve(conf, device, margins))
    return out


def spatial_others(device, world: int, margins: bool) -> dict:
    """The other backbones' runs of the spatial phase (``segment()`` and
    2 steps, each of
    :data:`SPATIAL_BACKBONES`) and the int8
    ``segment()`` of the flagship and Xception (:data:`SPATIAL_INT8`), over
    ``world`` ranks (1: one process)."""
    out = {}
    for name in SPATIAL_BACKBONES:
        conf = spatial_conf(backbone_conf(name)(SPATIAL_SIZE, SPATIAL_BACKBONE_BATCH), world)
        out[name] = spatial_run(conf, device, SPATIAL_BACKBONE_STEPS, name, evaluate=False,
                                margins=margins)
    for name in SPATIAL_INT8:
        conf = (xception_conf if name == "xception" else flagship_conf)(SPATIAL_SIZE,
                                                                         SPATIAL_BACKBONE_BATCH)
        out[f"int8_{name}"] = spatial_int8(spatial_conf(conf, world), device, margins)
    return out


def _spatial_rank(out_dir: str) -> None:
    """A rank of the spatial phase: the flagship (3 steps, segment(), an
    eval step; the step options, test-time augmentation and a non-square
    segment()) under nhwc, Xception (one step, segment()) under nhwc and
    under bhcw, then the other backbones and int8 (:func:`spatial_others`)
    under nhwc, each over the (1 × 2) grid."""
    import torch

    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    ddp_numerics()
    device = torch.device("cuda", torch.cuda.current_device())
    world = mesh.world_size()
    out = {}
    with dw_layout("nhwc"):
        out.update(spatial_flagship(device, world, margins=False))
    for layout in ("nhwc", "bhcw"):
        with dw_layout(layout):
            out[f"xception_{layout}"] = spatial_run(
                spatial_conf(xception_conf(SPATIAL_SIZE, SPATIAL_XCEPTION_BATCH), world), device,
                1, f"xception_{layout}", evaluate=False, margins=False)
    with dw_layout("nhwc"):
        out.update(spatial_others(device, world, margins=False))
    torch.save(out, os.path.join(out_dir, f"spatial_r{mesh.rank()}.pt"))


def check_spatial_windows(card: str) -> dict:
    """K2–K5 on row windows (``depthwise_conv(..., window=(Ho, pad_t))``),
    each window the output rows of one of 2 ranks (``mesh.rows_of``, uneven
    where Ho is odd) with the rows they read, against the plain versions on
    the same window: the flagship's distinct sites at 1024² × 4, the k = 5
    and 7 sites of NASNet-Mobile and EfficientNet-B0 at 1024² × 2 (stride 1
    and 2, odd heights), and 3×3 sites at Xception's odd heights at stride
    1 and 2 (and stride 1 under ``bhcw``, the K6/K7 route's symmetric
    halo).  Forward and dx to 1e-5
    of the reference's largest value, dk to 1e-4 of Σ|x·g|."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.kernels import (
        depthwise_conv,
        depthwise_conv_backward,
        depthwise_conv_backward_plain,
        depthwise_conv_plain,
        same_pads,
    )
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(5)
    seg = SemanticSegmentation(flagship_conf(SPATIAL_SIZE, SPATIAL_BATCH), device="cuda")
    images = torch.rand(SPATIAL_BATCH, SPATIAL_SIZE, SPATIAL_SIZE, 3, device="cuda", generator=g)
    sites = {(shape, stride, dil, tuple(mod.weight.shape)): mod.weight.detach()
             for shape, stride, dil, mod in depthwise_sites(seg.model, images * 2 - 1)}
    del seg
    # the k = 5 and 7 sites of the backbones that have them, at 1024² × 2
    for name in ("nasnetmobile", "efficientnetb0"):
        seg = SemanticSegmentation(backbone_conf(name)(SPATIAL_SIZE, SPATIAL_BACKBONE_BATCH),
                                   device="cuda")
        for shape, stride, dil, mod in depthwise_sites(
                seg.model, images[:SPATIAL_BACKBONE_BATCH] * 2 - 1):
            if mod.weight.shape[-1] in (5, 7):
                sites[(shape, stride, dil, tuple(mod.weight.shape))] = mod.weight.detach()
        del seg
    for H, C in SPATIAL_XCEPTION_HEIGHTS:
        w = torch.randn(C, 1, 3, 3, device="cuda", generator=g)
        for stride in (1, 2):
            sites[((2, C, H, H), stride, (1, 1), tuple(w.shape))] = w
    cl = torch.channels_last
    rows, worst = [], {"forward": 0.0, "dx": 0.0, "dk": 0.0}
    for (shape, stride, dil, _), w in sites.items():
        B, C, H, W = shape
        k = w.shape[-1]
        Ho, pt, _ = same_pads(H, k, stride, dil[0])
        x = torch.randn(shape, device="cuda", generator=g).contiguous(memory_format=cl)
        # Xception's stride-1 sites also on the channels-first route (K6/K7)
        cf = (k, stride, tuple(dil)) == (3, 1, (1, 1)) and B == 2
        layouts = ("nhwc", "bhcw") if cf else ("nhwc",)
        for layout in layouts:
            for r in range(2):
                o0, o1 = mesh.rows_of(Ho, 2, r)
                lo, hi = o0 * stride - pt, (o1 - 1) * stride - pt + dil[0] * (k - 1) + 1
                c0, c1 = max(lo, 0), min(hi, H)
                xw = x[:, :, c0:c1].contiguous(memory_format=cl)
                win = (o1 - o0, c0 - lo)
                gout = torch.randn((B, C, o1 - o0, W if stride == 1 else -(-W // 2)), device="cuda",
                                   generator=g).contiguous(memory_format=cl)
                with dw_layout(layout):
                    y = depthwise_conv(xw, w, stride, dil, window=win)
                    dx, dk = depthwise_conv_backward(xw, w, gout, stride, dil, window=win)
                ref = depthwise_conv_plain(xw, w, stride, dil, window=win)
                rdx, rdk = depthwise_conv_backward_plain(xw, w, gout, stride, dil, window=win)
                _, dk_abs = depthwise_conv_backward_plain(xw.abs(), w, gout.abs(), stride, dil,
                                                          window=win)
                torch.cuda.synchronize()
                e_y = (y - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
                e_dx = (dx - rdx).abs().max().item() / max(rdx.abs().max().item(), 1e-30)
                e_dk = ((dk - rdk).abs() / (dk_abs + 1e-30)).max().item()
                row = {"shape_nchw": list(shape), "k": k, "stride": stride, "dilation": list(dil),
                       "layout": layout, "rank": r, "out_rows": [o0, o1], "window": list(win),
                       "x_rows": c1 - c0, "fwd_rel": e_y, "dx_rel": e_dx, "dk_rel_abs": e_dk}
                rows.append(row)
                worst = {"forward": max(worst["forward"], e_y), "dx": max(worst["dx"], e_dx),
                         "dk": max(worst["dk"], e_dk)}
                if not (e_y <= 1e-5 and e_dx <= 1e-5 and e_dk <= 1e-4 and y.shape == ref.shape):
                    raise SystemExit(f"spatial: a row-window kernel disagrees with plain: {row}")
    (OUT / "spatial_windows.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    by_k = {}
    for r in rows:
        n = by_k.setdefault(f"k{r['k']}_s{r['stride']}", {"windows": 0, "worst_fwd": 0.0,
                                                         "worst_dx": 0.0, "worst_dk": 0.0})
        n["windows"] += 1
        n["worst_fwd"] = max(n["worst_fwd"], r["fwd_rel"])
        n["worst_dx"] = max(n["worst_dx"], r["dx_rel"])
        n["worst_dk"] = max(n["worst_dk"], r["dk_rel_abs"])
    result = {"windows": len(rows), "worst": worst, "by_k_and_stride": by_k,
              "s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"spatial_windows": result}))
    return result


def check_tail_windows(card: str) -> dict:
    """T1/T2 on row windows (``window=True``: the first and last logits rows
    context only) at the flagship's logits under ``mesh_space`` at 1024² ×
    4, (4, 512, 512, 21) float32: each of 2 ranks' 256 sites with a
    context row each side, clamped at the image's top (rank 0) or bottom
    (rank 1), and a 4-way split's second rank (both context rows its
    neighbours'); integer and one-hot labels of the sites' rows, one
    padded sample.  Each against its windowed plain version on the same
    values (sums to ``TAIL_SUM_REL``, the matrix exactly, dlogits to
    ``TAIL_DX_REL`` of their largest), timed (CUDA graphs); the two ranks'
    sums and matrices against T1 on the whole map."""
    import torch
    import torch.nn.functional as F

    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt
    from deeplabv3plus_keras_tpu_torch.parallel import mesh
    from deeplabv3plus_keras_tpu_torch.train.loss import SS_NW, SS_PW

    t0 = time.perf_counter()
    B, h, C = SPATIAL_BATCH, SPATIAL_SIZE // 2, CLASSES
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(B, h, h, C, device="cuda", generator=g) * 3
    ids = torch.randint(0, C, (B, 2 * h, 2 * h), device="cuda", generator=g)
    valid = torch.ones(B, dtype=torch.int32, device="cuda")
    valid[-1] = 0
    scale = valid.float() / (float(valid.sum()) * 4 * h * h)
    windows = {"rank0_of_2": mesh.rows_of(h, 2, 0), "rank1_of_2": mesh.rows_of(h, 2, 1),
               "rank1_of_4": mesh.rows_of(h, 4, 1)}
    rows, failures = [], []
    for layout in ("integer", "one_hot"):
        labels = ids if layout == "integer" else F.one_hot(ids, C).float()
        whole_sums, whole_cm = pt.parity_tail_forward(x, labels, SS_PW, SS_NW, valid)
        split_sums, split_cm = 0, 0
        for name, (a, b) in windows.items():
            at = torch.arange(a - 1, b + 1, device="cuda").clamp(0, h - 1)
            blk, lab = x[:, at].contiguous(), labels[:, 2 * a:2 * b].contiguous()
            sums, cm = pt.parity_tail_forward(blk, lab, SS_PW, SS_NW, valid, window=True)
            dx = pt.parity_tail_backward(blk, lab, SS_PW, SS_NW, scale, window=True)
            ref_sums, ref_cm = pt.parity_tail_forward_plain(blk, lab, SS_PW, SS_NW, valid,
                                                            window=True)
            ref_dx = pt.parity_tail_backward_plain(blk, lab, SS_PW, SS_NW, scale, window=True)
            row = {"window": name, "labels": layout, "sites": [a, b], "logits_rows": b - a + 2,
                   "sums_max_rel_err": ((sums - ref_sums).abs() / ref_sums.abs()).max().item(),
                   "cm_differing": int((cm - ref_cm).abs().sum()),
                   "dx_max_abs_err": (dx - ref_dx).abs().max().item(),
                   "dx_max_abs": ref_dx.abs().max().item(),
                   "context_dx_max_abs": dx[:, [0, -1]].abs().max().item(),
                   "ms_fwd": cuda_ms(lambda: pt.parity_tail_forward(blk, lab, SS_PW, SS_NW, valid,
                                                                    window=True)),
                   "ms_bwd": cuda_ms(lambda: pt.parity_tail_backward(blk, lab, SS_PW, SS_NW, scale,
                                                                     window=True))}
            rows.append(row)
            if not (row["sums_max_rel_err"] <= TAIL_SUM_REL and row["cm_differing"] == 0
                    and row["dx_max_abs_err"] <= TAIL_DX_REL["float32"] * row["dx_max_abs"]
                    and row["context_dx_max_abs"] > 0):
                failures.append(f"{row}")
            if name.endswith("of_2"):
                split_sums, split_cm = split_sums + sums, split_cm + cm
        split = {"labels": layout, "sums_max_rel_err": ((split_sums - whole_sums).abs()
                                                        / whole_sums.abs()).max().item(),
                 "cm_differing": int((split_cm - whole_cm).abs().sum())}
        rows.append(split)
        if not (split["sums_max_rel_err"] <= TAIL_SUM_REL and split["cm_differing"] == 0):
            failures.append(f"two windows against the whole map: {split}")
    result = {"logits": [B, h, h, C], "rows": rows, "s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"spatial_tail_windows": result}))
    if failures:
        raise SystemExit("spatial: T1/T2 on a row window: " + "; ".join(failures))
    return result


def run_spatial(kernels, card: str) -> dict:
    """``mesh_space`` 2: two ranks as a (1 data × 2 space) grid
    (:func:`ddp_layout`: NCCL over two cards, else gloo with both on the
    one card) against one process on the same card from the same weights
    (seed 1024) and batches, nhwc, float32, TF32 off.  The flagship at
    1024² × 4: 3 ``train_step()``s (each loss; the first step's gradients
    and each parameter's update, beside one process taking the batch rows
    reversed),
    ``segment()`` (labels where one process's top two logits are clearly
    apart), an eval step (the confusion matrix's pixels).  Xception at
    1024² × 2: one step and one ``segment()`` under nhwc and under bhcw
    (K6/K7 on every rank).  Per rank and per one process: peak memory,
    device time of a step and a call, exchanges and bytes a step, K1–K7's
    launches.  Returns the paths ``spatial_train``, ``spatial_segment``
    and ``spatial_xception_bhcw`` (rank 0's launches)."""
    import tempfile

    import torch

    from deeplabv3plus_keras_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    check_spatial_windows(card)
    check_tail_windows(card)
    layout = ddp_layout()
    deterministic = torch.backends.cudnn.deterministic
    ddp_numerics()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launch.spawn(_spatial_rank, 2, (tmp,), devices=layout["devices"],
                     backend=layout["backend"], timeout_s=600, group_timeout_s=180)
        ranks = [torch.load(os.path.join(tmp, f"spatial_r{r}.pt")) for r in (0, 1)]
    t_ranks = time.perf_counter() - t0
    device = torch.device("cuda")
    with dw_layout("nhwc"):
        one = spatial_flagship(device, 1, margins=True)
        reversed_rows = spatial_run(spatial_conf(flagship_conf(SPATIAL_SIZE, SPATIAL_BATCH), 1),
                                    device, SPATIAL_STEPS, "flagship_reversed", False, False,
                                    reverse=True)
    for lay in ("nhwc", "bhcw"):
        with dw_layout(lay):
            one[f"xception_{lay}"] = spatial_run(
                spatial_conf(xception_conf(SPATIAL_SIZE, SPATIAL_XCEPTION_BATCH), 1), device, 1,
                f"xception_{lay}", False, False)
    with dw_layout("nhwc"):
        one.update(spatial_others(device, 1, margins=True))
        for name in SPATIAL_BACKBONES:
            one[f"{name}_reversed"] = spatial_run(
                spatial_conf(backbone_conf(name)(SPATIAL_SIZE, SPATIAL_BACKBONE_BATCH), 1), device,
                SPATIAL_BACKBONE_STEPS, f"{name}_reversed", False, False, reverse=True)
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic

    failures = []
    f1, fr = one["flagship"], [r["flagship"] for r in ranks]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(fr[0]["losses"], f1["losses"])]
    def grad_rel(run) -> float:
        diff = sum((run["grads1"][n] - g).double().square().sum() for n, g in f1["grads1"].items())
        return math.sqrt(diff / sum(g.double().square().sum() for g in f1["grads1"].values()))

    grads = {"ranks": grad_rel(fr[0]), "reversed_rows": grad_rel(reversed_rows)}
    grad_bound = max(1e-5, DDP_SPREAD * grads["reversed_rows"])
    ranks_rel, spread_rel = _update_rel(fr[0], f1), _update_rel(reversed_rows, f1)
    update_bound = {n: max(SPATIAL_UPDATE_REL, DDP_SPREAD * spread_rel[n]) for n in ranks_rel}
    worst_updates = sorted(((n, v, spread_rel[n]) for n, v in ranks_rel.items()),
                           key=lambda t: -t[1])[:6]
    over = [n for n, v in ranks_rel.items() if v > update_bound[n]]
    past_1e2 = [n for n, v in ranks_rel.items() if v > SPATIAL_UPDATE_REL]
    clear = f1["clear"]
    label_diff = [int(((r["labels"] != f1["labels"]) & clear).sum()) for r in fr]
    pixels = SPATIAL_BATCH * SPATIAL_SIZE * SPATIAL_SIZE
    cm_pixels = [int(r["eval"]["cm"].sum()) for r in fr] + [int(f1["eval"]["cm"].sum())]
    # each step's matrix: the rows-reversed run's distance the yardstick
    cm_spread = [_cm_l1(a, b) for a, b in zip(reversed_rows["cms"], f1["cms"])]
    cm_steps = [[_cm_l1(a, b) for a, b in zip(r["cms"], f1["cms"])] for r in fr]
    cm_step_bound = [_cm_bound(b, d) for b, d in zip(f1["cms"], cm_spread)]
    cm_eval = [_cm_l1(r["eval"]["cm"], f1["eval"]["cm"]) for r in fr]
    names = ("upsample_argmax", "depthwise_fwd_s1", "depthwise_fwd_s2", "depthwise_bwd_s1",
             "depthwise_bwd_s2", "depthwise_fwd_cf", "depthwise_bwd_cf")

    def brief(run) -> dict:
        return {"peak_gib": run["peak_gib"], "step_peak_gib": run["step_peak_gib"],
                "step_device_ms": run["step_device_ms"],
                "segment_device_ms": run["segment_device_ms"], "step_s": run["step_s"],
                "exchanges_per_step": run["exchanges"][-1],
                "segment_exchanges": run["segment_exchanges"],
                "launches_per_step": {k: run["launches"][-1][k] for k in names},
                "segment_launches": {k: run["segment_launches"][k] for k in names}}

    result = {
        **{k: layout[k] for k in ("backend", "cards", "world")}, "grid": [1, 2],
        "note": ("two ranks on one card: a correctness check, not a speed" if layout["cards"] < 2
                 else "a card a rank"),
        "flagship": {"batch": SPATIAL_BATCH, "image": SPATIAL_SIZE, "loss_rel": loss_rel,
                     "loss_bound": SPATIAL_LOSS_REL,
                     "first_step_grad_rel_2norm": grads, "grad_bound": grad_bound,
                     "update_rel_2norm_worst_and_reversed_rows": worst_updates,
                     "updates_past_1e-2": len(past_1e2),
                     "updates_past_1e-2_reversed_rows_too": sum(
                         spread_rel[n] > SPATIAL_UPDATE_REL for n in past_1e2),
                     "parameters": len(ranks_rel), "updates_over_bound": over,
                     "reversed_rows_loss_rel": [abs(a - b) / abs(b) for a, b in zip(
                         reversed_rows["losses"], f1["losses"])],
                     "labels_differing_where_clear": label_diff,
                     "clear_pixels": int(clear.sum()), "pixels": pixels,
                     "eval_cm_pixels": cm_pixels,
                     "step_cm_l1_from_one_process": cm_steps,
                     "step_cm_l1_reversed_rows": cm_spread, "step_cm_l1_bound": cm_step_bound,
                     "eval_cm_l1_from_one_process": cm_eval,
                     "eval_loss_rel": abs(fr[0]["eval"]["loss"] - f1["eval"]["loss"])
                     / abs(f1["eval"]["loss"]),
                     "ranks": [brief(r) for r in fr], "one_process": brief(f1)},
        "s_ranks": t_ranks, "s": time.perf_counter() - t0, "card": card}
    for lay in ("nhwc", "bhcw"):
        xr, x1 = [r[f"xception_{lay}"] for r in ranks], one[f"xception_{lay}"]
        result[f"xception_{lay}"] = {
            "batch": SPATIAL_XCEPTION_BATCH, "image": SPATIAL_SIZE,
            "loss_rel": abs(xr[0]["losses"][0] - x1["losses"][0]) / abs(x1["losses"][0]),
            "labels_equal_across_ranks": bool(torch.equal(xr[0]["labels"], xr[1]["labels"])),
            "ranks": [brief(r) for r in xr], "one_process": brief(x1)}
        if not result[f"xception_{lay}"]["loss_rel"] <= SPATIAL_LOSS_REL:
            failures.append(f"xception {lay} step loss {result[f'xception_{lay}']['loss_rel']}")
        key = ("depthwise_fwd_cf", "depthwise_bwd_cf") if lay == "bhcw" else (
            "depthwise_fwd_s1", "depthwise_bwd_s1")
        if not all(r["launches"][0][k] > 0 for r in xr for k in key):
            failures.append(f"xception {lay}: {key} not launched on every rank")
        if tuple(xr[0]["labels"].shape) != (SPATIAL_XCEPTION_BATCH, SPATIAL_SIZE, SPATIAL_SIZE):
            failures.append(f"xception {lay} labels {tuple(xr[0]['labels'].shape)}")
    print(json.dumps({"spatial": result}))

    if not all(d <= SPATIAL_LOSS_REL for d in loss_rel):
        failures.append(f"flagship step losses {loss_rel}")
    if over:
        failures.append(f"flagship updates past their bounds: {over} (worst {worst_updates})")
    if not grads["ranks"] <= grad_bound:
        failures.append(f"flagship first-step gradients {grads} > {grad_bound}")
    if any(label_diff):
        failures.append(f"segment() labels differ at {label_diff} clear pixels")
    if cm_pixels != [pixels] * 3:
        failures.append(f"eval confusion matrices hold {cm_pixels} pixels, not {pixels}")
    if any(d > b for r in cm_steps for d, b in zip(r, cm_step_bound)):
        failures.append(f"flagship step matrices {cm_steps} from one process's > {cm_step_bound}")
    if not all(d <= _cm_bound(f1["eval"]["cm"]) for d in cm_eval):
        failures.append(f"flagship eval matrices {cm_eval} from one process's")
    for r in fr:
        if not all(r["launches"][-1][k] > 0 for k in names[1:5]):
            failures.append(f"K2-K5 not all launched on a rank's step: {r['launches'][-1]}")
        if not all(r["segment_launches"][k] > 0 for k in names[:3]):
            failures.append(f"K1-K3 not all launched on a rank's segment(): {r['segment_launches']}")
        if r["launches"][-1] != f1["launches"][-1]:
            failures.append(f"a rank's launches {r['launches'][-1]} against one process's "
                            f"{f1['launches'][-1]}")
        if not r["exchanges"][-1]["exchanges"]:
            failures.append("no halo exchange in a rank's step")
    if not all(torch.equal(fr[0]["updates"][n], fr[1]["updates"][n]) for n in fr[0]["updates"]):
        failures.append("the ranks' updates differ")
    result["options"] = spatial_options_checks(ranks, one, f1, spread_rel, cm_spread, failures)
    print(json.dumps({"spatial_options": result["options"], "card": card}))
    result["backbones"] = spatial_backbone_checks(ranks, one, failures)
    print(json.dumps({"spatial_backbones": result["backbones"], "card": card}))
    result["int8"] = spatial_int8_checks(ranks, one, failures)
    print(json.dumps({"spatial_int8": result["int8"], "card": card}))
    print(json.dumps({"spatial_peak_allocations": {
        "step": f"flagship train_step() 2 of {SPATIAL_STEPS}, {SPATIAL_BATCH} x {SPATIAL_SIZE}^2, "
                "integer labels, float32",
        **{f"{who}_fused_tail_{name == 'fused_tail'}".lower(): run[name]["peak_allocations"]
           for who, run in (("one_process", one), ("rank0", ranks[0]), ("rank1", ranks[1]))
           for name in ("flagship", "fused_tail")}}, "card": card}))
    if failures:
        raise SystemExit("spatial: " + "; ".join(failures))
    x0, r0 = ranks[0]["xception_bhcw"], ranks[0]
    return {"spatial_train": fr[0]["launches"][-1], "spatial_segment": fr[0]["segment_launches"],
            "spatial_xception_bhcw": {k: x0["launches"][0][k] + x0["segment_launches"][k]
                                      for k in x0["launches"][0]},
            **{f"spatial_{name}": r0[name]["launches"][-1] for name in SPATIAL_OPTIONS},
            "spatial_tta_eval": r0["tta"]["launches"],
            "spatial_nonsquare_segment": r0["nonsquare"]["launches"],
            **{f"spatial_{n}_train": r0[n]["launches"][-1] for n in SPATIAL_BACKBONES},
            **{f"spatial_{n}_segment": r0[n]["segment_launches"] for n in SPATIAL_BACKBONES},
            **{f"spatial_int8_{n}_segment": r0[f"int8_{n}"]["launches"] for n in SPATIAL_INT8}}


def _update_rel(run: dict, ref: dict) -> dict:
    """Each parameter's update after the steps against ``ref``'s, in
    relative 2-norm (0 where both are zero, inf where only ``run``'s
    moved)."""
    out = {}
    for n, u in ref["updates"].items():
        norm = u.double().norm().item()
        out[n] = (run["updates"][n] - u).double().norm().item() / norm if norm else (
            0.0 if not run["updates"][n].any() else math.inf)
    return out


# K1-K5's names in the launch counts
K1_K5 = ("upsample_argmax", "depthwise_fwd_s1", "depthwise_fwd_s2", "depthwise_bwd_s1",
         "depthwise_bwd_s2")


def spatial_backbone_checks(ranks: list, one: dict, failures: list) -> dict:
    """:data:`SPATIAL_BACKBONES` on two ranks against one process, as the
    flagship's plain run is held: each step's loss to ``SPATIAL_LOSS_REL``;
    each parameter's update to max(``SPATIAL_UPDATE_REL``, ``DDP_SPREAD`` ×
    one process's rows-reversed distance); each step's matrix to
    :func:`_cm_bound` of that run's distance; ``segment()``'s labels equal
    where one process's top two logits are clear; the ranks' updates
    equal; K2/K4 (and K3/K5 where the backbone has stride-2 depthwise
    sites) launched on every rank's step as often as in one process, K1
    and K2 in every rank's ``segment()``.  Appends to ``failures``;
    returns the summary."""
    import torch

    out = {}
    for name in SPATIAL_BACKBONES:
        rs, o, rev = [r[name] for r in ranks], one[name], one[f"{name}_reversed"]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"], o["losses"])]
        spread, rel = _update_rel(rev, o), _update_rel(rs[0], o)
        over = [n for n, v in rel.items() if v > max(SPATIAL_UPDATE_REL, DDP_SPREAD * spread[n])]
        cm_spread = [_cm_l1(a, b) for a, b in zip(rev["cms"], o["cms"])]
        cm_dist = [[_cm_l1(a, b) for a, b in zip(r["cms"], o["cms"])] for r in rs]
        cm_bound = [_cm_bound(b, d) for b, d in zip(o["cms"], cm_spread)]
        label_diff = [int(((r["labels"] != o["labels"]) & o["clear"]).sum()) for r in rs]
        strided = o["launches"][-1]["depthwise_fwd_s2"] > 0
        need = K1_K5[1:] if strided else ("depthwise_fwd_s1", "depthwise_bwd_s1")
        out[name] = {
            "batch": SPATIAL_BACKBONE_BATCH, "image": SPATIAL_SIZE, "loss_rel": loss_rel,
            "reversed_rows_loss_rel": [abs(a - b) / abs(b) for a, b in zip(rev["losses"],
                                                                           o["losses"])],
            "update_rel_2norm_worst_and_reversed_rows": sorted(
                ((n, v, spread[n]) for n, v in rel.items()), key=lambda t: -t[1])[:4],
            "updates_over_bound": over, "parameters": len(rel),
            "step_cm_l1_from_one_process": cm_dist, "step_cm_l1_reversed_rows": cm_spread,
            "step_cm_l1_bound": cm_bound, "labels_differing_where_clear": label_diff,
            "clear_pixels": int(o["clear"].sum()), "pixels": o["labels"].numel(),
            "step_peak_gib": [r["step_peak_gib"] for r in rs],
            "one_process_step_peak_gib": o["step_peak_gib"],
            "step_device_ms": [r["step_device_ms"] for r in rs],
            "one_process_step_device_ms": o["step_device_ms"],
            "segment_device_ms": [r["segment_device_ms"] for r in rs],
            "one_process_segment_device_ms": o["segment_device_ms"],
            "exchanges_per_step": rs[0]["exchanges"][-1],
            "segment_exchanges": rs[0]["segment_exchanges"],
            "launches_per_step": {k: rs[0]["launches"][-1][k] for k in K1_K5},
            "segment_launches": {k: rs[0]["segment_launches"][k] for k in K1_K5}}
        if not all(d <= SPATIAL_LOSS_REL for d in loss_rel):
            failures.append(f"{name} step losses {loss_rel}")
        if over:
            failures.append(f"{name} updates past their bounds: {over}")
        if any(d > b for r in cm_dist for d, b in zip(r, cm_bound)):
            failures.append(f"{name} step matrices {cm_dist} from one process's > {cm_bound}")
        if any(label_diff) or tuple(rs[0]["labels"].shape) != tuple(o["labels"].shape):
            failures.append(f"{name} segment() labels differ at {label_diff} clear pixels")
        if not all(torch.equal(rs[0]["updates"][n], rs[1]["updates"][n]) for n in rel):
            failures.append(f"{name}: the ranks' updates differ")
        for r in rs:
            if not all(r["launches"][-1][k] > 0 for k in need) or (
                    r["launches"][-1] != o["launches"][-1]):
                failures.append(f"{name}: a rank's step launches {r['launches'][-1]} (one "
                                f"process {o['launches'][-1]}; {need} needed)")
            if not all(r["segment_launches"][k] > 0 for k in K1_K5[:2]):
                failures.append(f"{name}: K1/K2 not launched in a rank's segment(): "
                                f"{r['segment_launches']}")
            if not r["exchanges"][-1]["exchanges"]:
                failures.append(f"{name}: no halo exchange in a rank's step")
    return out


def spatial_int8_checks(ranks: list, one: dict, failures: list) -> dict:
    """int8 ``segment()`` of :data:`SPATIAL_INT8` on two ranks against one
    process: the same sites ran int8 as often, by name; the ranges to
    ``SPATIAL_INT8_RANGE_REL``; the labels equal where one process's int8
    margin is clear (``SPATIAL_INT8_MARGIN_REL``) and differing at no more
    than ``SPATIAL_INT8_LABEL_SHARE`` of the pixels; K1 and K2 launched
    on every rank as often as in one process.  Appends to ``failures``;
    returns the summary."""
    out = {}
    for name in SPATIAL_INT8:
        rs, o = [r[f"int8_{name}"] for r in ranks], one[f"int8_{name}"]
        pixels = o["labels"].numel()
        range_rel = max(abs(r["ranges"][k] - v) / v for r in rs for k, v in o["ranges"].items()
                        if k in r["ranges"])
        out[name] = {
            "batch": SPATIAL_BACKBONE_BATCH, "image": SPATIAL_SIZE, "sites": len(o["sites"]),
            "int8_convs": [r["int8_convs"] for r in rs], "one_process_int8_convs": o["int8_convs"],
            "sites_equal": [r["sites"] == o["sites"] and sorted(r["ranges"]) == sorted(o["ranges"])
                            for r in rs],
            "range_rel_worst": range_rel, "range_bound": SPATIAL_INT8_RANGE_REL,
            "labels_differing_where_clear": [int(((r["labels"] != o["labels"]) & o["clear"]).sum())
                                             for r in rs],
            "labels_differing": [int((r["labels"] != o["labels"]).sum()) for r in rs],
            "clear_pixels": int(o["clear"].sum()), "pixels": pixels,
            "exchanges": rs[0]["exchanges"],
            "launches": {k: rs[0]["launches"][k] for k in K1_K5},
            "one_process_launches": {k: o["launches"][k] for k in K1_K5}}
        e = out[name]
        if not (o["sites"] and all(e["sites_equal"]) and range_rel <= SPATIAL_INT8_RANGE_REL):
            failures.append(f"int8 {name}: sites or ranges differ from one process's: {e}")
        if any(e["labels_differing_where_clear"]) or max(e["labels_differing"]) > (
                SPATIAL_INT8_LABEL_SHARE * pixels):
            failures.append(f"int8 {name} labels: {e['labels_differing_where_clear']} clear, "
                            f"{e['labels_differing']} of {pixels} in all")
        for r in rs:
            if not all(r["launches"][k] > 0 for k in K1_K5[:2]) or r["launches"] != o["launches"]:
                failures.append(f"int8 {name}: a rank's segment() launches {r['launches']} "
                                f"(one process {o['launches']})")
    return out


def spatial_options_checks(ranks: list, one: dict, f1: dict, spread_rel: dict,
                           cm_spread: list, failures: list) -> dict:
    """The step options, test-time augmentation and the non-square
    ``segment()`` of the two ranks against one process: each step's loss
    to ``SPATIAL_LOSS_REL``; each parameter's update to
    max(``SPATIAL_UPDATE_REL``, ``DDP_SPREAD`` × the plain flagship's
    rows-reversed distance); each step's matrix to :func:`_cm_bound` of
    that step's rows-reversed distance (``cm_spread``); the ranks' updates
    equal; the kernels of each
    option launched on every rank (T1/T2 a step under ``fused_tail``, K2/K3
    again in ``remat``'s recompute); the eval step's loss and its matrix's
    pixels, its matrix to ``SPATIAL_CM_MOVED``; the labels where one
    process's top two logits are clear.
    Per rank: peak memory beside the plain flagship's, exchanges and
    launches a step.  Appends to ``failures``; returns the summary."""
    import torch

    out = {}
    plain = [r["flagship"] for r in ranks]
    for name in SPATIAL_OPTIONS:
        rs, o = [r[name] for r in ranks], one[name]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"], o["losses"])]
        cm_dist = [[_cm_l1(a, b) for a, b in zip(r["cms"], o["cms"])] for r in rs]
        cm_bound = [_cm_bound(b, d) for b, d in zip(o["cms"], cm_spread)]
        rel = _update_rel(rs[0], o)
        over = [n for n, v in rel.items() if v > max(SPATIAL_UPDATE_REL, DDP_SPREAD * spread_rel[n])]
        last = [r["launches"][-1] for r in rs]
        out[name] = {
            "loss_rel": loss_rel, "losses": rs[0]["losses"],
            "step_cm_l1_from_one_process": cm_dist, "step_cm_l1_bound": cm_bound,
            "update_rel_2norm_worst": sorted(rel.items(), key=lambda t: -t[1])[:4],
            "updates_over_bound": over,
            "step_peak_gib": [r["step_peak_gib"] for r in rs],
            "step_peak_gib_plain": [r["step_peak_gib"] for r in plain],
            "one_process_step_peak_gib": o["step_peak_gib"],
            "one_process_step_peak_gib_plain": f1["step_peak_gib"],
            "exchanges_per_step": rs[0]["exchanges"][-1],
            "exchanges_per_step_plain": plain[0]["exchanges"][-1],
            "launches_per_step": last[0], "one_process_launches_per_step": o["launches"][-1]}
        if not all(d <= SPATIAL_LOSS_REL for d in loss_rel):
            failures.append(f"{name} step losses {loss_rel}")
        if any(d > b for r in cm_dist for d, b in zip(r, cm_bound)):
            failures.append(f"{name} step matrices {cm_dist} from one process's > {cm_bound}")
        if over:
            failures.append(f"{name} updates past their bounds: {over}")
        if not all(torch.equal(rs[0]["updates"][n], rs[1]["updates"][n]) for n in rel):
            failures.append(f"{name}: the ranks' updates differ")
        need = ["depthwise_fwd_s1", "depthwise_fwd_s2", "depthwise_bwd_s1", "depthwise_bwd_s2"]
        if name == "fused_tail":
            need += ["parity_tail_fwd", "parity_tail_bwd"]
        for r, p in zip(last, (q["launches"][-1] for q in plain)):
            if not all(r[k] > 0 for k in need):
                failures.append(f"{name}: {need} not all launched on a rank's step: {r}")
            if name == "remat" and not r["depthwise_fwd_s1"] > p["depthwise_fwd_s1"]:
                failures.append(f"remat: K2 not launched again in the recompute: {r} vs {p}")
    tr, t1 = [r["tta"] for r in ranks], one["tta"]
    pixels = SPATIAL_BATCH * SPATIAL_SIZE * SPATIAL_SIZE
    out["tta_eval"] = {
        "scales": SPATIAL_TTA["eval_scales"], "flip": SPATIAL_TTA["eval_flip"],
        "loss_rel": abs(tr[0]["loss"] - t1["loss"]) / abs(t1["loss"]),
        "cm_pixels": [int(r["cm"].sum()) for r in tr] + [int(t1["cm"].sum())],
        "cm_l1_from_one_process": [_cm_l1(r["cm"], t1["cm"]) for r in tr],
        "cm_l1_bound": _cm_bound(t1["cm"]),
        "peak_gib": [r["peak_gib"] for r in tr], "one_process_peak_gib": t1["peak_gib"],
        "exchanges": tr[0]["exchanges"], "launches": tr[0]["launches"]}
    if not out["tta_eval"]["loss_rel"] <= SPATIAL_LOSS_REL:
        failures.append(f"TTA eval loss {out['tta_eval']['loss_rel']}")
    if not all(d <= out["tta_eval"]["cm_l1_bound"]
               for d in out["tta_eval"]["cm_l1_from_one_process"]):
        failures.append(f"TTA eval matrices {out['tta_eval']['cm_l1_from_one_process']} "
                        "from one process's")
    if out["tta_eval"]["cm_pixels"] != [pixels] * 3:
        failures.append(f"TTA eval matrices hold {out['tta_eval']['cm_pixels']} pixels")
    if not all(r["launches"][k] > 0 for r in tr for k in ("depthwise_fwd_s1", "depthwise_fwd_s2")):
        failures.append("TTA eval: K2/K3 not launched on every rank")
    nr, n1 = [r["nonsquare"] for r in ranks], one["nonsquare"]
    shape = (SPATIAL_BATCH, *SPATIAL_NONSQUARE)
    out["nonsquare_segment"] = {
        "shape": list(shape), "clear_pixels": int(n1["clear"].sum()),
        "labels_differing_where_clear": [int(((r["labels"] != n1["labels"]) & n1["clear"]).sum())
                                         for r in nr],
        "exchanges": nr[0]["exchanges"], "launches": nr[0]["launches"]}
    if any(tuple(r["labels"].shape) != shape for r in nr) or any(
            out["nonsquare_segment"]["labels_differing_where_clear"]):
        failures.append(f"non-square segment(): {out['nonsquare_segment']}")
    if not all(r["launches"][k] > 0 for r in nr
               for k in ("upsample_argmax", "depthwise_fwd_s1", "depthwise_fwd_s2")):
        failures.append("non-square segment(): K1-K3 not launched on every rank")
    return out


# ---------------------------------------------------------------------------
# fused_tail: the parity-decomposed training tail, T1/T2

# The operations T1 and T2 need per full-resolution pixel and class, each
# transcendental counted as one: the parity lerp (3 blends of 2 products
# and a sum: 9), the softmax (subtract, exp, sum, divide: 4), the loss
# (two shifted logs, two products, a sum: 7); T2 the lerp and softmax, the
# slope a (two divisions, 4 products and sums: 6), the dot product and
# p·(a − dot)·scale (5) and the transposed lerp's share (8 products and sums)
TAIL_FWD_OPS, TAIL_BWD_OPS = 20, 32
# T1's per-sample sums and T2's dlogits against the plain version on the
# same float32 values (the kernels compute in float32): sums over pixels and
# classes in another order, 1e-5 relative; dlogits to 1e-5 of their largest,
# 2^-7 in bfloat16 (the rounding of the result); the matrix exactly (the
# parity values are the plain version's lerps, rounded alike)
TAIL_SUM_REL = 1e-5
TAIL_DX_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# bfloat16 logits: the kernels (float32 arithmetic) against the plain
# version in bfloat16 (JAX's roundings), the bound of
# tests/test_torch_parity_tail.py
TAIL_BF16_PLAIN_REL = 1e-2
# fused against unfused steps from the same weights: the step-1 loss to
# 2e-6 relative (the JAX package's bound, tests/test_parity_tail.py); the
# first step's gradients to 1e-4 in relative 2-norm (the forward is the
# same to the bit, so no ReLU mask moves: only dlogits' float32 rounding,
# carried back); the confusion matrix to max(8, pixels/4096) differing
# pixels (the unfused matrix argmaxes the full-resolution probabilities of
# the matmul-form upsample, the fused one the parity lerps: a class pair
# within one rounding may swap); in bfloat16 the loss to 1e-2 (the
# unfused tail upsamples and softmaxes in bfloat16, the fused one in
# float32) and the matrix to 1 % of the pixels
TAIL_STEP_LOSS_REL, TAIL_STEP_GRAD_REL, TAIL_BF16_LOSS_REL = 2e-6, 1e-4, 1e-2
TAIL_STEPS = 6
# the instantiation sweep: every class bound of csrc/parity_tail.cu (8, 16,
# 24 at the flagship's 21, 32) and the multi-pass kernels past it (33; 150,
# ADE20K's classes, its matrix in device memory), at (4, 64², C) logits of
# scale 2 (the on-card tests'); dlogits held against the plain version in
# float64 on the same values with TAIL_DX_REL: float32 evaluations of this
# gradient spread by ~1e-5 of its largest where a pixel's p of a wrong class
# nears 1 (1 − p + ε rounds at 2⁻²⁴/(1 − p) relative), so the float32 plain
# version is reported beside it, not held to it
TAIL_CLASSES = (8, 16, 32, 33, 150)
# --parity-tail also times T1/T2 against C at the flagship's map
# (16 × 256² logits): the slope is the per-class cost, the intercept the
# per-pixel one
TAIL_BY_C = (8, 16, 21, 32)
# what ptxas made of each csrc/*.cu (main() fills it beside the build)
PTXAS: dict[str, list] = {}


def event_ms(fn, reps: int = 5) -> float:
    """Device time of one call of ``fn`` between CUDA events over ``reps``
    calls, after a warm-up (no graph: autograd runs its own backward)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def parity_tail_instantiations(card: str) -> list:
    """Print the registers and spills ptxas gave each T1/T2 instantiation,
    beside the class counts the plan sends to it.  Returns the failures (a
    spill, or no report), which the caller raises after its checks."""
    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt

    rows = [r for r in PTXAS.get("parity_tail", []) if "tail_" in r["kernel"]]
    bounds = getattr(pt, "_CLASS_BOUNDS", ())
    classes = {f"C<={k}": k for k in bounds}
    classes[f"C>{bounds[-1]}" if bounds else "any C"] = 0
    print(json.dumps({"parity_tail_instantiations": rows, "cmax_by_classes": classes, "card": card}))
    spilled = [r["kernel"] for r in rows if r.get("spill_stores") or r.get("spill_loads")]
    return [f"ptxas: spills in {spilled}"] if spilled else [] if rows else ["ptxas: no report"]


def check_parity_tail_classes(card: str) -> dict:
    """T1 and T2 at (4, 64, 64, C) logits for every C of ``TAIL_CLASSES``
    (each instantiation the plan can pick), float32 and bfloat16 logits,
    one-hot labels in the logits' dtype and integer labels, one padded
    sample: the sums and matrix against the plain version on the same
    float32 values with the flagship rows' bounds, dlogits against it in
    float64 (and reported against it in float32), twice for bit equality,
    and timed.  Prints the ``parity_tail_classes`` line; fails on a miss."""
    import dataclasses

    import torch

    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt

    t0 = time.perf_counter()
    B, h = 4, 64
    rows, failures = {}, []
    for C in TAIL_CLASSES:
        g = torch.Generator(device="cuda").manual_seed(C)
        x32 = torch.randn(B, h, h, C, device="cuda", generator=g) * 2
        ids = torch.randint(0, C, (B, 2 * h, 2 * h), device="cuda", generator=g)
        pw = torch.linspace(0.3, 0.99, C).numpy()
        nw = 1.0 - pw
        valid = torch.ones(B, dtype=torch.int32, device="cuda")
        valid[-1] = 0
        scale = torch.rand(B, device="cuda", generator=g) * valid
        plan = pt._parity_tail_plan(B, h, h, C)
        for dtype in ("float32", "bfloat16"):
            x = x32.to(getattr(torch, dtype))
            for layout in ("one_hot", "integer"):
                lab = torch.nn.functional.one_hot(ids, C).to(x.dtype) if layout == "one_hot" else ids
                runs = [(*pt.parity_tail_forward(x, lab, pw, nw, valid),
                         pt.parity_tail_backward(x, lab, pw, nw, scale)) for _ in range(2)]
                sums, cm, dx = runs[0]
                bits = all(torch.equal(a, b) for a, b in zip(*runs))
                ref_lab = lab.float() if layout == "one_hot" else lab
                ref_sums, ref_cm = pt.parity_tail_forward_plain(x.float(), ref_lab, pw, nw, valid)
                ref_dx = pt.parity_tail_backward_plain(x.double(), ref_lab, pw, nw, scale.double())
                dx32 = pt.parity_tail_backward_plain(x.float(), ref_lab, pw, nw, scale)
                row = {"sums_max_rel_err": ((sums - ref_sums).abs() / ref_sums.abs()).max().item(),
                       "cm_differing": int((cm - ref_cm).abs().sum()),
                       "dx_max_abs_err": (dx.double() - ref_dx).abs().max().item(),
                       "dx_max_abs_err_vs_plain_float32": (dx.float() - dx32).abs().max().item(),
                       "dx_max_abs": ref_dx.abs().max().item(), "bit_equal_runs": bits,
                       "fwd_ms": cuda_ms(lambda: pt.parity_tail_forward(x, lab, pw, nw, valid)),
                       "bwd_ms": cuda_ms(lambda: pt.parity_tail_backward(x, lab, pw, nw, scale))}
                if not (row["sums_max_rel_err"] <= TAIL_SUM_REL and row["cm_differing"] == 0
                        and row["dx_max_abs_err"] <= TAIL_DX_REL[dtype] * row["dx_max_abs"] and bits
                        and int(cm.sum()) == (B - 1) * 4 * h * h):
                    failures.append(f"C={C} {dtype} {layout}: {row}")
                rows[f"C{C}_{dtype}_{layout}"] = row
        rows[f"C{C}_plan"] = dataclasses.asdict(plan)
    print(json.dumps({"parity_tail_classes": {"logits": [B, h, h, "C"], "rows": rows,
                                              "s": time.perf_counter() - t0, "card": card}}))
    if failures:
        raise SystemExit("parity_tail instantiations: " + "; ".join(failures))
    return rows


def time_parity_tail_by_c(card: str) -> dict:
    """T1/T2 device time at the flagship's map (16 × 256² logits, 512²
    labels, float32) for every C of ``TAIL_BY_C``, integer and one-hot
    float32 labels: the ``parity_tail_by_c`` line."""
    import torch

    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt

    out = {}
    for C in TAIL_BY_C:
        g = torch.Generator(device="cuda").manual_seed(C)
        x = torch.randn(BATCH, SIZE // 2, SIZE // 2, C, device="cuda", generator=g) * 3
        ids = torch.randint(0, C, (BATCH, SIZE, SIZE), device="cuda", generator=g)
        pw = torch.linspace(0.3, 0.99, C).numpy()
        valid = torch.ones(BATCH, dtype=torch.int32, device="cuda")
        scale = valid.float() / (BATCH * SIZE * SIZE)
        for layout in ("integer", "one_hot"):
            lab = ids if layout == "integer" else torch.nn.functional.one_hot(ids, C).float()
            out[f"C{C}_{layout}"] = {
                "fwd_ms": cuda_ms(lambda: pt.parity_tail_forward(x, lab, pw, 1 - pw, valid)),
                "bwd_ms": cuda_ms(lambda: pt.parity_tail_backward(x, lab, pw, 1 - pw, scale))}
            del lab
        del x, ids
        torch.cuda.empty_cache()
    print(json.dumps({"parity_tail_by_c": out, "logits": [BATCH, SIZE // 2, SIZE // 2, "C"], "card": card}))
    return out


def check_parity_tail(card: str) -> dict:
    """T1 and T2 at the flagship's tail, logits (16, 256, 256, 21) and labels
    at 512², one padded sample, in float32 and bfloat16, one-hot (float32)
    and integer labels: against the plain version on the same float32
    values (sums, matrix, dlogits), twice for bit equality, and timed beside
    the plain version, the unfused tail (``tf_resize_images_matmul`` (or
    ``tf_resize_images`` in bfloat16) + ``softmax`` + ``class_balanced_loss``
    forward and backward, what the step runs without the key) and the
    bound.  Returns the ``kernels`` line's rows."""
    import torch

    from deeplabv3plus_keras_tpu_torch.kernels import parity_tail as pt
    from deeplabv3plus_keras_tpu_torch.models.decoder import softmax
    from deeplabv3plus_keras_tpu_torch.ops.resize import tf_resize_images, tf_resize_images_matmul
    from deeplabv3plus_keras_tpu_torch.train.loss import (SS_NW, SS_PW, class_balanced_loss,
                                                          class_balanced_loss_sparse)

    ptxas_failures = parity_tail_instantiations(card)
    check_parity_tail_classes(card)
    t0 = time.perf_counter()
    B, h, C = BATCH, SIZE // 2, CLASSES
    g = torch.Generator(device="cuda").manual_seed(11)
    x32 = torch.randn(B, h, h, C, device="cuda", generator=g) * 3
    ids = torch.randint(0, C, (B, SIZE, SIZE), device="cuda", generator=g)
    valid = torch.ones(B, dtype=torch.int32, device="cuda")
    valid[-1] = 0
    denom = float(valid.sum()) * SIZE * SIZE
    scale = valid.float() / denom  # what autograd hands T2 for the mean loss
    layouts = {"one_hot": torch.nn.functional.one_hot(ids, C).float(), "integer": ids}
    rows, failures = {}, []
    for dtype in ("float32", "bfloat16"):
        x = x32.to(getattr(torch, dtype))
        for layout, lab in layouts.items():
            sums, cm = pt.parity_tail_forward(x, lab, SS_PW, SS_NW, valid)
            dx = pt.parity_tail_backward(x, lab, SS_PW, SS_NW, scale)
            again = (*pt.parity_tail_forward(x, lab, SS_PW, SS_NW, valid),
                     pt.parity_tail_backward(x, lab, SS_PW, SS_NW, scale))
            bits = all(torch.equal(a, b) for a, b in zip((sums, cm, dx), again))
            ref_sums, ref_cm = pt.parity_tail_forward_plain(x.float(), lab, SS_PW, SS_NW, valid)
            ref_dx = pt.parity_tail_backward_plain(x.float(), lab, SS_PW, SS_NW, scale)
            loss, ref_loss = ((s * valid).sum().item() / denom for s in (sums, ref_sums))
            row = {
                "loss_max_abs_err": abs(loss - ref_loss),
                "sums_max_rel_err": ((sums - ref_sums).abs() / ref_sums.abs()).max().item(),
                "cm_differing": int((cm - ref_cm).abs().sum()),
                "dx_max_abs_err": (dx.float() - ref_dx).abs().max().item(),
                "dx_max_abs": ref_dx.abs().max().item(),
                "bit_equal_runs": bits, "cm_pixels": int(cm.sum())}
            if dtype == "bfloat16":  # the plain version in bfloat16: JAX's roundings
                p16, _ = pt.parity_tail_forward_plain(x, lab, SS_PW, SS_NW, valid)
                l16 = (p16 * valid).sum().item() / denom
                row["loss_rel_vs_plain_bfloat16"] = abs(loss - l16) / abs(l16)
                if not row["loss_rel_vs_plain_bfloat16"] <= TAIL_BF16_PLAIN_REL:
                    failures.append(f"{dtype} {layout}: loss {loss} vs plain bfloat16 {l16}")
            if not (row["sums_max_rel_err"] <= TAIL_SUM_REL and row["cm_differing"] == 0
                    and row["dx_max_abs_err"] <= TAIL_DX_REL[dtype] * row["dx_max_abs"] and bits
                    and row["cm_pixels"] == (B - 1) * SIZE * SIZE):
                failures.append(f"{dtype} {layout}: {row}")
            del ref_dx

            # times: the kernels (CUDA graphs), the plain version and the
            # unfused tail (CUDA events), on these inputs
            xr = x.detach().clone().requires_grad_(True)

            def unfused():
                nchw = xr.permute(0, 3, 1, 2)
                up = (tf_resize_images_matmul(nchw, 2, 2) if dtype == "float32"
                      else tf_resize_images(nchw, 2, 2))
                probs = softmax(up, dim=1).permute(0, 2, 3, 1).float()
                if lab.dim() == 4:
                    return class_balanced_loss(lab, probs, SS_PW, SS_NW, valid=valid)
                return class_balanced_loss_sparse(lab, probs, SS_PW, SS_NW, valid=valid)

            def unfused_both():
                xr.grad = None
                unfused().backward()

            def plain_both():
                pt.parity_tail_backward_plain(x, lab, SS_PW, SS_NW, scale)

            ms_fwd = cuda_ms(lambda: pt.parity_tail_forward(x, lab, SS_PW, SS_NW, valid))
            ms_bwd = cuda_ms(lambda: pt.parity_tail_backward(x, lab, SS_PW, SS_NW, scale))
            plain_fwd = event_ms(lambda: pt.parity_tail_forward_plain(x, lab, SS_PW, SS_NW, valid))
            plain_all = event_ms(plain_both)
            lib_fwd = event_ms(unfused)
            lib_all = event_ms(unfused_both)
            xb, lb = x.numel() * x.element_size(), lab.numel() * lab.element_size()
            pix = B * SIZE * SIZE * C
            fb, fby = bound(xb + lb + 2 * B * 4 + C * C * 4, pix * TAIL_FWD_OPS)
            bb, bby = bound(2 * xb + lb + 2 * B * 4, pix * TAIL_BWD_OPS)
            row.update(fwd={"ms": ms_fwd, "plain_ms": plain_fwd, "library_ms": lib_fwd,
                            "bound_ms": fb, "bound_by": fby},
                       bwd={"ms": ms_bwd, "plain_ms": plain_all - plain_fwd,
                            "library_ms": lib_all - lib_fwd, "bound_ms": bb, "bound_by": bby},
                       plain_fwd_bwd_ms=plain_all, unfused_fwd_bwd_ms=lib_all)
            rows[f"{dtype}_{layout}"] = row
            del xr
            torch.cuda.empty_cache()
    plan = pt._parity_tail_plan(B, h, h, C)
    print(json.dumps({"parity_tail_kernels": {
        "logits": [B, h, h, C], "labels": SIZE, "padded_samples": 1, "rows": rows,
        "plan": {k: getattr(plan, k) for k in plan.__dataclass_fields__},
        "note": ("ms: CUDA graphs of 20 calls; plain and unfused: CUDA events over 5 calls; a "
                 "backward's plain_ms and library_ms are forward + backward less the forward"),
        "s": time.perf_counter() - t0, "card": card}}))
    if failures or ptxas_failures:
        raise SystemExit("parity_tail kernels: " + "; ".join(ptxas_failures + failures))

    def entry(which: str) -> dict:
        main = rows["float32_one_hot"]
        out = {k: main[which][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        out["max_abs_err"] = main["loss_max_abs_err"] if which == "fwd" else main["dx_max_abs_err"]
        for key in ("float32_integer", "bfloat16_one_hot", "bfloat16_integer"):
            r = rows[key]
            out[key] = {**{k: r[which][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                        "max_abs_err": r["loss_max_abs_err"] if which == "fwd" else r["dx_max_abs_err"]}
        return out

    return {"parity_tail_fwd": entry("fwd"), "parity_tail_bwd": entry("bwd")}


def tail_steps(kernels, state: dict, dtype: str, fused: bool, steps: int) -> dict:
    """The flagship's probability-free ``eval_step()`` on the first batch,
    then ``steps`` ``train_step()``s at 16 × 512² from ``state``, with or
    without ``fused_tail``: the eval loss, matrix and launches; the first
    step's loss, matrix and gradients (cuDNN deterministic); then peak
    memory, step times and launches a step of the others; in float32 one
    more step profiled (``fused_tail_{on,off}_train_profile.txt`` in ``OUT``)."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    conf = flagship_conf()
    conf["hps"]["dtype"] = dtype
    conf["fused_tail"] = fused
    seg = SemanticSegmentation(conf, device="cuda")
    seg.model.load_state_dict(state)
    batches = train_batches(steps, BATCH, SIZE, "cuda", seed=5)
    batches[0]["valid"][-1] = 0  # a padded sample
    kernels.reset_launch_counts()
    ev = seg.eval_step(batches[0])
    out = {"eval": {"loss": ev["loss"].item(), "cm": ev["cm"].cpu(),
                    "launches": kernels.launch_counts()}}
    torch.backends.cudnn.deterministic = True
    first = seg.train_step(batches[0])
    torch.backends.cudnn.deterministic = False
    out["first"] = {"loss": first["loss"].item(), "cm": first["cm"].cpu(),
                    "grads": [p.grad.detach().clone() for p in seg.model.parameters()]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for batch in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = seg.train_step(batch)["loss"].item()
        times.append(time.perf_counter() - t)
        if not math.isfinite(loss):
            raise SystemExit(f"fused_tail={fused} {dtype}: loss {loss}")
    counts = kernels.launch_counts()
    out.update(step_s=times, img_per_s=BATCH / statistics.median(times),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches_per_step={k: v / len(times) for k, v in counts.items() if v},
               launches=counts)
    if dtype == "float32":  # the device time of one step, by kernel
        tag = "on" if fused else "off"
        out["profile"] = profile_device(
            lambda: seg.train_step(batches[1])["loss"].item(), OUT / f"fused_tail_{tag}_train_profile.txt",
            f"fused_tail={fused}, TF32 off, B={BATCH}, {SIZE}^2, one train_step", 40)
    del seg
    torch.cuda.empty_cache()
    return out


def _fused_ddp_rank(state_path: str, out_dir: str) -> None:
    """A rank of the fused_tail phase's check: one ``fused_tail`` step on
    its 8 rows of the ddp phase's first global batch."""
    import torch

    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    ddp_numerics()
    device = torch.device("cuda", torch.cuda.current_device())
    state = torch.load(state_path, map_location=device)
    rows = torch.as_tensor(mesh.row_indices(BATCH))
    torch.save(ddp_steps(state, device, rows, steps=1, fused_tail=True),
               os.path.join(out_dir, f"tail_r{mesh.rank()}.pt"))


def run_fused_tail(kernels, card: str, state: dict) -> tuple[dict, dict]:
    """The ``fused_tail`` phase (flagship, 16 × 512², TF32 off, the weights
    and BN statistics in ``state``): T1/T2 against the plain version
    (:func:`check_parity_tail`); ``TRAIN_STEPS`` ``train_step()``s with the
    key on and off (step-1 loss, matrix and gradients, peak memory, step
    time, launches a step) and the probability-free ``eval_step()``; the
    same in bfloat16 (4 steps); one step on two ranks (the ddp phase's
    layout) against one process.  Returns the ``kernels`` line's rows and
    the launches of the paths ``train_step_fused_tail``,
    ``eval_step_fused_tail``, ``train_step_fused_tail_bfloat16`` and
    ``train_step_fused_tail_ddp`` (rank 0's)."""
    import tempfile

    import torch

    from deeplabv3plus_keras_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    agg = check_parity_tail(card)
    pixels = BATCH * SIZE * SIZE
    cm_bound = max(8, pixels // 4096)
    steps, failures, by_path = {}, [], {}
    for dtype, n in (("float32", TRAIN_STEPS), ("bfloat16", 4)):
        on = tail_steps(kernels, state, dtype, True, n)
        off = tail_steps(kernels, state, dtype, False, n)
        grad = math.sqrt(sum((a - b).double().square().sum().item()
                             for a, b in zip(on["first"]["grads"], off["first"]["grads"])))
        grad /= math.sqrt(sum(b.double().square().sum().item() for b in off["first"]["grads"]))
        res = {
            "step1_loss": [on["first"]["loss"], off["first"]["loss"]],
            "step1_loss_rel": abs(on["first"]["loss"] - off["first"]["loss"]) / off["first"]["loss"],
            "step1_cm_differing": int((on["first"]["cm"] - off["first"]["cm"]).abs().sum()),
            "step1_grad_rel_2norm": grad,
            "eval_loss_rel": abs(on["eval"]["loss"] - off["eval"]["loss"]) / off["eval"]["loss"],
            "eval_cm_differing": int((on["eval"]["cm"] - off["eval"]["cm"]).abs().sum()),
            "eval_launches": [on["eval"]["launches"], off["eval"]["launches"]],
            **{f"{k}_on_off": [on[k], off[k]] for k in
               ("max_memory_allocated_gib", "img_per_s", "step_s", "launches_per_step")}}
        if "profile" in on:
            res["device_ms_on_off"] = [on["profile"]["device_ms"], off["profile"]["device_ms"]]
            res["top_kernels_ms_on_off"] = [on["profile"]["top_kernels_ms"],
                                            off["profile"]["top_kernels_ms"]]
        res["peak_saving_gib"] = off["max_memory_allocated_gib"] - on["max_memory_allocated_gib"]
        steps[dtype] = res
        suffix = "" if dtype == "float32" else f"_{dtype}"
        by_path[f"train_step_fused_tail{suffix}"] = on["launches"]
        if dtype == "float32":
            by_path["eval_step_fused_tail"] = on["eval"]["launches"]
        loss_bound = TAIL_STEP_LOSS_REL if dtype == "float32" else TAIL_BF16_LOSS_REL
        cm_b = cm_bound if dtype == "float32" else pixels // 100
        expect = {"parity_tail_fwd": 1, "parity_tail_bwd": 1, "depthwise_fwd_s1": 15,
                  "depthwise_fwd_s2": 3, "depthwise_bwd_s1": 15, "depthwise_bwd_s2": 3}
        if not (res["step1_loss_rel"] <= loss_bound and res["eval_loss_rel"] <= loss_bound):
            failures.append(f"{dtype}: losses fused vs unfused {res['step1_loss_rel']}, eval "
                            f"{res['eval_loss_rel']} > {loss_bound}")
        if not (res["step1_cm_differing"] <= cm_b and res["eval_cm_differing"] <= cm_b):
            failures.append(f"{dtype}: matrices differ by {res['step1_cm_differing']} / "
                            f"{res['eval_cm_differing']} pixels > {cm_b}")
        if dtype == "float32" and not grad <= TAIL_STEP_GRAD_REL:
            failures.append(f"first step's gradients fused vs unfused {grad} > {TAIL_STEP_GRAD_REL}")
        if on["launches_per_step"] != expect or any(
                k.startswith("parity_tail") for k in off["launches_per_step"]):
            failures.append(f"{dtype}: launches a step {on['launches_per_step']} (unfused "
                            f"{off['launches_per_step']}), expected {expect}")
        ev_on, ev_off = on["eval"]["launches"], off["eval"]["launches"]
        if (ev_on["parity_tail_fwd"], ev_on["parity_tail_bwd"], ev_off["parity_tail_fwd"]) != (1, 0, 0):
            failures.append(f"{dtype}: eval_step launches {ev_on} (unfused {ev_off})")
        if not on["max_memory_allocated_gib"] < off["max_memory_allocated_gib"]:
            failures.append(f"{dtype}: fused_tail did not lower the peak memory: {res}")
    print(json.dumps({"fused_tail_steps": steps, "batch": BATCH, "image": SIZE, "card": card}))

    # two ranks against one process: the ddp phase's layout and bounds
    layout = ddp_layout()
    deterministic = torch.backends.cudnn.deterministic
    ddp_numerics()
    with tempfile.TemporaryDirectory() as tmp:
        state_path = os.path.join(tmp, "state.pt")
        torch.save(state, state_path)
        launch.spawn(_fused_ddp_rank, 2, (state_path, tmp), devices=layout["devices"],
                     backend=layout["backend"], timeout_s=240, group_timeout_s=180)
        ranks = [torch.load(os.path.join(tmp, f"tail_r{r}.pt")) for r in (0, 1)]
    one = ddp_steps(state, torch.device("cuda"), steps=1, fused_tail=True)
    reordered = ddp_steps(state, torch.device("cuda"), torch.arange(BATCH - 1, -1, -1), steps=1,
                          fused_tail=True)
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()

    def grad_rel(run):
        diff = sum((run["grads"][n] - g).double().square().sum() for n, g in one["grads"].items())
        return math.sqrt(diff / sum(g.double().square().sum() for g in one["grads"].values()))

    spread = grad_rel(reordered)
    grad_bound = max(1e-5, DDP_SPREAD * spread)
    two = {"backend": layout["backend"], "cards": layout["cards"],
           "loss_rel": abs(ranks[0]["losses"][0] - one["losses"][0]) / one["losses"][0],
           "cm_abs_diff": int((ranks[0]["cms"][0] - one["cms"][0]).abs().sum()),
           "grad_rel_2norm": grad_rel(ranks[0]), "grad_bound": grad_bound,
           "one_process_rows_reversed_grad_rel_2norm": spread,
           "ranks_bit_identical": all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])
                                      for k in ranks[0]["state"]),
           "launches_per_rank": [r["launches"][0] for r in ranks]}
    by_path["train_step_fused_tail_ddp"] = ranks[0]["launches"][0]
    print(json.dumps({"fused_tail_ddp": two, "card": card}))
    names = ("parity_tail_fwd", "parity_tail_bwd", "depthwise_fwd_s1", "depthwise_fwd_s2",
             "depthwise_bwd_s1", "depthwise_bwd_s2")
    if not (two["loss_rel"] <= DDP_LOSS_REL and two["cm_abs_diff"] <= cm_bound
            and two["grad_rel_2norm"] <= grad_bound and two["ranks_bit_identical"]
            and all([c[k] for k in names] == [1, 1, 15, 3, 15, 3] for c in two["launches_per_rank"])):
        failures.append(f"two ranks against one process: {two}")
    print(json.dumps({"model": "mobilenetv2", "phase": "fused_tail", "s": time.perf_counter() - t0}))
    if failures:
        raise SystemExit("fused_tail: " + "; ".join(failures))
    return agg, by_path


def run_xception_nhwc(kernels, card: str) -> dict:
    """Xception's ``segment()`` and ``train_step()`` under ``nhwc`` (K2 at
    its 33 undilated sites, K4 in training), with the checks and times of
    the ``bhcw`` phase, from the same seed; then the ``xception_route``
    line, the two layouts' device times and images/s side by side.
    Returns the launches by path."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    t0 = time.perf_counter()
    seg = SemanticSegmentation(xception_conf(), device="cuda")
    batches = serving_batches()
    first = torch.from_numpy(batches[0]).cuda()
    calibrate_bn(seg.model, first)
    sites = depthwise_sites(seg.model, first)
    del first
    prefix, stats_only = stats_only_cell(seg.model)
    unreached = {n for n, _ in seg.model.named_parameters() if prefix and n.startswith(prefix)}
    name = "xception_nhwc"
    by_path = {f"{name}_segment": run_serving(seg, kernels, card, batches, depthwise_expect(sites), name)}
    by_path[f"{name}_train_step"], _ = run_training(seg, kernels, card,
                                                    depthwise_expect(sites, True, stats_only), name, unreached)
    del seg
    torch.cuda.empty_cache()
    route = {layout: {path: PATH_TIMES[f"{key}{path}"] for path in ("segment", "train_step")}
             for layout, key in (("bhcw", "xception_"), ("nhwc", f"{name}_"))}
    route["nhwc_over_bhcw_device_ms"] = {
        path: route["nhwc"][path]["device_ms"] / route["bhcw"][path]["device_ms"]
        for path in ("segment", "train_step")}
    print(json.dumps({"xception_route": route, "card": card}))
    print(json.dumps({"model": name, "phase": "segment_train_step", "s": time.perf_counter() - t0}))
    return by_path


# train_quality: the trained outcome of the learnable synthetic task of
# tests/synthetic_task.py, each arm trained from TQ_SEEDS seeds for TQ_STEPS
# steps, scored by batch-statistics evals at its TQ_CHECKPOINTS checkpoints
# TQ_EVERY steps apart (the recipe of tests/test_torch_accuracy_parity.py:
# dropout 0, lr 1e-3, no decay, one-hot labels).  An arm: (side, batch, its
# variants (dtype, fused_tail)).
TQ_SEEDS, TQ_STEPS, TQ_CHECKPOINTS, TQ_EVERY, TQ_EVAL_BATCHES = 3, 250, 5, 25, 4
TQ_ARMS = {
    "parity_conf": (96, 4, (("float32", False), ("bfloat16", False))),
    "flagship": (256, 8, (("float32", False), ("bfloat16", False), ("float32", True),
                          ("bfloat16", True))),
    "nasnetmobile": (256, 8, (("float32", False), ("bfloat16", False))),
}
# every float32 arm's mean reaches 3× chance; a bfloat16 or fused_tail
# variant lands within the JAX suites' band of its float32, tail-off one
TQ_FLOOR, TQ_BAND = 0.15, 0.05
# the jobs (arm, variant, seed) run in this many processes at once: each
# is bound by its host's dispatch, and the card runs them in turns
TQ_WORKERS, TQ_TIMEOUT_S = 7, 600


def test_helper(name: str):
    """``tests/<name>.py`` of this checkout, loaded by path (numpy only at
    import: the synthetic task, the trained-outcome configuration)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"dlv3_tests_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tq_variant(dtype: str, fused: bool) -> str:
    return f"{dtype}_fused_tail" if fused else dtype


def tq_conf(arm: str, dtype: str, fused: bool) -> dict:
    """The arm's JSON config: ``parity_conf`` is the CPU suites'
    configuration (``torch_helpers.accuracy_conf_dict``); ``flagship`` and
    ``nasnetmobile`` the flagship's at full width (with NASNet-Mobile as
    backbone), trained by the same recipe."""
    size, batch, _ = TQ_ARMS[arm]
    if arm == "parity_conf":
        conf = test_helper("torch_helpers").accuracy_conf_dict(dtype, size, batch)
    else:
        conf = backbone_conf("mobilenetv2" if arm == "flagship" else arm)(size, batch)
        conf["hps"].update(dtype=dtype, lr=1e-3, decay=0.0)
        conf["nn_arch"]["dropout_rate"] = 0.0
    if fused:
        conf["fused_tail"] = True
    return conf


def tq_job(arm: str, dtype: str, fused: bool, seed: int) -> dict:
    """One seed of one arm's variant, in a process of its own: the facade
    ``SemanticSegmentation(conf, device="cuda")`` with the port's weights of
    ``init_weights(torch.Generator().manual_seed(seed))`` (stochastic depth
    off), ``TQ_STEPS`` ``train_step()``s on seed's batch stream
    (``make_batch(default_rng(11 + 1000·seed), batch, side)``, drawn before
    the first step), a batch-statistics eval of the held-out set
    (``make_batch(default_rng(1000 + i))``, i < ``TQ_EVAL_BATCHES``) at
    each checkpoint with every BN's running statistics restored after it;
    for the flagship, the held-out set served through ``segment()`` (K1)
    after the last step.  Returns the checkpoints' mIoUs, the served mIoU,
    the losses' finiteness, step times, wall, peak memory and the kernels'
    launches."""
    import numpy as np
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.models import DeepLabV3Plus

    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    task, helpers = test_helper("synthetic_task"), test_helper("torch_helpers")
    size, batch, _ = TQ_ARMS[arm]
    t0 = time.perf_counter()
    seg = SemanticSegmentation(tq_conf(arm, dtype, fused), device="cuda")
    drawn = DeepLabV3Plus(seg.conf)
    drawn.init_weights(torch.Generator().manual_seed(seed))
    seg.model.load_state_dict(drawn.state_dict())
    no_stochastic_depth(seg.model)
    held_out = [task.make_batch(np.random.default_rng(1000 + i), batch, size)
                for i in range(TQ_EVAL_BATCHES)]
    held = [(torch.from_numpy(x).cuda(), torch.from_numpy(lab).cuda()) for x, lab in held_out]

    def batch_stats_miou() -> float:
        cm = 0
        for x, lab in held:
            pred = helpers.batch_stats_probs(seg.model, x).argmax(-1)
            cm = cm + torch.bincount((lab * CLASSES + pred).reshape(-1),
                                     minlength=CLASSES * CLASSES)
        return task.miou(cm.reshape(CLASSES, CLASSES).cpu().numpy())

    rng = np.random.default_rng(11 + 1000 * seed)
    stream = [task.make_batch(rng, batch, size) for _ in range(TQ_STEPS)]
    eval_at = task.checkpoint_steps(TQ_STEPS, TQ_CHECKPOINTS, TQ_EVERY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    # no wait a step (the evals wait): each step's time between two CUDA
    # events, the losses read at the end
    losses, spans, marks = [], [], []
    for i, (x, lab) in enumerate(stream):
        image = torch.from_numpy(x).cuda()
        label = torch.nn.functional.one_hot(torch.from_numpy(lab).cuda().long(), CLASSES).float()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        losses.append(seg.train_step({"image": image, "label": label})["loss"])
        end.record()
        spans.append((start, end))
        if i in eval_at:
            marks.append(batch_stats_miou())
    losses = torch.stack(losses).cpu()
    served = None
    if arm == "flagship":  # inference mode: the running statistics, K1
        cm = sum(task.np_cm(lab, seg.segment(x)) for x, lab in held_out)
        served = task.miou(cm)
    out = {"arm": arm, "variant": tq_variant(dtype, fused), "seed": seed, "checkpoints": marks,
           "served_miou": served, "finite": bool(torch.isfinite(losses).all()),
           "first_loss": losses[0].item(), "last_loss": losses[-1].item(),
           "median_step_ms": statistics.median(a.elapsed_time(b) for a, b in spans[1:]),
           "launches": kernels.launch_counts(), "wall_s": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.cuda.empty_cache()
    return out


def start_train_quality():
    """Start the ``train_quality`` phase's jobs: every (arm, variant, seed)
    of ``TQ_ARMS`` as one :func:`tq_job`, the longest (NASNet-Mobile's)
    first, in ``TQ_WORKERS`` spawned processes that share the card.  The
    processes inherit this one's ``DLV3_DW_LAYOUT``; each job turns TF32
    off.  Returns (the pool, the pending results, the start time) for
    :func:`finish_train_quality`."""
    import multiprocessing as mp

    pool = mp.get_context("spawn").Pool(TQ_WORKERS)
    pending = [pool.apply_async(tq_job, (arm, dtype, fused, seed))
               for arm in ("nasnetmobile", "flagship", "parity_conf")
               for dtype, fused in TQ_ARMS[arm][2] for seed in range(TQ_SEEDS)]
    return pool, pending, time.perf_counter()


def finish_train_quality(started, card: str) -> dict:
    """Wait for the jobs of :func:`start_train_quality` (within
    ``TQ_TIMEOUT_S`` of their start; every process is stopped after), print
    the ``train_quality`` line (per arm and variant: every seed's
    checkpoints and served mIoU, the mean over its evals, the median step
    ms, the jobs' wall s and the peak GiB) and fail the run when a float32
    variant's mean is under ``TQ_FLOOR``, a bfloat16 or ``fused_tail``
    variant's is more than ``TQ_BAND`` from its arm's float32, tail-off
    mean, a loss is not finite, or a kernel of the path was not launched
    (K2–K5 in every variant, T1/T2 with ``fused_tail``, K1 in the
    flagship's ``segment()``).  Returns the launches by path
    ``train_quality_<arm>_<variant>``, summed over the seeds."""
    import multiprocessing as mp

    pool, pending, t0 = started
    with pool:  # terminates the processes on the way out
        try:
            results = [r.get(max(1.0, t0 + TQ_TIMEOUT_S - time.perf_counter()))
                       for r in pending]
        except mp.TimeoutError:
            raise SystemExit(f"train_quality: the jobs did not finish within {TQ_TIMEOUT_S} s")
    arms, by_path, failures = {}, {}, []
    for arm, (size, batch, variants) in TQ_ARMS.items():
        arms[arm] = {"image": size, "batch": batch}
        for dtype, fused in variants:
            name = tq_variant(dtype, fused)
            runs = sorted((r for r in results if r["arm"] == arm and r["variant"] == name),
                          key=lambda r: r["seed"])
            marks = [m for r in runs for m in r["checkpoints"]]
            arms[arm][name] = {
                "seeds": {r["seed"]: {"checkpoints": r["checkpoints"],
                                      "mean": statistics.fmean(r["checkpoints"]),
                                      "served_miou": r["served_miou"],
                                      "first_loss": r["first_loss"],
                                      "last_loss": r["last_loss"]} for r in runs},
                "mean": statistics.fmean(marks),
                "median_step_ms": statistics.median(r["median_step_ms"] for r in runs),
                "wall_s": sum(r["wall_s"] for r in runs),
                "peak_gib": max(r["peak_gib"] for r in runs),
            }
            path = f"train_quality_{arm}_{name}"
            by_path[path] = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
            need = ["depthwise_fwd_s1", "depthwise_fwd_s2", "depthwise_bwd_s1",
                    "depthwise_bwd_s2"] + (["parity_tail_fwd", "parity_tail_bwd"] if fused
                                           else []) + (["upsample_argmax"] if arm == "flagship"
                                                       else [])
            missing = [k for k in need if not by_path[path][k]]
            if missing:
                failures.append(f"{path}: {missing} not launched")
            if not all(r["finite"] for r in runs):
                failures.append(f"{path}: a loss is not finite")
        base = arms[arm]["float32"]["mean"]
        for dtype, fused in variants:
            name = tq_variant(dtype, fused)
            mean = arms[arm][name]["mean"]
            if dtype == "float32" and mean < TQ_FLOOR:
                failures.append(f"{arm} {name}: mean mIoU {mean:.4f} < {TQ_FLOOR}")
            if (dtype, fused) != ("float32", False):
                arms[arm][name]["delta_from_float32"] = mean - base
                if abs(mean - base) > TQ_BAND:
                    failures.append(f"{arm} {name}: mean mIoU {mean:.4f} is "
                                    f"{mean - base:+.4f} from float32's {base:.4f}")
    print(json.dumps({"train_quality": {
        "arms": arms, "seeds": TQ_SEEDS, "steps": TQ_STEPS,
        "checkpoints": sorted(test_helper("synthetic_task").checkpoint_steps(
            TQ_STEPS, TQ_CHECKPOINTS, TQ_EVERY)),
        "eval": "batch statistics, running statistics restored; served_miou: segment(), "
                "running statistics",
        "floor": TQ_FLOOR, "band": TQ_BAND, "workers": TQ_WORKERS,
        "note": "step ms between CUDA events, the jobs sharing the card and the host's cores",
        "failures": failures, "wall_s": time.perf_counter() - t0, "card": card}}))
    if failures:
        raise SystemExit(f"train_quality: {failures}")
    return by_path


def train_quality_only() -> int:
    """``--train-quality``: build the kernels and run only the
    ``train_quality`` phase under ``nhwc`` with TF32 off."""
    import torch

    import_port()
    from deeplabv3plus_keras_tpu_torch.kernels import _build

    OUT.mkdir(exist_ok=True)
    card = gpu_line()
    print(card)
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"kernel_build_s": time.perf_counter() - t0, "sources": _build.sources()}))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with dw_layout("nhwc"):
        by_path = finish_train_quality(start_train_quality(), card)
    print(json.dumps({"launches_by_path": by_path, "card": card}))
    print(card)
    print(ok_line())
    return 0


def import_port():
    """The port beside this script, or exit."""
    try:
        import deeplabv3plus_keras_tpu_torch as port
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port's package is not beside this script: {e}")
    if Path(port.__file__).resolve().parent.parent != Path(__file__).resolve().parent:
        raise SystemExit(f"chip_smoke: imported the port from {port.__file__}, not from this checkout")
    return port


def ok_line() -> str:
    import torch

    return json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})


def parity_tail_only() -> int:
    """``--parity-tail``: build ``csrc/parity_tail.cu`` alone and run the
    ``fused_tail`` phase's kernel checks and times (the instantiations'
    registers, the class sweep, T1/T2 at the flagship's tail) and
    :func:`time_parity_tail_by_c`, TF32 off.
    Run beside another tree's copy of this script, in one call, it times
    two versions of the kernels on one card."""
    import torch

    import_port()
    from deeplabv3plus_keras_tpu_torch.kernels import _build

    OUT.mkdir(exist_ok=True)
    card = gpu_line()
    print(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        report = pool.submit(_build.ptxas_report, "parity_tail")
        _build.load("parity_tail")
        PTXAS["parity_tail"] = report.result()
    print(json.dumps({"kernel_build_s": time.perf_counter() - t0, "sources": ["parity_tail"]}))
    print(json.dumps({"ptxas_parity_tail": PTXAS["parity_tail"]}))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check_parity_tail(card)
    time_parity_tail_by_c(card)
    print(card)
    print(ok_line())
    return 0


def cf_only() -> int:
    """``--cf``: build ``csrc/depthwise_cf.cu`` alone and run K6 and K7 at
    Xception's eight sites (:data:`XCEPTION_CF_SITES`, taps from a seed)
    in float32 and bfloat16: each against its plain version, timed beside
    it, cuDNN and the byte bound; then the sums over a forward (K6) and a
    train step (K7), TF32 off.  Run from another tree's copy of the port
    beside this one, in one call, it times two versions of the kernels on
    one card."""
    import torch

    import_port()
    from deeplabv3plus_keras_tpu_torch.kernels import _build

    OUT.mkdir(exist_ok=True)
    card = gpu_line()
    print(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        report = pool.submit(_build.ptxas_report, "depthwise_cf")
        _build.load("depthwise_cf")
        ptxas = PTXAS["depthwise_cf"] = report.result()
    print(json.dumps({"kernel_build_s": time.perf_counter() - t0, "sources": ["depthwise_cf"]}))
    print(json.dumps({"ptxas_depthwise_cf": ptxas}))
    spilled = [r["kernel"] for r in ptxas if r.get("spill_stores") or r.get("spill_loads")]
    if spilled or not ptxas:
        raise SystemExit(f"depthwise_cf.cu: ptxas reports spills in {spilled} (or no kernels)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, sums = [], {}
    for dtype in ("float32", "bfloat16"):
        for shape, mult in XCEPTION_CF_SITES.items():
            w = torch.randn(shape[1], 1, 3, 3, device="cuda", generator=g) * 0.3
            site = (cf_site_rows(shape, mult, w, g, alone=True) if dtype == "float32"
                    else cf_site_rows_bf16(shape, mult, w, g))
            for row in site:
                rows.append(row)
                print(json.dumps({"site": row}))
                if not row["ok"]:
                    raise SystemExit(f"channels-first kernel disagrees with plain at {row}")
                _add_site(sums.setdefault(dtype, {}), row, mult)
    (OUT / "cf_sites.json").write_text(json.dumps({"card": card, "sites": rows}, indent=1))
    print(json.dumps({"depthwise_cf_sums": {
        dtype: {name: dict(a, x_bound=a["ms"] / a["bound_ms"], x_library=a["ms"] / a["library_ms"])
                for name, a in by_kernel.items()} for dtype, by_kernel in sums.items()},
        "per": {"depthwise_fwd_cf": "forward", "depthwise_bwd_cf": "train step"}, "card": card}))
    print(card)
    print(ok_line())
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs an NVIDIA card",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--parity-tail"]:
        return parity_tail_only()
    if sys.argv[1:] == ["--cf"]:
        return cf_only()
    if sys.argv[1:] == ["--train-quality"]:
        return train_quality_only()
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}; none, --parity-tail, "
                         "--cf or --train-quality")

    import_port()
    from deeplabv3plus_keras_tpu_torch import kernels
    from deeplabv3plus_keras_tpu_torch.kernels import _build

    OUT.mkdir(exist_ok=True)
    card = gpu_line()
    print(card)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    t0 = time.perf_counter()
    # what ptxas makes of every kernel's instantiations (registers and
    # spills), compiled beside the build
    with ThreadPoolExecutor(4) as pool:
        reports = {n: pool.submit(_build.ptxas_report, n) for n in _build.sources()}
        _build.build_all()
        print(json.dumps({"kernel_build_s": time.perf_counter() - t0, "sources": _build.sources()}))
        for name, report in reports.items():
            ptxas = PTXAS[name] = report.result()
            print(json.dumps({f"ptxas_{name}": ptxas}))
            spilled = [r["kernel"] for r in ptxas if r.get("spill_stores") or r.get("spill_loads")]
            if spilled or not ptxas:
                raise SystemExit(f"{name}.cu: ptxas reports spills in {spilled} (or no kernels)")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, agg, by_path = [], {}, {}

    # the flagship under the default layout: K1-K5
    with dw_layout("nhwc"):
        a, p, train_img_s = drive_model("mobilenetv2", flagship_conf, kernels, card, g, rows,
                                        {"depthwise_fwd_s1": 15, "depthwise_fwd_s2": 3})
        agg.update(a)
        by_path.update(p)
        # the JSON-config entry points on a dataset on disk: K1-K5 again
        t1 = time.perf_counter()
        p = run_data_path(kernels, card, train_img_s)
        print(json.dumps({"model": "mobilenetv2", "phase": "data_path",
                          "s": time.perf_counter() - t1}))
    by_path.update(p)
    missing = [k for k in ("upsample_argmax", "depthwise_fwd_s1", "depthwise_fwd_s2",
                           "depthwise_bwd_s1", "depthwise_bwd_s2")
               if not sum(p[path][k] for path in p)]
    if missing or not all(p["train_loop"][k] for k in ("depthwise_bwd_s1", "depthwise_bwd_s2")):
        raise SystemExit(f"data path: kernels not launched on train_loop/evaluate/test: {p}")
    # Xception under bhcw: K6/K7 at its 33 undilated sites, K2/K4 at the
    # three dilated ASPP sites, K1 in segment()
    with dw_layout("bhcw"):
        a, p, _ = drive_model("xception", xception_conf, kernels, card, g, rows,
                              {"depthwise_fwd_cf": 33, "depthwise_fwd_s1": 3})
    agg.update(a)
    by_path.update(p)
    # the same two paths under nhwc: K2/K4 at those 33 sites, no layout copies
    with dw_layout("nhwc"):
        by_path.update(run_xception_nhwc(kernels, card))
    # the flagship in bfloat16 and float16, remat, the device-resident
    # dataset and export, under nhwc
    with dw_layout("nhwc"):
        t1 = time.perf_counter()
        batches = serving_batches()
        state, labels32 = calibrated_flagship(batches)
        low = {}
        for dtype in LOW_PRECISION:
            p, low[dtype] = run_low_precision(kernels, card, dtype, state, labels32, g, rows)
            by_path.update(p)
            print(json.dumps({"model": "mobilenetv2", "phase": dtype, "s": time.perf_counter() - t1}))
        by_path.update(run_remat(kernels, card, state))
        print(json.dumps({"model": "mobilenetv2", "phase": "remat", "s": time.perf_counter() - t1}))
        by_path.update(run_cache_device(kernels, card))
        print(json.dumps({"model": "mobilenetv2", "phase": "cache_device",
                          "s": time.perf_counter() - t1}))
        by_path.update(run_export(kernels, card, state))
        print(json.dumps({"model": "mobilenetv2", "phase": "export", "s": time.perf_counter() - t1}))
        # int8_infer: the flagship and Xception quantized, K1-K3 on the path
        t2 = time.perf_counter()
        p = run_int8(kernels, card)
        by_path.update(p)
        if not all(p["segment_int8"][k] for k in ("upsample_argmax", "depthwise_fwd_s1",
                                                  "depthwise_fwd_s2")):
            raise SystemExit(f"int8 segment(): K1-K3 not all launched: {p['segment_int8']}")
        print(json.dumps({"phase": "int8", "s": time.perf_counter() - t2}))
        # fused_tail: the parity-decomposed tail, T1/T2
        a, p = run_fused_tail(kernels, card, state)
        agg.update(a)
        by_path.update(p)
        # the synthetic task's trained outcome (3 seeds x 250 steps of the
        # CPU suites' configuration, the flagship and NASNet-Mobile), in
        # processes of their own beside the ddp and spatial phases, which
        # time nothing they gate on (two ranks on one card)
        t2 = time.perf_counter()
        train_quality = start_train_quality()
        with contextlib.ExitStack() as stop:
            stop.callback(train_quality[0].terminate)  # also where a phase fails
            # two ranks of a process group against one process
            by_path.update(run_ddp(kernels, card, state))
            print(json.dumps({"model": "mobilenetv2", "phase": "ddp",
                              "s": time.perf_counter() - t2, "beside": "the train_quality jobs"}))
            # mesh_space 2: two ranks, each some rows of every image
            t3 = time.perf_counter()
            by_path.update(run_spatial(kernels, card))
            print(json.dumps({"phase": "spatial", "s": time.perf_counter() - t3,
                              "beside": "the train_quality jobs"}))
            by_path.update(finish_train_quality(train_quality, card))
            print(json.dumps({"phase": "train_quality", "s": time.perf_counter() - t2,
                              "beside": "the ddp and spatial phases"}))
        # EfficientNet-B0, NASNet-Mobile and DenseNet-121 at full size (K2–K5
        # at k = 3, 5, 7 and C = 11, 22; also in bfloat16 for the first two),
        # then the nine other variants at 128²
        check_pools(card)
        for name, n_sites in NEW_MODELS.items():
            a, p, _ = drive_model(name, backbone_conf(name), kernels, card, g, rows, n_sites,
                                  site_dtypes=("bfloat16",) if name != "densenet121" else ())
            by_path.update(p)
        t1 = time.perf_counter()
        by_path.update(run_sweep(kernels, card, g, rows))
        print(json.dumps({"phase": "sweep", "s": time.perf_counter() - t1}))
    # backbone_weights: a Keras .h5 through the facade, or the refusal
    # naming TensorFlow where the host lacks it
    run_pretrained(card)
    (OUT / "kernel_sites.json").write_text(json.dumps({"card": card, "sites": rows}, indent=1))
    print(json.dumps({"depthwise_forward_summary": forward_summary(rows), "card": card}))
    print(json.dumps({"depthwise_backward_summary": backward_summary(rows), "card": card}))
    print(json.dumps({"depthwise_cf_forward_summary": cf_forward_summary(rows), "card": card}))
    print(json.dumps({"depthwise_cf_backward_summary": cf_backward_summary(rows), "card": card}))
    print(json.dumps({"depthwise_by_k": depthwise_by_k(rows, [
        *NEW_MODELS, *(f"{m}_bfloat16" for m in NEW_MODELS),
        *(f"{m}_{SWEEP_SIZE}" for m in SWEEP)]), "card": card}))

    out = []
    for name in ("upsample_argmax", "depthwise_fwd_s1", "depthwise_fwd_s2",
                 "depthwise_bwd_s1", "depthwise_bwd_s2", "depthwise_fwd_cf", "depthwise_bwd_cf",
                 "parity_tail_fwd", "parity_tail_bwd"):
        a = agg[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": TPU_SOURCES[name],
            "status": ("ported (a jnp function, not a Pallas call)" if name.startswith("parity_tail")
                       else "ported"),
            "launches": by_path[MAIN_PATH[name]][name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": a["max_abs_err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"], "library_ms": a["library_ms"],
        }
        for f in ("route_ms", "nhwc_kernel_ms", "float32_integer", "bfloat16_one_hot",
                  "bfloat16_integer"):
            if f in a:
                entry[f] = a[f]
        for dtype in LOW_PRECISION:  # K2-K5 at the flagship's sites in that dtype
            if name in low[dtype]:
                entry[dtype] = {f: low[dtype][name][f] for f in
                                ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        if "bfloat16" in a:  # K6/K7 at Xception's sites in bfloat16
            entry["bfloat16"] = {f: a["bfloat16"][f] for f in
                                 ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        if entry["launches"] < 1:
            raise SystemExit(f"{name} was not launched on its path {MAIN_PATH[name]}")
        out.append(entry)
    print(json.dumps({"kernels": out}))
    print(card)
    print(ok_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
