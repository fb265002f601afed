#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``deeplabv3plus_keras_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeplabv3plus_keras_tpu_torch/csrc``
(and prints what ``ptxas`` makes of every instantiation of the four
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
   layout copies, and beside K2/K4 at the same site, K4 checked there too);
2. serves it through ``SemanticSegmentation(conf, device="cuda").segment()``
   on 4 batches, checks the labels, the kernels' launch counts per call,
   and one image against the same weights served on the CPU, and reports
   images/s with TF32 off and on;
3. trains it through ``SemanticSegmentation.train_step()`` for 6 steps
   (Keras Adam, class-balanced loss + L2, BN in training mode, dropout
   0.5), checks the loss, every parameter's gradient and the launch counts
   per step, and reports the step time, images/s and peak device memory;
   then one step at 2 × 128² on the card and on the CPU from the same
   weights, whose losses and gradients must agree.

Then it prints the forward and backward depthwise summaries against cuDNN
and the byte bound (K7's beside the one-tile-a-block design it replaced),
one JSON line of kernel results (K1-K7), the card's
name and power limit, and as its last line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero.  Long outputs (the per-site table
``kernel_sites.json``, the profiles ``[xception_]segment_profile.txt`` and
``[xception_]train_profile.txt``, the gradient tables) go to
``chiprun_out/``.  It imports nothing of JAX.
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
}
SOURCES = {
    "depthwise_fwd_s1": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_fwd.cu",
    "depthwise_fwd_s2": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_fwd.cu",
    "depthwise_bwd_s1": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_bwd.cu",
    "depthwise_bwd_s2": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_bwd.cu",
    "upsample_argmax": "deeplabv3plus_keras_tpu_torch/csrc/upsample_argmax.cu",
    "depthwise_fwd_cf": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_cf.cu",
    "depthwise_bwd_cf": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_cf.cu",
}
# The path whose launches a kernel's "launches" reports: the one it was
# ported for.
MAIN_PATH = {
    "upsample_argmax": "segment", "depthwise_fwd_s1": "segment", "depthwise_fwd_s2": "segment",
    "depthwise_bwd_s1": "train_step", "depthwise_bwd_s2": "train_step",
    "depthwise_fwd_cf": "xception_segment", "depthwise_bwd_cf": "xception_train_step",
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
    forward of ``model`` on ``images``, in call order."""
    import torch

    from deeplabv3plus_keras_tpu_torch.models.blocks import DepthwiseConv

    sites = []
    hooks = [
        m.register_forward_pre_hook(
            lambda mod, args: sites.append((tuple(args[0].shape), mod.strides, mod.dilation, mod))
        )
        for m in model.modules() if isinstance(m, DepthwiseConv)
    ]
    try:
        with torch.inference_mode():
            model(images, return_presample=True)
    finally:
        for h in hooks:
            h.remove()
    return sites


def _add_site(agg: dict, row: dict, mult: int) -> None:
    """Add one site's times, ``mult`` times (its calls per pass), to its
    kernel's sums."""
    a = agg.setdefault(row["kernel"], dict(max_abs_err=0.0, bound_by=row["bound_by"]))
    for f in ("ms", "plain_ms", "library_ms", "bound_ms", "route_ms", "nhwc_kernel_ms"):
        if f in row:
            a[f] = a.get(f, 0.0) + mult * row[f]
    a["max_abs_err"] = max(a["max_abs_err"], row["max_abs_err"])


def check_depthwise(sites, g, rows):
    """Kernel vs plain at each distinct site; returns per-kernel sums."""
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
        x = torch.randn(shape, device="cuda", generator=g).contiguous(memory_format=torch.channels_last)
        w = mod.weight.detach()
        k = w.shape[-1]
        y = depthwise_conv(x, w, stride, dil)
        ref = depthwise_conv_plain(x, w, stride, dil)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = err <= 1e-5 * scale
        # cuDNN pads symmetrically: where TF pads (0, 1) (stride 2, even
        # size) it gets (1, 1), so that it computes as many outputs as the
        # kernel from the same input (a window one pixel up and left)
        ph = max(same_pads(H, k, stride, dil[0])[1:])
        pw = max(same_pads(W, k, stride, dil[1])[1:])
        lib = lambda: F.conv2d(x, w, stride=stride, padding=(ph, pw), dilation=dil, groups=C)  # noqa: E731
        if lib().shape != y.shape:
            raise SystemExit(f"library call's output {tuple(lib().shape)} is not {tuple(y.shape)}")
        row = {
            "kernel": f"depthwise_fwd_s{stride}", "shape_nchw": list(shape), "k": k,
            "stride": stride, "dilation": list(dil), "per_forward": mult,
            "max_abs_err": err, "max_abs_ref": scale, "ok": ok,
            "ms": cuda_ms(lambda: depthwise_conv(x, w, stride, dil)),
            "plain_ms": cuda_ms(lambda: depthwise_conv_plain(x, w, stride, dil)),
            "library_ms": cuda_ms(lib),
        }
        b_ms, b_by = bound((x.numel() + y.numel()) * 4 + w.numel() * 4, 2 * k * k * y.numel())
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
    # bfloat16 (not on the float32 serving path): one site, fp32 accumulate
    x = torch.randn(4, 96, 64, 64, device="cuda", generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(96, 1, 3, 3, device="cuda", generator=g)
    for s in (1, 2):
        y, ref = depthwise_conv(x, w, s), depthwise_conv_plain(x, w, s)
        err = (y.float() - ref.float()).abs().max().item()
        if not err <= 1e-2 * ref.float().abs().max().item():
            raise SystemExit(f"bfloat16 depthwise stride {s} disagrees: {err}")
    print(json.dumps({"bf16_depthwise_check": "ok"}))
    return agg


def check_depthwise_backward(sites, g, rows):
    """K4/K5 (dx and dk) vs the plain backward at each distinct site of a
    training step; returns per-kernel sums over one step's sites."""
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
        w = mod.weight.detach()
        k = w.shape[-1]
        Ho, pt, pb = same_pads(H, k, stride, dil[0])
        Wo, pl, pr = same_pads(W, k, stride, dil[1])
        x = torch.randn(shape, device="cuda", generator=g).contiguous(memory_format=cl)
        gout = torch.randn((B, C, Ho, Wo), device="cuda", generator=g).contiguous(memory_format=cl)
        dx, dk = depthwise_conv_backward(x, w, gout, stride, dil)
        dx2, dk2 = depthwise_conv_backward(x, w, gout, stride, dil)
        rdx, rdk = depthwise_conv_backward_plain(x, w, gout, stride, dil)
        _, dk_abs = depthwise_conv_backward_plain(x.abs(), w, gout.abs(), stride, dil)
        torch.cuda.synchronize()
        dx_err = (dx - rdx).abs().max().item()
        dx_scale = rdx.abs().max().item()
        dk_err = (dk - rdk).abs().max().item()
        # dk: 1e-4 of Σ|x·g| per tap and channel, the float32 sum's scale;
        # no atomics, so two runs give the same bits
        dk_ok = bool(((dk - rdk).abs() <= 1e-4 * dk_abs).all())
        same_bits = torch.equal(dk, dk2) and torch.equal(dx, dx2)
        ok = dx_err <= 1e-5 * dx_scale and dk_ok and same_bits
        del dx2, dk2
        if pt == pb and pl == pr:  # cuDNN pads symmetrically itself
            lib_x, lib_pad = x, [pt, pl]
        else:  # stride 2, TF SAME (0, 1): pad once, outside the timed call
            lib_x, lib_pad = torch.nn.functional.pad(x, (pl, pr, pt, pb)), [0, 0]
        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            gout, lib_x, w, None, [stride, stride], lib_pad, list(dil), False, [0, 0], C,
            [True, True, False])
        name = f"depthwise_bwd_s{stride}"
        row = {
            "kernel": name, "shape_nchw": list(shape), "k": k, "stride": stride,
            "dilation": list(dil), "per_step": mult, "max_abs_err": max(dx_err, dk_err),
            "dx_max_abs_err": dx_err, "dx_max_abs_ref": dx_scale, "dk_max_abs_err": dk_err,
            "dk_max_abs_ref": rdk.abs().max().item(), "dk_bit_reproducible": same_bits, "ok": ok,
            "ms": cuda_ms(lambda: depthwise_conv_backward(x, w, gout, stride, dil)),
            "plain_ms": cuda_ms(lambda: depthwise_conv_backward_plain(x, w, gout, stride, dil)),
            "library_ms": cuda_ms(lib),
        }
        # x and g read once, dx written once; k² multiply-adds per output
        # element for dx and again for dk
        b_ms, b_by = bound((x.numel() + gout.numel() + dx.numel()) * 4 + 2 * w.numel() * 4,
                           4 * k * k * gout.numel())
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
    # bfloat16 (not on the float32 training path): one site, fp32 accumulate
    x = torch.randn(4, 96, 64, 64, device="cuda", generator=g).to(torch.bfloat16).contiguous(memory_format=cl)
    w = torch.randn(96, 1, 3, 3, device="cuda", generator=g)
    for s in (1, 2):
        gout = torch.randn(4, 96, 64 // s, 64 // s, device="cuda", generator=g).to(torch.bfloat16)
        gout = gout.contiguous(memory_format=cl)
        dx, dk = depthwise_conv_backward(x, w, gout, s)
        wr = w.bfloat16().double()  # the taps the kernel uses for dx
        rdx, rdk = depthwise_conv_backward_plain(x.double(), wr, gout.double(), s)
        _, dk_abs = depthwise_conv_backward_plain(x.double().abs(), wr, gout.double().abs(), s)
        if not ((dx.double() - rdx).abs().max() <= 1e-2 * rdx.abs().max()
                and ((dk.double() - rdk).abs() <= 1e-4 * dk_abs).all()):
            raise SystemExit(f"bfloat16 depthwise backward stride {s} disagrees")
    print(json.dumps({"bf16_depthwise_backward_check": "ok"}))
    return agg


def check_cf(sites, g, rows):
    """K6/K7 (the channels-first kernels) vs the plain forward and backward
    at each distinct k3 stride-1 undilated site of ``sites``, NCHW-contiguous
    inputs; dk of two runs must agree bit for bit.  Each site is also timed
    as the whole route (``depthwise_conv`` under ``bhcw``: x and g made
    NCHW-contiguous, dx and y returned to ``channels_last``), as K2/K4 on the
    same site in ``channels_last``, and as cuDNN's grouped conv and its
    ``convolution_backward`` on the NCHW-contiguous input.  Returns per-kernel
    sums over one pass (a forward for K6, a train step for K7)."""
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
    from deeplabv3plus_keras_tpu_torch.kernels.depthwise import _cf_bwd_plan, _ptr_align

    cl = torch.channels_last
    distinct = {}
    for shape, stride, dil, mod in sites:
        if (mod.weight.shape[-1], stride, tuple(dil)) == (3, 1, (1, 1)):
            distinct.setdefault(shape, [mod, 0])[1] += 1
    agg = {}
    for shape, (mod, mult) in distinct.items():
        B, C, H, W = shape
        w = mod.weight.detach()
        x = torch.randn(shape, device="cuda", generator=g)
        gout = torch.randn(shape, device="cuda", generator=g)
        x_cl, g_cl = x.contiguous(memory_format=cl), gout.contiguous(memory_format=cl)
        y = depthwise_cf(x, w)
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
        # forward as K2, dx as K4: float32 rounding of 9-term sums; dk 1e-4
        # of Σ|x·g| per tap and channel, the float32 sum's scale
        fwd_ok = y_err <= 1e-5 * y_scale
        bwd_ok = dx_err <= 1e-5 * dx_scale and bool(((dk - rdk).abs() <= 1e-4 * dk_abs).all())
        with dw_layout("nhwc"):  # K4 at the same site, by the same rule, two runs
            ndx, ndk = depthwise_conv_backward(x_cl, w, g_cl)
            ndx2, ndk2 = depthwise_conv_backward(x_cl, w, g_cl)
        k4_ok = ((ndx - rdx).abs().max().item() <= 1e-5 * dx_scale
                 and bool(((ndk - rdk).abs() <= 1e-4 * dk_abs).all())
                 and torch.equal(ndk, ndk2) and torch.equal(ndx, ndx2))
        del y, ref, dx, dx2, dk2, rdx, dk_abs, ndx, ndk, ndx2, ndk2
        with dw_layout("bhcw"):
            route_f = cuda_ms(lambda: depthwise_conv(x_cl, w))
            route_b = cuda_ms(lambda: depthwise_conv_backward(x_cl, w, g_cl))
        with dw_layout("nhwc"):
            k2_ms = cuda_ms(lambda: depthwise_conv(x_cl, w))
            k4_ms = cuda_ms(lambda: depthwise_conv_backward(x_cl, w, g_cl))
        common = {"shape_nchw": list(shape), "k": 3, "stride": 1, "dilation": [1, 1],
                  "model": "xception"}
        fwd = dict(
            common, kernel="depthwise_fwd_cf", per_forward=mult, max_abs_err=y_err,
            max_abs_ref=y_scale, ok=fwd_ok,
            ms=cuda_ms(lambda: depthwise_cf(x, w)), route_ms=route_f,
            plain_ms=cuda_ms(lambda: depthwise_conv_plain(x, w)),
            library_ms=cuda_ms(lambda: F.conv2d(x, w, padding=1, groups=C)),
            nhwc_kernel="depthwise_fwd_s1", nhwc_kernel_ms=k2_ms)
        b_ms, b_by = bound((x.numel() * 2 + w.numel()) * 4, 2 * 9 * x.numel())
        fwd.update(bound_ms=b_ms, bound_by=b_by)
        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            gout, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], C, [True, True, False])
        bwd = dict(
            common, kernel="depthwise_bwd_cf", per_step=mult, max_abs_err=max(dx_err, dk_err),
            dx_max_abs_err=dx_err, dx_max_abs_ref=dx_scale, dk_max_abs_err=dk_err,
            dk_max_abs_ref=rdk.abs().max().item(), dk_bit_reproducible=same_bits,
            ok=bwd_ok and same_bits,
            ms=cuda_ms(lambda: depthwise_cf_backward(x, w, gout)), route_ms=route_b,
            plain_ms=cuda_ms(lambda: depthwise_conv_backward_plain(x, w, gout)),
            library_ms=cuda_ms(lib), nhwc_kernel="depthwise_bwd_s1", nhwc_kernel_ms=k4_ms,
            nhwc_kernel_ok=k4_ok)
        # x and g read once, dx written once; 9 multiply-adds per element
        # for dx and again for dk
        b_ms, b_by = bound((x.numel() * 3 + 2 * w.numel()) * 4, 4 * 9 * x.numel())
        plan = _cf_bwd_plan(B, C, H, W, x.dtype, _ptr_align(x, gout))
        bwd.update(bound_ms=b_ms, bound_by=b_by, plan={
            "mode": plan.mode, "block": [plan.ncx, plan.nry], "r": plan.r,
            "tile_rows": plan.th, "tiles": plan.tiles, "walk": plan.walk,
            "groups": plan.groups, "grid": list(plan.grid), "smem": plan.smem})
        for row in (fwd, bwd):
            rows.append(row)
            print(json.dumps({"site": row}))
            if not row["ok"] or not row.get("nhwc_kernel_ok", True):
                raise SystemExit(f"channels-first kernel (or K4 beside it) disagrees with plain at {row}")
            _add_site(agg, row, mult)
    # bfloat16 (not on the float32 paths): one site, against float64
    x = torch.randn(16, 128, 127, 127, device="cuda", generator=g).bfloat16()
    gout = torch.randn(x.shape, device="cuda", generator=g).bfloat16()
    w = torch.randn(128, 1, 3, 3, device="cuda", generator=g)
    wr = w.bfloat16().double()
    y = depthwise_cf(x, w)
    dx, dk = depthwise_cf_backward(x, w, gout)
    ref = depthwise_conv_plain(x.double(), wr)
    rdx, rdk = depthwise_conv_backward_plain(x.double(), wr, gout.double())
    _, dk_abs = depthwise_conv_backward_plain(x.double().abs(), wr, gout.double().abs())
    if not ((y.double() - ref).abs().max() <= 1e-2 * ref.abs().max()
            and (dx.double() - rdx).abs().max() <= 1e-2 * rdx.abs().max()
            and ((dk.double() - rdk).abs() <= 1e-4 * dk_abs).all()):
        raise SystemExit("bfloat16 channels-first depthwise disagrees with plain")
    print(json.dumps({"bf16_depthwise_cf_check": "ok"}))
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


def run_serving(seg, kernels, card: str, batches, expect: dict, name: str) -> dict:
    """The serving path: ``segment()`` on each of ``batches`` with TF32 off;
    checks the labels and the launches of every call, then the labels of
    one image against the same weights served on the CPU.  Returns the
    launch counts of those calls."""
    import torch

    kernels.reset_launch_counts()
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
        "card": card}}))
    if agree < 0.999:
        raise SystemExit(f"{name}: card vs CPU labels agree on {agree:.5f} < 0.999 of pixels")
    return launches


def run_training(seg, kernels, card: str, expect: dict, name: str) -> dict:
    """The training path: ``TRAIN_STEPS`` steps of ``seg.train_step``
    with TF32 off; checks the loss, the gradients and the launches of every
    step.  Returns the launch counts of those steps."""
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
           if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]
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
    print(json.dumps({"train_step": {
        "model": name, "batch": BATCH, "image": SIZE, "dtype": "float32", "steps": TRAIN_STEPS,
        "losses": losses, "step_s_tf32_off": times, "median_step_s_2_on": step_s,
        "img_per_s_tf32_off": BATCH / step_s, "step_s_tf32_on": tf32_times,
        "img_per_s_tf32_on": BATCH / statistics.median(tf32_times),
        "max_memory_allocated_gib": peak / 2**30, "launches": launches, "card": card}}))
    return launches


def check_training_against_cpu(conf: dict, name: str) -> None:
    """One train step of ``conf`` (at 2 × 128²) on the card (float32, TF32
    off) and on the CPU in float32 and float64, from the same weights and
    batch (dropout 0: the two devices' generators differ).  The float64 step is
    the reference; the card's loss agrees with it to 1e-4 relative.

    Gradients: float32 gradients of this net in training mode are sums of
    nearly cancelling terms (BN removes each channel's mean), so no
    float32 run meets a tight per-parameter bound: against float64, the
    CPU's own float32 gradients miss max(3e-3·scale, 5e-7), the JAX
    package's bound for its Pallas-vs-lax gradients
    (tests/test_kernels.py:543), on about half of the flagship's 159
    parameters (this function prints the count).  So the card is held to
    - all gradients together: a relative 2-norm error against float64 of
      at most the larger of 3e-3 and 3× the CPU float32's;
    - each parameter: that bound on its largest error, or a relative
      2-norm error of at most 0.25 (a kernel that computes the wrong
      thing gives errors of order 1; float32 noise stays below that);
    and the counts within the tight bound are printed for the card and
    the CPU float32."""
    import numpy as np
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.models import DeepLabV3Plus
    from deeplabv3plus_keras_tpu_torch.parallel.step import build_train_step, create_train_state

    conf["nn_arch"]["dropout_rate"] = 0.0
    gpu = SemanticSegmentation(conf, device="cuda")
    cpu = SemanticSegmentation(conf, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    ref = DeepLabV3Plus(Config.from_dict(conf))
    ref.load_state_dict(gpu.model.state_dict())
    ref = ref.double().to(memory_format=torch.channels_last)
    ref_step = build_train_step(ref, create_train_state(Config.from_dict(conf), ref),
                                Config.from_dict(conf))
    rng = np.random.default_rng(5)
    batch = {"image": rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, (2, 128, 128))}
    lg = gpu.train_step(batch)["loss"].item()
    lc = cpu.train_step(batch)["loss"].item()
    l64 = ref_step({"image": torch.from_numpy(batch["image"]).double(),
                    "label": torch.from_numpy(batch["label"]),
                    "valid": torch.ones(2)})["loss"].item()
    rows, failed = [], []
    sq = {"card": 0.0, "cpu": 0.0, "ref": 0.0}
    for (pname, pg), pc, pr in zip(gpu.model.named_parameters(), cpu.model.parameters(),
                                   ref.parameters()):
        d_card, d_cpu = pg.grad.cpu().double() - pr.grad, pc.grad.double() - pr.grad
        e_card, e_cpu = d_card.abs().max().item(), d_cpu.abs().max().item()
        scale = pr.grad.abs().max().item()
        sq["card"] += d_card.square().sum().item()
        sq["cpu"] += d_cpu.square().sum().item()
        sq["ref"] += pr.grad.square().sum().item()
        rel2 = d_card.norm().item() / max(pr.grad.norm().item(), 1e-30)
        tight = e_card <= max(3e-3 * scale, 5e-7)
        rows.append({"param": pname, "card_err": e_card, "cpu_f32_err": e_cpu,
                     "scale": scale, "card_rel_2norm": rel2, "within_3e-3_scale": tight})
        if not (tight or rel2 <= 0.25):
            failed.append(rows[-1])
    prefix = "" if name == "mobilenetv2" else f"{name}_"
    (OUT / f"{prefix}train_grads.json").write_text(json.dumps(rows, indent=1))
    rel = abs(lg - l64) / abs(l64)
    norm_card, norm_cpu = (math.sqrt(sq[k] / sq["ref"]) for k in ("card", "cpu"))
    print(json.dumps({"train_step_cpu_agreement": {
        "model": name, "batch": 2, "image": 128, "loss_card": lg, "loss_cpu_f32": lc, "loss_cpu_f64": l64,
        "loss_rel": rel, "params": len(rows),
        "within_3e-3_scale": sum(r["within_3e-3_scale"] for r in rows),
        "cpu_f32_within_3e-3_scale": sum(r["cpu_f32_err"] <= max(3e-3 * r["scale"], 5e-7)
                                         for r in rows),
        "worst_rel_2norm_outside_3e-3_scale": max(
            [r["card_rel_2norm"] for r in rows if not r["within_3e-3_scale"]], default=0.0),
        "grad_rel_2norm_card": norm_card, "grad_rel_2norm_cpu_f32": norm_cpu}}))
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
    cf = [r for r in rows if r["kernel"] == "depthwise_bwd_cf"]
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
    """K7 summed over one Xception train step against the byte bound,
    cuDNN's ``convolution_backward`` and the one-tile-a-block design, with
    each site's plan mode and ratios."""
    cf = [r for r in rows if r["kernel"] == "depthwise_bwd_cf"]
    ms, lib, bnd = (sum(r["per_step"] * r[f] for r in cf) for f in ("ms", "library_ms", "bound_ms"))
    sites = []
    for r in cf:
        before = K7_ONE_TILE_MS.get(tuple(r["shape_nchw"]))
        sites.append({"shape_nchw": r["shape_nchw"], "per_step": r["per_step"], "ms": r["ms"],
                      "bound_ms": r["bound_ms"], "x_bound": r["ms"] / r["bound_ms"],
                      "x_library": r["ms"] / r["library_ms"], "one_tile_ms": before,
                      "x_one_tile": None if before is None else r["ms"] / before,
                      "mode": r["plan"]["mode"], "groups": r["plan"]["groups"]})
    return {"ms": ms, "bound_ms": bnd, "library_ms": lib, "x_bound": ms / bnd, "x_library": ms / lib,
            "one_tile_ms": K7_ONE_TILE_STEP_MS, "x_one_tile": ms / K7_ONE_TILE_STEP_MS, "sites": sites}


def depthwise_expect(sites, train: bool) -> dict:
    """Launches per ``segment()`` call (K1 once) or per train step (no K1,
    a backward launch beside each forward one) of a model whose forward
    gives the depthwise kernels ``sites``, under the current layout."""
    from deeplabv3plus_keras_tpu_torch.kernels import depthwise_route, launch_counts

    expect = dict.fromkeys(launch_counts(), 0)
    expect["upsample_argmax"] = 0 if train else 1
    for _, stride, dil, mod in sites:
        route = depthwise_route(mod.weight, stride, dil)
        kind = "cf" if route == "cf" else f"s{stride}"
        expect[f"depthwise_fwd_{kind}"] += 1
        if train:
            expect[f"depthwise_bwd_{kind}"] += 1
    return expect


def serving_batches() -> list:
    import torch

    return [
        torch.empty(BATCH, SIZE, SIZE, 3).uniform_(-1, 1, generator=torch.Generator().manual_seed(i)).numpy()
        for i in range(SEGMENT_CALLS)
    ]


def drive_model(name: str, conf: dict, kernels, card: str, g, rows, n_sites: dict) -> dict:
    """Every phase of one model under the current ``DLV3_DW_LAYOUT``: the
    kernels at its sites, ``segment()``, ``train_step()`` and the 2 × 128²
    step against the CPU.  ``n_sites`` is the expected count of forward
    launches per kernel.  Returns (per-kernel site sums, launches by path)."""
    import torch

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    t0 = time.perf_counter()
    seg = SemanticSegmentation(conf, device="cuda")
    batches = serving_batches()
    first = torch.from_numpy(batches[0]).cuda()
    calibrate_bn(seg.model, first)
    sites = depthwise_sites(seg.model, first)
    with torch.inference_mode():
        logits, up = seg.model(first, return_presample=True)
    presample = tuple(logits.shape)
    del logits, first
    expect = depthwise_expect(sites, train=False)
    got = {k: v for k, v in expect.items() if k.startswith("depthwise_fwd") and v}
    print(json.dumps({"model": name, "layout": os.environ.get("DLV3_DW_LAYOUT"),
                      "depthwise_launches_per_forward": got,
                      "presample_logits": list(presample), "upsample": up}))
    if got != n_sites:
        raise SystemExit(f"{name}: depthwise launches per forward {got}, expected {n_sites}")

    # ---- each kernel against its plain version, at this model's shapes ----
    n0 = len(rows)
    agg = {}
    if name == "mobilenetv2":
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
    torch.cuda.empty_cache()
    print(json.dumps({"model": name, "phase": "kernel_sites", "s": time.perf_counter() - t0}))

    # ---- the main paths: segment(), then train_step() ----
    by_path = {}
    key = "" if name == "mobilenetv2" else f"{name}_"
    by_path[f"{key}segment"] = run_serving(seg, kernels, card, batches, expect, name)
    print(json.dumps({"model": name, "phase": "segment", "s": time.perf_counter() - t0}))
    by_path[f"{key}train_step"] = run_training(
        seg, kernels, card, depthwise_expect(sites, train=True), name)
    print(json.dumps({"model": name, "phase": "train_step", "s": time.perf_counter() - t0}))
    del seg
    torch.cuda.empty_cache()
    small = (flagship_conf if name == "mobilenetv2" else xception_conf)(128, batch=2)
    check_training_against_cpu(small, name)
    print(json.dumps({"model": name, "phase": "cpu_step", "s": time.perf_counter() - t0}))
    return agg, by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs an NVIDIA card",
              file=sys.stderr)
        return 2

    try:
        import deeplabv3plus_keras_tpu_torch as port
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port's package is not beside this script: {e}")
    if Path(port.__file__).resolve().parent.parent != Path(__file__).resolve().parent:
        raise SystemExit(f"chip_smoke: imported the port from {port.__file__}, not from this checkout")
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
            ptxas = report.result()
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
        a, p = drive_model("mobilenetv2", flagship_conf(), kernels, card, g, rows,
                           {"depthwise_fwd_s1": 15, "depthwise_fwd_s2": 3})
    agg.update(a)
    by_path.update(p)
    # Xception under bhcw: K6/K7 at its 33 undilated sites, K2/K4 at the
    # three dilated ASPP sites, K1 in segment()
    with dw_layout("bhcw"):
        a, p = drive_model("xception", xception_conf(), kernels, card, g, rows,
                           {"depthwise_fwd_cf": 33, "depthwise_fwd_s1": 3})
    agg.update(a)
    by_path.update(p)
    (OUT / "kernel_sites.json").write_text(json.dumps({"card": card, "sites": rows}, indent=1))
    print(json.dumps({"depthwise_forward_summary": forward_summary(rows), "card": card}))
    print(json.dumps({"depthwise_backward_summary": backward_summary(rows), "card": card}))
    print(json.dumps({"depthwise_cf_backward_summary": cf_backward_summary(rows), "card": card}))

    out = []
    for name in ("upsample_argmax", "depthwise_fwd_s1", "depthwise_fwd_s2",
                 "depthwise_bwd_s1", "depthwise_bwd_s2", "depthwise_fwd_cf", "depthwise_bwd_cf"):
        a = agg[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": TPU_SOURCES[name],
            "status": "ported", "launches": by_path[MAIN_PATH[name]][name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": a["max_abs_err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"], "library_ms": a["library_ms"],
        }
        for f in ("route_ms", "nhwc_kernel_ms"):
            if f in a:
                entry[f] = a[f]
        if entry["launches"] < 1:
            raise SystemExit(f"{name} was not launched on its path {MAIN_PATH[name]}")
        out.append(entry)
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
