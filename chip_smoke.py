#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``deeplabv3plus_keras_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeplabv3plus_keras_tpu_torch/csrc``,
then

1. holds every kernel against its plain PyTorch version at every site shape
   the serving path gives it (TF32 off), and times kernel, plain version and
   the nearest PyTorch library call with CUDA events;
2. serves the flagship model (MobileNetV2, output stride 16, boundary
   refinement, 21 classes, 512², float32, random weights from a seed) through
   ``SemanticSegmentation(conf, device="cuda").segment()`` on 4 batches of 16,
   checks the labels, the kernels' launch counts per call, and one image
   against the same weights served on the CPU, and reports images/s;
3. prints one JSON line of kernel results, the card's name and power limit,
   and as its last line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero.  Long outputs (the per-site table, the
profile) go to ``chiprun_out/``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BATCH, SIZE, CLASSES = 16, 512, 21
OUT = Path("chiprun_out")
TPU_SOURCES = {
    "depthwise_fwd_s1": "deeplabv3plus_keras_tpu/kernels/depthwise3.py:318",
    "depthwise_fwd_s2": "deeplabv3plus_keras_tpu/kernels/depthwise3.py:684",
    "upsample_argmax": "deeplabv3plus_keras_tpu/kernels/upsample_argmax.py:88",
}
SOURCES = {
    "depthwise_fwd_s1": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_fwd.cu",
    "depthwise_fwd_s2": "deeplabv3plus_keras_tpu_torch/csrc/depthwise_fwd.cu",
    "upsample_argmax": "deeplabv3plus_keras_tpu_torch/csrc/upsample_argmax.cu",
}


def flagship_conf(image_size: int = SIZE) -> dict:
    """The JAX package's benchmarked configuration (its ``__graft_entry__``
    flagship): MobileNetV2 + boundary refinement, the reference's five
    split-separable dilated ASPP branches."""
    rates = [(1, 1), (18, 15), (6, 3), (1, 1), (6, 21)]
    inputs = [-1, 0, 1, 0, 0]
    return {
        "base_model": "mobilenetv2",
        "hps": {"dtype": "float32", "batch_size": BATCH},
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
        model(images)
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


def check_depthwise(sites, g, rows):
    """Kernel vs plain at each distinct site; returns per-kernel sums."""
    import torch
    import torch.nn.functional as F

    from deeplabv3plus_keras_tpu_torch.kernels import depthwise_conv, depthwise_conv_plain, same_pads

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
        _, ph, _ = same_pads(H, k, stride, dil[0])
        _, pw, _ = same_pads(W, k, stride, dil[1])
        lib = lambda: F.conv2d(x, w, stride=stride, padding=(ph, pw), dilation=dil, groups=C)  # noqa: E731
        row = {
            "kernel": f"depthwise_fwd_s{stride}", "shape_nchw": list(shape), "k": k,
            "stride": stride, "dilation": list(dil), "per_forward": mult,
            "max_abs_err": err, "max_abs_ref": scale, "ok": ok,
            "ms": cuda_ms(lambda: depthwise_conv(x, w, stride, dil)),
            "plain_ms": cuda_ms(lambda: depthwise_conv_plain(x, w, stride, dil)),
            "library_ms": cuda_ms(lib),
        }
        b_ms, b_by = bound((x.numel() + y.numel()) * 4 + w.numel() * 4, 2 * k * k * y.numel())
        row.update(bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(json.dumps({"site": row}))
        if not ok:
            raise SystemExit(f"depthwise kernel disagrees with plain at {row}")
        a = agg.setdefault(row["kernel"], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                                               max_abs_err=0.0, bound_by=b_by))
        for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
            a[f] += mult * row[f]
        a["max_abs_err"] = max(a["max_abs_err"], err)
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


def check_upsample_argmax(shape, scale, g, rows):
    import torch
    import torch.nn.functional as F

    from deeplabv3plus_keras_tpu_torch.kernels import upsample_argmax, upsample_argmax_plain

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
    row.update(bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows.append(row)
    print(json.dumps({"site": row}))
    if not row["ok"]:
        raise SystemExit(f"upsample_argmax disagrees with plain: {row}")
    return {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}


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
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.kernels import _build

    OUT.mkdir(exist_ok=True)
    card = gpu_line()
    print(card)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"kernel_build_s": time.perf_counter() - t0, "sources": _build.sources()}))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    # ---- the served model, and the sites its forward gives each kernel ----
    conf = flagship_conf()
    seg = SemanticSegmentation(conf, device="cuda")
    batches = [
        torch.empty(BATCH, SIZE, SIZE, 3).uniform_(-1, 1, generator=torch.Generator().manual_seed(i)).numpy()
        for i in range(4)
    ]
    calibrate_bn(seg.model, torch.from_numpy(batches[0]).cuda())
    sites = depthwise_sites(seg.model, torch.from_numpy(batches[0]).cuda())
    with torch.inference_mode():
        logits, up = seg.model(torch.from_numpy(batches[0]).cuda(), return_presample=True)
    presample = tuple(logits.shape)
    del logits
    n_s1 = sum(s[1] == 1 for s in sites)
    n_s2 = sum(s[1] == 2 for s in sites)
    print(json.dumps({"depthwise_sites_per_forward": {"stride1": n_s1, "stride2": n_s2},
                      "presample_logits": list(presample), "upsample": up}))

    # ---- each kernel against its plain version, at the main path's shapes ----
    rows = []
    agg = check_depthwise(sites, g, rows)
    agg["upsample_argmax"] = check_upsample_argmax(presample, up, g, rows)
    (OUT / "kernel_sites.json").write_text(json.dumps({"card": card, "sites": rows}, indent=1))

    # ---- the main path: segment() on 4 batches of 16 x 512² ----
    expect = {"depthwise_fwd_s1": n_s1, "depthwise_fwd_s2": n_s2, "upsample_argmax": 1}
    if (n_s1, n_s2) != (15, 3):
        raise SystemExit(f"expected 15 stride-1 and 3 stride-2 depthwise sites, got {n_s1}, {n_s2}")
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
            raise SystemExit(f"segment() call {i}: launches {delta}, expected {expect}")
        if labels.shape != (BATCH, SIZE, SIZE) or labels.dtype.name != "int32":
            raise SystemExit(f"labels {labels.shape} {labels.dtype}")
        if labels.min() < 0 or labels.max() >= CLASSES:
            raise SystemExit(f"labels outside [0, {CLASSES}): {labels.min()}..{labels.max()}")
        if i == 0:
            first_labels = labels
    launches = kernels.launch_counts()
    fp32_img_s = BATCH / statistics.median(times[1:])

    # TF32 on (torch's default for cuDNN convs): throughput only
    torch.backends.cudnn.allow_tf32 = True
    tf32_times = []
    for images in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        seg.segment(images)
        tf32_times.append(time.perf_counter() - t)
    torch.backends.cudnn.allow_tf32 = False
    tf32_img_s = BATCH / statistics.median(tf32_times)

    # where one call's device time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        seg.segment(batches[1])
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    (OUT / "segment_profile.txt").write_text(f"{card}\nTF32 off, B={BATCH}, {SIZE}^2\n{table}\n")
    # device-side events are the kernels and copies themselves
    dev = {e.key: e.self_device_time_total for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0}
    total_us = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({"segment_device_ms": total_us / 1e3,
                      "top_kernels_ms": [[k[:60], v / 1e3] for k, v in top]}))

    # ---- one image against the same weights served on the CPU ----
    cpu = SemanticSegmentation(conf, device="cpu")
    cpu.model.load_state_dict(seg.model.state_dict())
    torch.set_num_threads(8)
    cpu_labels = cpu.segment(batches[0][:1])
    agree = float((cpu_labels[0] == first_labels[0]).mean())
    classes_seen = int(len(set(first_labels[0].ravel().tolist())))
    print(json.dumps({"segment": {
        "batch": BATCH, "image": SIZE, "dtype": "float32", "calls": len(batches),
        "img_per_s_tf32_off": fp32_img_s, "img_per_s_tf32_on": tf32_img_s,
        "call_s_tf32_off": times, "call_s_tf32_on": tf32_times,
        "cpu_agreement": agree, "classes_in_image0": classes_seen, "launches": launches,
        "card": card}}))
    if agree < 0.999:
        raise SystemExit(f"card vs CPU labels agree on {agree:.5f} < 0.999 of pixels")

    out = []
    for name in ("upsample_argmax", "depthwise_fwd_s1", "depthwise_fwd_s2"):
        a = agg[name]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": TPU_SOURCES[name],
            "status": "ported", "launches": launches[name], "max_abs_err": a["max_abs_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": a["library_ms"],
        })
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
