"""DeepLabV3+ forward pass in plain PyTorch, float32, NCHW.

The model is a function of a flat dict of tensors (``params``) keyed by
the names of the configuration's weights file layout (``param_spec``):
conv kernels OIHW, depthwise kernels (C, 1, k, k), and per BatchNorm
``weight``, ``bias``, ``running_mean`` and ``running_var``.

Conventions of the Keras reference (tonandr/deeplabv3plus_keras) and the
DeepLabV3+ paper (arXiv:1802.02611):

- TF ``SAME`` padding: total (out − 1)·stride + (k − 1)·dilation + 1 − n,
  the extra row or column after (bottom, right);
- Keras BatchNormalization: epsilon 1e-3; training normalises with the
  biased batch variance and moves running ← m·running + (1 − m)·batch;
- MobileNetV2 (alpha 1) cut after ``block_12_add`` (output stride 16) or
  ``block_5_add`` (8), ReLU6, BN momentum 0.999; Xception cut at
  ``block13_sepconv2_bn`` (16) or ``block4_sepconv2_bn`` (8), BN momentum
  0.99, ``VALID`` entry convs, 3×3 stride-2 ``SAME`` max pools;
- the ASPP middle (``encoder_middle_conf``): a DAG of branches on the
  backbone output or an earlier branch: 1×1 conv + BN + ReLU, a
  separable conv (dilated depthwise, then 1×1) + BN + ReLU + 1×1 conv +
  BN + ReLU, or an average pool + 1×1 conv + BN + ReLU + bilinear
  upsample; concatenated, dropout (its mask a uniform draw over the
  concat's (B, C, H, W) from the step's generator), 1×1 projection + BN +
  ReLU;
- the decoder with boundary refinement: the backbone output through a
  1×1 conv to 48 channels + BN + ReLU, both streams upsampled ×(os/2)
  (half-pixel bilinear, edges clamped), concatenated, a 3×3 conv to the
  classes, then ×2 upsample and softmax over classes.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class Arch:
    base_model: str
    output_stride: int
    num_classes: int
    boundary_refinement: bool
    middle: tuple
    reduction_size: int
    concat_channels: int
    conv_rate_multiplier: int
    dropout_rate: float
    bn_momentum: float
    bn_scale: bool


def arch_of(conf: dict) -> Arch:
    """The architecture a configuration dict states (every key explicit)."""
    nn, hps = conf["nn_arch"], conf["hps"]
    middle = tuple(
        dict(op=m["op"], kernel=int(m["kernel"]), rate=tuple(m.get("rate", (1, 1))),
             input=int(m["input"]), factor=tuple(m.get("target_size_factor", (1, 1))))
        for m in nn["encoder_middle_conf"])
    return Arch(conf["base_model"], int(nn["output_stride"]), int(nn["num_classes"]),
                bool(nn["boundary_refinement"]), middle, int(nn["reduction_size"]),
                int(nn["concat_channels"]), int(nn["conv_rate_multiplier"]),
                float(nn["dropout_rate"]), float(hps["bn_momentum"]), bool(hps["bn_scale"]))


# ---------------------------------------------------------------------------
# The weights' layout
# ---------------------------------------------------------------------------

# MobileNetV2 inverted residual blocks 1..16: (features, stride, expansion)
MV2_PLAN = [(24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6), (32, 1, 6), (64, 2, 6),
            (64, 1, 6), (64, 1, 6), (64, 1, 6), (96, 1, 6), (96, 1, 6), (96, 1, 6),
            (160, 2, 6), (160, 1, 6), (160, 1, 6), (320, 1, 6)]


class _Spec:
    """Collects (name, shape, kind) entries: kind ``conv`` (glorot-scaled),
    ``conv_tn`` (the ASPP's std-0.05 kernels) or ``bn``."""

    def __init__(self, bn_scale: bool = True):
        self.rows = []
        self.bn_scale = bn_scale

    def conv(self, name, cout, cin, k, kind="conv"):
        self.rows.append((f"{name}.weight", (cout, cin, k, k), kind))

    def bn(self, name, c, scale=True):
        if scale:
            self.rows.append((f"{name}.weight", (c,), "bn_weight"))
        self.rows.append((f"{name}.bias", (c,), "bn_bias"))
        self.rows.append((f"{name}.running_mean", (c,), "bn_mean"))
        self.rows.append((f"{name}.running_var", (c,), "bn_var"))


def _mv2_spec(s: _Spec, os_: int) -> int:
    s.conv("base.Conv1", 32, 3, 3)
    s.bn("base.bn_Conv1", 32)
    s.conv("base.expanded_conv.depthwise", 32, 1, 3)
    s.bn("base.expanded_conv.depthwise_BN", 32)
    s.conv("base.expanded_conv.project", 16, 32, 1)
    s.bn("base.expanded_conv.project_BN", 16)
    cin = 16
    for i, (feat, _, t) in enumerate(MV2_PLAN[: 5 if os_ == 8 else 12], start=1):
        mid, b = cin * t, f"base.block_{i}"
        s.conv(f"{b}.expand", mid, cin, 1)
        s.bn(f"{b}.expand_BN", mid)
        s.conv(f"{b}.depthwise", mid, 1, 3)
        s.bn(f"{b}.depthwise_BN", mid)
        s.conv(f"{b}.project", feat, mid, 1)
        s.bn(f"{b}.project_BN", feat)
        cin = feat
    return cin


XC_ENTRY = ((2, 64, 128), (3, 128, 256), (4, 256, 728))


def _xc_sep_spec(s: _Spec, block: int, i: int, cin: int, cout: int) -> None:
    name = f"base.block{block}_sepconv{i}"
    s.conv(f"{name}.depthwise", cin, 1, 3)
    s.conv(f"{name}.pointwise", cout, cin, 1)
    s.bn(f"{name}_bn", cout)


def _xc_spec(s: _Spec, os_: int) -> int:
    s.conv("base.block1_conv1", 32, 3, 3)
    s.bn("base.block1_conv1_bn", 32)
    s.conv("base.block1_conv2", 64, 32, 3)
    s.bn("base.block1_conv2_bn", 64)
    for j, (b, cin, cout) in enumerate(XC_ENTRY):
        suffix = f"_{j}" if j else ""
        s.conv(f"base.conv2d{suffix}", cout, cin, 1)
        s.bn(f"base.batch_normalization{suffix}", cout)
        _xc_sep_spec(s, b, 1, cin, cout)
        _xc_sep_spec(s, b, 2, cout, cout)
    if os_ == 8:
        return 728
    for b in range(5, 13):
        for i in range(1, 4):
            _xc_sep_spec(s, b, i, 728, 728)
    _xc_sep_spec(s, 13, 1, 728, 728)
    _xc_sep_spec(s, 13, 2, 728, 1024)
    return 1024


def param_spec(arch: Arch) -> list[tuple[str, tuple, str]]:
    """Every tensor of the model: (name, shape, kind)."""
    s = _Spec()
    if arch.base_model == "mobilenetv2":
        c_base = _mv2_spec(s, arch.output_stride)
    elif arch.base_model == "xception":
        c_base = _xc_spec(s, arch.output_stride)
    else:
        raise ValueError(f"the reference has no backbone {arch.base_model!r}")
    r, sc = arch.reduction_size, arch.bn_scale
    width = []
    for i, m in enumerate(arch.middle):
        cin = c_base if m["input"] == -1 else width[m["input"]]
        if m["op"] == "conv" and m["kernel"] == 1:
            s.conv(f"encoder.branch{i}_conv1x1.conv_l2", r, cin, 1)
            s.bn(f"encoder.branch{i}_conv1x1.bn", r, sc)
        elif m["op"] == "conv":
            b = f"encoder.branch{i}_sep"
            s.conv(f"{b}.sepconv.depthwise", cin, 1, m["kernel"], "conv_tn")
            s.conv(f"{b}.sepconv.pointwise", r, cin, 1, "conv_tn")
            s.bn(f"{b}.bn1", r, sc)
            s.conv(f"{b}.conv_l2", r, r, 1, "conv_tn")
            s.bn(f"{b}.bn2", r, sc)
        else:
            s.conv(f"encoder.branch{i}_pool_conv.conv_l2", r, cin, 1)
            s.bn(f"encoder.branch{i}_pool_conv.bn", r, sc)
        width.append(r)
    s.conv("encoder.projection.conv_l2", arch.concat_channels, sum(width), 1)
    s.bn("encoder.projection.bn", arch.concat_channels, sc)
    if arch.boundary_refinement:
        s.conv("decoder.refine_conv48.conv_l2", 48, c_base, 1)
        s.bn("decoder.refine_conv48.bn", 48, sc)
        s.conv("decoder.classifier_l2", arch.num_classes, 48 + arch.concat_channels, 3)
    else:
        s.conv("decoder.classifier_l2.conv", arch.num_classes, arch.concat_channels, 3)
    return s.rows


def is_trainable(name: str) -> bool:
    return not (name.endswith(".running_mean") or name.endswith(".running_var"))


def is_l2(name: str) -> bool:
    """Keras ``kernel_regularizer=l2``: the kernels whose path has an
    ``_l2`` part."""
    return any("_l2" in part for part in name.split("."))


def random_weights(arch: Arch, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights from ``seed`` on ``device``, drawn in one call: conv kernels
    uniform within the glorot limit (the ASPP's kernels within the limit of
    a std-0.05 uniform), BN at identity (weight 1, bias 0, mean 0, var 1).
    The BN statistics are then set by :func:`calibrate_bn`."""
    spec = param_spec(arch)
    convs = [(n, shp, kind) for n, shp, kind in spec if kind.startswith("conv")]
    sizes = [math.prod(shp) for _, shp, _ in convs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    limits = []
    for _, (o, i, kh, kw), kind in convs:
        rf = kh * kw
        limits.append(0.05 * math.sqrt(3.0) if kind == "conv_tn"
                      else math.sqrt(6.0 / (rf * i + rf * o)))
    flat *= torch.repeat_interleave(torch.tensor(limits, device=device),
                                    torch.tensor(sizes, device=device))
    out = dict(zip((n for n, _, _ in convs),
                   (t.view(shp) for t, (_, shp, _) in zip(flat.split(sizes), convs))))
    fill = {"bn_weight": 1.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_var": 1.0}
    for n, shp, kind in spec:
        if kind in fill:
            out[n] = torch.full(shp, fill[kind], device=device)
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def same_pads(n: int, k: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


class Run:
    """One forward's mode and records: ``train`` (BN on batch statistics,
    dropout on), ``stats`` (the running statistics it moves, by name, when
    given; ``momentum`` overrides every BN's momentum), ``generator`` (the
    dropout mask's stream in training) and ``sites`` (each depthwise
    call's shapes, when given)."""

    def __init__(self, params: dict, train: bool, stats: dict | None = None,
                 momentum: float | None = None, sites: list | None = None,
                 generator: torch.Generator | None = None):
        self.p, self.train, self.stats = params, train, stats
        self.momentum, self.sites, self.generator = momentum, sites, generator


def conv(x, w, stride=1, dilation=(1, 1), padding="SAME", groups=1):
    k = w.shape[-1]
    if padding == "VALID":
        return F.conv2d(x, w, stride=stride, dilation=dilation, groups=groups)
    pt, pb = same_pads(x.shape[-2], k, stride, dilation[0])
    pl, pr = same_pads(x.shape[-1], k, stride, dilation[1])
    if (pt, pl) == (pb, pr):
        return F.conv2d(x, w, stride=stride, padding=(pt, pl), dilation=dilation, groups=groups)
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, stride=stride, dilation=dilation, groups=groups)


def depthwise(run: Run, name: str, x, stride=1, dilation=(1, 1)):
    w = run.p[f"{name}.weight"]
    y = conv(x, w, stride, dilation, groups=x.shape[1])
    if run.sites is not None:
        run.sites.append(dict(name=name, x=tuple(x.shape), y=tuple(y.shape), k=w.shape[-1],
                              stride=stride, dilation=tuple(dilation)))
    return y


def bn(run: Run, name: str, x, momentum: float):
    p = run.p
    w, b = p.get(f"{name}.weight"), p[f"{name}.bias"]
    if not run.train:
        return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"], w, b,
                            False, 0.0, BN_EPS)
    y = F.batch_norm(x, None, None, w, b, True, 0.0, BN_EPS)
    if run.stats is not None:
        m = momentum if run.momentum is None else run.momentum
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            for key, batch in (("running_mean", mean), ("running_var", var)):
                old = p[f"{name}.{key}"]
                run.stats[f"{name}.{key}"] = m * old + (1.0 - m) * batch
    return y


def upsample(x, factor: int):
    """Half-pixel bilinear ×factor, edges clamped (TF2 ``resize_images``)."""
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


# ---------------------------------------------------------------------------
# Backbones
# ---------------------------------------------------------------------------

def mobilenetv2(run: Run, x, os_: int):
    m = 0.999
    x = relu6(bn(run, "base.bn_Conv1", conv(x, run.p["base.Conv1.weight"], 2), m))
    b = "base.expanded_conv"
    x = relu6(bn(run, f"{b}.depthwise_BN", depthwise(run, f"{b}.depthwise", x), m))
    x = bn(run, f"{b}.project_BN", conv(x, run.p[f"{b}.project.weight"]), m)
    cin = 16
    for i, (feat, stride, _) in enumerate(MV2_PLAN[: 5 if os_ == 8 else 12], start=1):
        b, inputs = f"base.block_{i}", x
        x = relu6(bn(run, f"{b}.expand_BN", conv(x, run.p[f"{b}.expand.weight"]), m))
        x = relu6(bn(run, f"{b}.depthwise_BN", depthwise(run, f"{b}.depthwise", x, stride), m))
        x = bn(run, f"{b}.project_BN", conv(x, run.p[f"{b}.project.weight"]), m)
        if stride == 1 and cin == feat:
            x = x + inputs
        cin = feat
    return x


def _xc_sep(run: Run, x, block: int, i: int):
    name = f"base.block{block}_sepconv{i}"
    x = depthwise(run, f"{name}.depthwise", x)
    return bn(run, f"{name}_bn", conv(x, run.p[f"{name}.pointwise.weight"]), 0.99)


def max_pool_same(x, k=3, stride=2):
    pt, pb = same_pads(x.shape[-2], k, stride)
    pl, pr = same_pads(x.shape[-1], k, stride)
    return F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=float("-inf")), k, stride)


def xception(run: Run, x, os_: int):
    p = run.p
    x = F.relu(bn(run, "base.block1_conv1_bn",
                  conv(x, p["base.block1_conv1.weight"], 2, padding="VALID"), 0.99))
    x = F.relu(bn(run, "base.block1_conv2_bn",
                  conv(x, p["base.block1_conv2.weight"], padding="VALID"), 0.99))
    for j, (b, _, _) in enumerate(XC_ENTRY):
        suffix = f"_{j}" if j else ""
        res = bn(run, f"base.batch_normalization{suffix}",
                 conv(x, p[f"base.conv2d{suffix}.weight"], 2), 0.99)
        if b > 2:
            x = F.relu(x)
        x = _xc_sep(run, F.relu(_xc_sep(run, x, b, 1)), b, 2)
        if b == 4 and os_ == 8:
            return x
        x = max_pool_same(x) + res
    for b in range(5, 13):
        res = x
        for i in range(1, 4):
            x = _xc_sep(run, F.relu(x), b, i)
        x = x + res
    x = _xc_sep(run, F.relu(x), 13, 1)
    return _xc_sep(run, F.relu(x), 13, 2)


BACKBONES = {"mobilenetv2": mobilenetv2, "xception": xception}


# ---------------------------------------------------------------------------
# ASPP middle and decoder
# ---------------------------------------------------------------------------

def conv_bn_relu(run: Run, name: str, x, momentum: float, bn_name: str = "bn"):
    y = conv(x, run.p[f"{name}.conv_l2.weight"])
    return F.relu(bn(run, f"{name}.{bn_name}", y, momentum))


def encoder(run: Run, arch: Arch, base):
    m, outs = arch.bn_momentum, []
    for i, op in enumerate(arch.middle):
        x = base if op["input"] == -1 else outs[op["input"]]
        if op["op"] == "conv" and op["kernel"] == 1:
            x = conv_bn_relu(run, f"encoder.branch{i}_conv1x1", x, m)
        elif op["op"] == "conv":
            b = f"encoder.branch{i}_sep"
            dil = (op["rate"][0] * arch.conv_rate_multiplier,
                   op["rate"][1] * arch.conv_rate_multiplier)
            x = depthwise(run, f"{b}.sepconv.depthwise", x, 1, dil)
            x = F.relu(bn(run, f"{b}.bn1", conv(x, run.p[f"{b}.sepconv.pointwise.weight"]), m))
            x = F.relu(bn(run, f"{b}.bn2", conv(x, run.p[f"{b}.conv_l2.weight"]), m))
        else:
            k = op["kernel"]
            x = F.avg_pool2d(x, k, k) if k > 1 else x
            x = conv_bn_relu(run, f"encoder.branch{i}_pool_conv", x, m)
            fy, fx = op["factor"]
            if (fy, fx) != (1, 1):
                x = F.interpolate(x, scale_factor=(fy, fx), mode="bilinear", align_corners=False)
        outs.append(x)
    x = dropout(run, torch.cat(outs, dim=1), arch.dropout_rate)
    return conv_bn_relu(run, "encoder.projection", x, m)


def dropout(run: Run, x, rate: float):
    """Keras/flax dropout in training: keep an element where a uniform draw
    of ``run.generator`` over the whole (B, C, H, W) is below 1 − rate, and
    scale it by 1/(1 − rate)."""
    if not run.train or rate == 0.0:
        return x
    if run.generator is None and not x.is_meta:  # shapes alone need no draw
        raise ValueError("dropout in training needs the step's generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=run.generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def logits(run: Run, arch: Arch, images):
    """images (B, H, W, 3) in (−1, 1) → (pre-upsample logits (B, C, h, w),
    the final upsample factor)."""
    x = images.permute(0, 3, 1, 2).contiguous()
    base = BACKBONES[arch.base_model](run, x, arch.output_stride)
    enc = encoder(run, arch, base)
    os_ = arch.output_stride
    if arch.boundary_refinement:
        low = conv_bn_relu(run, "decoder.refine_conv48", base, arch.bn_momentum)
        half = os_ // 2
        x = torch.cat([upsample(low, half), upsample(enc, half)], dim=1)
        out = conv(x, run.p["decoder.classifier_l2.weight"])
        return out, 2
    return conv(enc, run.p["decoder.classifier_l2.conv.weight"]), os_


def probabilities(run: Run, arch: Arch, images):
    """images (B, H, W, 3) → softmax probabilities (B, H, W, classes)."""
    x, up = logits(run, arch, images)
    return torch.softmax(upsample(x, up), dim=1).permute(0, 2, 3, 1)


@torch.no_grad()
def calibrate_bn(arch: Arch, params: dict, images, seed: int = 0) -> None:
    """Set every BN's running statistics to the batch statistics of one
    training-mode forward over ``images`` (momentum 0, dropout drawn from
    ``seed``), in place."""
    stats = {}
    gen = torch.Generator(device=images.device).manual_seed(int(seed))
    logits(Run(params, train=True, stats=stats, momentum=0.0, generator=gen), arch, images)
    for k, v in stats.items():
        params[k].copy_(v)
