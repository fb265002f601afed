"""NN primitive blocks (port of ``deeplabv3plus_keras_tpu/models/blocks.py:32-284``).

Tensors are NCHW in ``channels_last`` memory.  Each module's parameter
names follow the flax tree, so ``utils/jax_weights.py`` maps one onto the
other mechanically:

- conv weights are torch's OIHW; depthwise weights (C, 1, k, k);
- ``BatchNorm`` holds ``weight`` (absent when ``scale=False``: fixed at 1),
  ``bias``, ``running_mean``, ``running_var``.

Numerics mirrored from the Keras reference:

- Keras ``BatchNormalization``: eps **1e-3** (torch's default is 1e-5);
  Keras momentum m is torch momentum 1 − m.  In training the running
  variance moves toward the *biased* batch variance, as flax's does
  (torch's own update takes the unbiased one).
- Conv init glorot_uniform; the ASPP split-separable blocks use
  TruncatedNormal(σ=0.05) cut at ±2σ; EfficientNet and NASNet use
  variance scaling (2.0, fan out / fan in, truncated normal).  All draw
  from an explicit ``torch.Generator``.  Fans are computed as flax
  computes them on the HWIO kernel, so the bounds match the JAX
  package's.
- Keras NASNet's stride-2 pools pad with literal zeros (``correct_pad``)
  and pool ``VALID``; its stride-1 ``SAME`` average pool leaves the
  padding out of the divisor.  EfficientNet's stochastic depth is flax
  ``nn.Dropout(broadcast_dims=(1, 2, 3))``: one draw per sample.
- ``QuantConv`` is ``Conv`` at the sites where the JAX package uses its
  ``QuantConv``; inside a calibration or quantized pass
  (``ops/quant.py``) it records its input's range or runs int8.

Compute dtype, with flax's semantics (``hps.dtype``; the backbone casts
the images to it where the JAX backbone's first conv does,
``models/backbones/``): parameters and BN statistics stay float32; every
conv casts its weight to the dtype of its input (flax
``promote_dtype(x, kernel, dtype=...)``) and returns that dtype;
``BatchNorm`` on a bfloat16 or float16 input follows
``flax.linen.normalization`` (statistics and normalisation in float32,
the result cast back).  ReLU, adds, concatenations and pooling run in
the input's dtype, rounding where the JAX package's XLA program rounds:
``sigmoid`` after its exp, sum and quotient, average pools after every
add of the window sum, and the ``SAME`` average pool's quotient in
float32 (flax divides by float32 counts).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from ..kernels import depthwise_conv, same_pads
from ..ops import quant
from ..parallel import mesh, spatial
from ..utils.profiling import span

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Keras/flax glorot_uniform on an OIHW weight (fans of the HWIO kernel:
    fan_in = kh·kw·I, fan_out = kh·kw·O)."""
    rf = w.shape[2] * w.shape[3]
    limit = math.sqrt(6.0 / (rf * w.shape[1] + rf * w.shape[0]))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def truncated_normal_05_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``truncated_normal(stddev=0.05, lower=-2, upper=2)``: a standard
    normal cut at ±2, times 0.05 (no variance correction)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, 0.05, -0.1, 0.1, generator=generator)


def variance_scaling_(scale: float, mode: str):
    """flax ``variance_scaling(scale, mode, "truncated_normal")`` on an OIHW
    weight: a normal cut at ±2σ with σ = √(scale / fan) / 0.8796 (the cut
    normal's standard deviation restored), fans of the HWIO kernel."""

    def init(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        rf = w.shape[2] * w.shape[3]
        fan = rf * (w.shape[0] if mode == "fan_out" else w.shape[1])
        std = math.sqrt(scale / fan) / 0.87962566103423978
        with torch.no_grad():
            return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    return init


# Keras EfficientNet's conv init, and he_normal (NASNet)
efficientnet_conv_init_ = variance_scaling_(2.0, "fan_out")
he_normal_ = variance_scaling_(2.0, "fan_in")


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.sigmoid``: JAX lowers ``logistic`` to 1/(1 + exp(−x)), so in
    bfloat16/float16 the exp, the sum and the quotient each round to the
    dtype."""
    if x.dtype in _LOW_PRECISION:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.swish``: x·sigmoid(x), the product rounded in a 16-bit
    dtype as the sigmoid's steps are."""
    if x.dtype in _LOW_PRECISION:
        return x * sigmoid(x)
    return F.silu(x)


def _window_sum(xp: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Sum over each k×k window of the (already padded) ``xp`` at
    ``stride``, added one tap at a time in row-major order in ``xp``'s
    dtype: XLA's ``reduce_window`` add, which rounds each partial sum in
    bfloat16/float16."""
    H = (xp.shape[-2] - kernel) // stride + 1
    W = (xp.shape[-1] - kernel) // stride + 1
    acc = None
    for i in range(kernel):
        for j in range(kernel):
            tap = xp[:, :, i:i + (H - 1) * stride + 1:stride, j:j + (W - 1) * stride + 1:stride]
            acc = tap if acc is None else acc + tap
    return acc.contiguous(memory_format=torch.channels_last)


def _avg_pool(xp: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``avg_pool(padding="VALID")`` of the (already padded) ``xp``:
    the whole window's mean; in bfloat16/float16 the window sum rounds at
    every add, as XLA's does."""
    if xp.dtype in _LOW_PRECISION:
        return _window_sum(xp, kernel, stride) / (kernel * kernel)
    return F.avg_pool2d(xp, kernel, stride)


def _correct_pads(n: int, kernel: int) -> tuple[int, int]:
    """Keras ``imagenet_utils.correct_pad`` along one axis: (before, after)."""
    c = kernel // 2
    return c - (1 - n % 2), c


def pool_zero_padded(x: torch.Tensor, kernel: int, pads, op: str) -> torch.Tensor:
    """A stride-2 ``VALID`` max or average pool of x zero-padded by ``pads``
    = ((top, bottom), (left, right)): Keras' ``ZeroPadding2D`` before a
    pool.  The max compares against literal zeros at the border, the
    average divides by the whole window, zeros included.  Under
    ``mesh_space`` the pads are the image's, the rows fetched."""
    (pt, pb), (pl, pr) = pads

    def pool(xp):
        return F.max_pool2d(xp, kernel, 2) if op == "max" else _avg_pool(xp, kernel, 2)

    if spatial.active():
        return spatial.window_op(
            x, lambda xw: pool(F.pad(xw, (pl, pr, 0, 0))), k=kernel, stride=2, pads_h=(pt, pb),
            out_width=(x.shape[-1] + pl + pr - kernel) // 2 + 1, out_channels=x.shape[1])
    return pool(F.pad(x, (pl, pr, pt, pb)))


def pool_s2_keras(x: torch.Tensor, kernel: int, op: str) -> torch.Tensor:
    """Keras NASNet's stride-2 pool: ``ZeroPadding2D(correct_pad)`` and a
    ``VALID`` pool (JAX ``nasnet.py`` ``_pool_s2_keras``), the pads from
    the global height.  Not TF ``SAME`` pooling: the max pool compares
    against literal zeros at the border, and the average divides by the
    whole window, zeros included."""
    H = spatial.global_height(x) if spatial.active() else x.shape[-2]
    return pool_zero_padded(x, kernel, (_correct_pads(H, kernel),
                                        _correct_pads(x.shape[-1], kernel)), op)


def _avg_same_s1(x: torch.Tensor, kernel: int, pads: tuple[int, int, int, int]) -> torch.Tensor:
    """The window sum of x zero-padded by ``pads`` (F.pad order) divided
    by the count of real taps (a float32 quotient in a 16-bit dtype)."""
    ones = F.pad(torch.ones_like(x[:1, :1], dtype=torch.float32), pads)
    if x.dtype not in _LOW_PRECISION:
        count = F.avg_pool2d(ones, kernel, 1, divisor_override=1).to(x.dtype)
        return F.avg_pool2d(F.pad(x, pads), kernel, 1, divisor_override=1) / count
    count = _window_sum(ones, kernel, 1)
    return _window_sum(F.pad(x, pads), kernel, 1).float() / count


def avg_pool_same_s1(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """TF ``AveragePooling2D(padding='same')`` at stride 1: the padding left
    out of the divisor (flax ``avg_pool(count_include_pad=False)``), the
    window sum over the explicitly zero-padded x divided by the count of
    real taps.  In bfloat16/float16 flax divides the window sum (rounded at
    every add) by float32 counts, so the result is float32.  Under
    ``mesh_space`` a rank pads only rows off the image, so its rows at a
    rank boundary divide by whole windows, as the image's do.

    Not ``F.avg_pool2d(..., padding=kernel // 2)``: on CUDA its backward of
    a ``channels_last`` input with padding is wrong (PyTorch 2.11, every
    shape tried, PERF.md §6); the unpadded pool of the padded x is right."""
    p = kernel // 2
    if spatial.active():
        return spatial.window_op(
            x, lambda xw, pad_t, ho: _avg_same_s1(
                xw, kernel, (p, p, pad_t, ho + 2 * p - pad_t - xw.shape[-2])),
            k=kernel, stride=1, pads_h=(p, p), out_width=x.shape[-1], out_channels=x.shape[1],
            clip=True)
    return _avg_same_s1(x, kernel, (p, p, p, p))


def avg_pool_valid(x: torch.Tensor, pool_size: int) -> torch.Tensor:
    """Keras ``AveragePooling2D(pool_size, padding='valid')``: stride equal to
    the pool size, ragged edge dropped (sizes floor).  Under ``mesh_space``
    each output row's window is fetched whole: it may span every shard."""
    if spatial.active():
        return spatial.window_op(
            x, lambda xw: _avg_pool(xw, pool_size, pool_size), k=pool_size, stride=pool_size,
            pads_h=(0, 0), out_width=x.shape[-1] // pool_size, out_channels=x.shape[1])
    return _avg_pool(x, pool_size, pool_size)


def tf_same_pad(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad with ``value`` for TF ``SAME`` (asymmetric at stride 2 on an even
    size: the extra row and column go after), so a following ``padding=0``
    conv or pool matches XLA."""
    _, pt, pb = same_pads(x.shape[-2], k, stride, 1)
    _, pl, pr = same_pads(x.shape[-1], k, stride, 1)
    return F.pad(x, (pl, pr, pt, pb), value=value)


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (stride, stride), padding="SAME")``:
    explicit −inf pads, then an unpadded pool.  Xception's 3×3 stride-2
    pools pad (1, 1) at 253 → 127 and 127 → 64 but (0, 1) at 64 → 32,
    where torch's symmetric ``padding=1`` would shift every window.  Under
    ``mesh_space`` the pads are the global height's, the halo fetched."""
    if spatial.active():
        _, pt, pb = same_pads(spatial.global_height(x), k, stride, 1)
        Wo, pl, pr = same_pads(x.shape[-1], k, stride, 1)
        return spatial.window_op(
            x, lambda xw: F.max_pool2d(F.pad(xw, (pl, pr, 0, 0), value=float("-inf")), k, stride),
            k=k, stride=stride, pads_h=(pt, pb), out_width=Wo, out_channels=x.shape[1],
            fill=float("-inf"))
    return F.max_pool2d(tf_same_pad(x, k, stride, float("-inf")), k, stride)


def conv_rows(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """``F.conv2d`` of a row-sharded x (``mesh_space``) with the global
    padding ``pads`` = ((top, bottom), (left, right)): this rank's output
    rows from its fetched input window (``parallel/spatial.py``)."""
    (pt, pb), (pl, pr) = pads
    k = w.shape[-1]
    Wo = (x.shape[-1] + pl + pr - k) // stride + 1
    return spatial.window_op(
        x, lambda xw: F.conv2d(F.pad(xw, (pl, pr, 0, 0)), w, stride=stride), k=k, stride=stride,
        pads_h=(pt, pb), out_width=Wo, out_channels=w.shape[0], deps=(w,))


def conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 ``SAME`` conv of an odd k×k kernel (symmetric padding), row
    sharded under ``mesh_space``."""
    p = w.shape[-1] // 2
    if spatial.active():
        return conv_rows(x, w, 1, ((p, p), (p, p)))
    return F.conv2d(x, w, padding=p)


class _Init:
    """Mixin: ``init_weights(generator)`` draws ``weight`` with ``init_fn``."""

    def init_weights(self, generator: torch.Generator) -> None:
        self.init_fn(self.weight, generator)


class Conv(_Init, nn.Module):
    """k×k conv with TF ``SAME``, ``VALID`` or explicit ``((top, bottom),
    (left, right))`` padding: flax ``nn.Conv`` (``QuantConv`` adds the JAX
    package's int8 path).  ``bias=True`` adds a zero-initialised bias
    after the conv, in the conv's dtype, as flax adds it."""

    def __init__(self, cin: int, features: int, kernel: int = 1, strides: int = 1,
                 init_fn=glorot_uniform_, padding="SAME", bias: bool = False):
        super().__init__()
        if padding not in ("SAME", "VALID") and not (
                isinstance(padding, (tuple, list)) and len(padding) == 2
                and all(isinstance(p, (tuple, list)) and len(p) == 2 for p in padding)):
            raise ValueError(f"Conv padding {padding!r}: expected 'SAME', 'VALID' or "
                             "((top, bottom), (left, right))")
        self.kernel, self.strides = kernel, strides
        self.padding = padding if isinstance(padding, str) else tuple(map(tuple, padding))
        self.init_fn = init_fn
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.register_parameter("bias", nn.Parameter(torch.zeros(features)) if bias else None)

    def forward(self, x):
        y = self._conv(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]

    def _conv(self, x, w):
        if spatial.active():
            return conv_rows(x, w, self.strides, self._pads(spatial.global_height(x), x.shape[-1]))
        if self.padding == "VALID":
            return F.conv2d(x, w, stride=self.strides)
        if self.padding == "SAME":
            if self.strides == 1:  # odd k: SAME is symmetric
                return F.conv2d(x, w, padding=self.kernel // 2)
            return F.conv2d(tf_same_pad(x, self.kernel, self.strides), w, stride=self.strides)
        (pt, pb), (pl, pr) = self.padding
        if (pt, pl) == (pb, pr):
            return F.conv2d(x, w, stride=self.strides, padding=(pt, pl))
        return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, stride=self.strides)

    def _pads(self, H: int, W: int):
        """((top, bottom), (left, right)) of an H × W input."""
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            _, pt, pb = same_pads(H, self.kernel, self.strides, 1)
            _, pl, pr = same_pads(W, self.kernel, self.strides, 1)
            return (pt, pb), (pl, pr)
        return self.padding


class QuantConv(Conv):
    """``Conv`` (no bias) with the JAX package's int8 inference path
    (``models/blocks.py:74-131``): the same parameter, the same float
    forward; inside ``ops/quant.recording`` an eligible call records its
    input's abs-max, inside ``ops/quant.quantized`` a calibrated eligible
    call runs s8×s8→s32 and returns the input's dtype."""

    quantizable = True

    def forward(self, x):
        p = quant.active()
        if p is not None:
            y = p.conv(self, x)
            if y is not None:
                return y
        return super().forward(x)


class DepthwiseConv(_Init, nn.Module):
    """Depthwise k×k conv, no bias, TF ``SAME`` padding, routed through the
    hand-written kernel (``kernels/depthwise.py``) on the card."""

    def __init__(self, channels: int, kernel: int = 3, strides: int = 1,
                 dilation=(1, 1), init_fn=glorot_uniform_):
        super().__init__()
        self.strides = strides
        self.dilation = (int(dilation[0]), int(dilation[1]))
        self.init_fn = init_fn
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel, kernel))

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)  # no-op in the model
        w = self.weight.to(x.dtype)
        if spatial.active():
            # the kernel on this rank's row window: the fetched rows, the
            # output rows and the padding rows above them (K2-K5's window)
            k, (dh, _) = w.shape[-1], self.dilation
            _, pt, pb = same_pads(spatial.global_height(x), k, self.strides, dh)
            return spatial.window_op(
                x, lambda xw, pad_t, ho: depthwise_conv(
                    xw.contiguous(memory_format=torch.channels_last), w, self.strides,
                    self.dilation, window=(ho, pad_t)),
                k=k, stride=self.strides, dilation=dh, pads_h=(pt, pb),
                out_width=-(-x.shape[-1] // self.strides), out_channels=x.shape[1], clip=True,
                deps=(w,))
        return depthwise_conv(x, w, self.strides, self.dilation)


_recompute = threading.local()


@contextlib.contextmanager
def running_stats_frozen():
    """Inside the block, ``BatchNorm`` in training mode normalises with the
    batch statistics as usual but leaves its running statistics alone.
    The activation-checkpointed backbone (``models/deeplab.py``, extra key
    ``remat``) runs its recompute in it, so the statistics move once a
    step, from the first forward, as under flax's ``nn.remat``.  Per
    thread: the recompute runs on the thread of the backward."""
    depth = getattr(_recompute, "depth", 0)
    _recompute.depth = depth + 1
    try:
        yield
    finally:
        _recompute.depth = depth


def _frozen() -> bool:
    return getattr(_recompute, "depth", 0) > 0


class BatchNorm(nn.Module):
    """Keras-compatible BatchNormalization (eps 1e-3; ``scale=False`` leaves
    out the multiplicative weight, as Keras ``scale=False`` does).

    Training normalises with the biased batch statistics (autograd flows
    through them) and sets running ← m·running + (1 − m)·batch, with the
    biased batch variance, as flax ``nn.BatchNorm`` does.

    A bfloat16 or float16 input is handled as ``flax.linen.normalization``
    handles it: the mean and the fast variance E[x²] − E[x]² (clipped at 0)
    in float32 from the input, the normalisation (x − mean)·(rsqrt(var +
    eps)·scale) + bias in float32, the result cast to the input's dtype.
    Parameters and running statistics stay float32.

    Under a process group of more than one rank, training takes that mean
    and fast variance over the rows of every rank (:class:`_RowBatchNorm`),
    in any dtype: flax's statistics over the global batch of a mesh.  The
    running statistics then move identically on every rank."""

    def __init__(self, channels: int, momentum: float = 0.99, epsilon: float = 1e-3,
                 scale: bool = True):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.register_parameter(
            "weight", nn.Parameter(torch.ones(channels)) if scale else None
        )
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        with span("dlv3.bn"):
            return self._forward(x)

    def _forward(self, x):
        if not self.training:
            # mixed types: a low-precision x is normalised in float32 and
            # the result rounded once, as flax's eval path
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.epsilon,
            )
        if x.dtype in _LOW_PRECISION or mesh.is_active():
            return self._train_rows(x)
        m = self.momentum
        if _frozen():
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, 1.0 - m, self.epsilon)
        # torch moves its running_var argument to m·old + (1 − m)·var·n/(n − 1);
        # hand it a copy (autograd keeps that one) and scale the batch term
        # by (n − 1)/n to leave the biased variance's
        moved = self.running_var.clone()
        y = F.batch_norm(
            x, self.running_mean, moved, self.weight, self.bias,
            True, 1.0 - m, self.epsilon,
        )
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * m
            self.running_var.copy_((moved - kept) * ((n - 1) / n) + kept)
        return y

    def _train_rows(self, x):
        # on the (N·H·W, C) rows of the channels_last memory (a view): the
        # per-channel vectors broadcast along the contiguous dimension
        B, C, H, W = x.shape
        y, mean, var = _RowBatchNorm.apply(
            x.permute(0, 2, 3, 1).reshape(-1, C), self.weight, self.bias, self.epsilon,
            mesh.is_active())
        if not _frozen():
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _RowBatchNorm(torch.autograd.Function):
    """flax's training BatchNorm of rows x (n, C): the mean and the fast
    variance E[x²] − E[x]² (clipped at 0) in at least float32, y =
    (x − mean)·(rsqrt(var + eps)·scale) + bias in that precision, cast to
    x's dtype.  Returns (y, mean, var).  Saves x in its own dtype and the
    per-channel statistics, not the intermediates autograd would keep; the
    gradient is that of the same function (d var/dx = 2(x − mean)/n for
    either variance formula), cast to x's dtype.

    ``sync``: the statistics are those of the rows of every rank of the
    process group, as flax's over a batch sharded on a mesh.  Each rank's
    count, mean and variance of its own rows cross ranks in one all-reduce
    (a float64 slot a rank) and combine as the parallel variance algorithm
    combines them, weighted by the counts (under ``mesh_space`` ranks hold
    unequal rows, or none): equal to flax's E[x²] − E[x]² in exact
    arithmetic, without its loss of digits to the mean, so N ranks agree
    with one process (torch's two-pass variance in float32/float64) to
    rounding.  The backward all-reduces Σg and Σg·x̂
    for dx, and keeps this rank's own sums as the scale and bias gradients,
    which the train step sums over ranks with every other gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, sync):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        C = x.shape[1]
        if sync:
            # every rank's (count, mean, variance) of its own rows, gathered
            # by one all-reduce of rank slots, combined by the counts
            slots = torch.zeros(mesh.world_size(), 1 + 2 * C, dtype=torch.float64,
                                device=x.device)
            slots[mesh.rank(), 0] = x.shape[0]
            if x.shape[0]:
                var_r, mean_r = torch.var_mean(xf, 0, correction=0)
                slots[mesh.rank(), 1:] = torch.cat([mean_r, var_r])
            mesh.all_reduce_(slots)
            total = slots[:, 0].sum()
            n = total.to(xf.dtype)  # a device scalar: no wait on the card
            share = (slots[:, :1] / total).to(xf.dtype)
            means, variances = slots[:, 1:].to(xf.dtype).split(C, 1)
            mean = (share * means).sum(0)
            var = (share * (variances + (means - mean).square())).sum(0)
        else:
            n = x.shape[0]
            mean = xf.mean(0)
            var = torch.clamp(xf.square().mean(0) - mean.square(), min=0.0)
        invstd = torch.rsqrt(var + eps)
        mul = invstd * weight if weight is not None else invstd
        y = ((xf - mean) * mul + bias).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n, ctx.sync = n, sync
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        g = gy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean) * invstd
        n = ctx.n
        dbias = g.sum(0)
        dscale = (g * xhat).sum(0)
        sum_g, sum_gx = dbias, dscale
        if ctx.sync:
            sum_g, sum_gx = mesh.all_reduce_(torch.cat([dbias, dscale])).split(x.shape[1])
        mul = invstd * weight if weight is not None else invstd
        dx = (g - sum_g / n - xhat * (sum_gx / n)) * mul
        return (dx.to(x.dtype), dscale if weight is not None else None, dbias, None, None)


class ConvBNReLU(nn.Module):
    """Conv(k, no bias) → BN → ReLU; ``l2`` names the conv ``conv_l2``."""

    def __init__(self, cin: int, features: int, kernel: int = 1, l2: bool = True,
                 bn_momentum: float = 0.99, bn_scale: bool = True):
        super().__init__()
        self.conv_name = "conv_l2" if l2 else "conv"
        self.add_module(self.conv_name, QuantConv(cin, features, kernel))
        self.bn = BatchNorm(features, bn_momentum, scale=bn_scale)

    def forward(self, x):
        return F.relu(self.bn(getattr(self, self.conv_name)(x)))


class SeparableConv(nn.Module):
    """Keras ``SeparableConv2D``: depthwise(k, dilation) → pointwise 1×1."""

    def __init__(self, cin: int, features: int, kernel: int = 3, dilation=(1, 1),
                 init_fn=glorot_uniform_):
        super().__init__()
        self.depthwise = DepthwiseConv(cin, kernel, 1, dilation, init_fn)
        self.pointwise = QuantConv(cin, features, 1, init_fn=init_fn)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class SplitSepConvBlock(nn.Module):
    """Encoder-middle 'conv' op with kernel > 1 (reference :823-840):
    SeparableConv(C, k, dilation)+BN+ReLU → 1×1 Conv(C, l2)+BN+ReLU, all
    kernels TruncatedNormal(0.05)."""

    def __init__(self, cin: int, features: int, kernel: int, dilation,
                 bn_momentum: float, bn_scale: bool):
        super().__init__()
        self.sepconv = SeparableConv(cin, features, kernel, dilation=dilation,
                                     init_fn=truncated_normal_05_)
        self.bn1 = BatchNorm(features, bn_momentum, scale=bn_scale)
        self.conv_l2 = QuantConv(features, features, 1, init_fn=truncated_normal_05_)
        self.bn2 = BatchNorm(features, bn_momentum, scale=bn_scale)

    def forward(self, x):
        x = F.relu(self.bn1(self.sepconv(x)))
        return F.relu(self.bn2(self.conv_l2(x)))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep each element with probability 1 − rate and
    scale it by 1/(1 − rate); the identity in eval mode or at rate 0.  The
    mask comes from an explicit generator on the input's device (or the
    streams of a :class:`~..parallel.mesh.RankDraws`).
    ``per_sample`` draws one keep for each sample, the whole (C, H, W) of it
    (flax ``broadcast_dims=(1, 2, 3)``: EfficientNet's stochastic depth)."""

    def __init__(self, rate: float, per_sample: bool = False):
        super().__init__()
        self.rate = float(rate)
        self.per_sample = per_sample

    def forward(self, x, generator: torch.Generator | mesh.RankDraws | None = None):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("dropout in training needs an explicit torch.Generator")
        keep = 1.0 - self.rate
        if isinstance(generator, mesh.RankDraws):
            if self.per_sample:
                u = torch.rand((generator.batch,), generator=generator.shared, device=x.device)
                mask = u[generator.rows].reshape(-1, 1, 1, 1) < keep
            else:
                mask = torch.rand(x.shape, generator=generator.local, device=x.device) < keep
            return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        shape = (x.shape[0], 1, 1, 1) if self.per_sample else x.shape
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv weight of ``module`` in registration order."""
    for m in module.modules():
        if isinstance(m, _Init):
            m.init_weights(generator)
