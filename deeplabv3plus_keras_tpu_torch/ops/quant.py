"""Post-training int8 quantization of the wide convolutions (port of
``deeplabv3plus_keras_tpu/ops/quant.py``).

The reference ships a quantizing deployment (its TFLite converter,
semantic_segmentation.py:1189-1205); the JAX package serves its on-device
counterpart, and so does this module: inference-only int8 convolution as
an s8×s8→s32 product, dequantized to float.

Scheme (the JAX package's, to the bit):

- weights: symmetric per-output-channel int8, scales folded from the
  float32 master weights on every call: s_w = max(absmax_c, 1e-12)/127,
  w_q = clip(round(w / s_w), ±127), ``round`` half to even;
- activations: symmetric per-tensor int8 from a calibrated abs-max,
  quantized from float32 whatever the compute dtype;
- y = y_s32 · (s_x · s_w[c]), in that order.  Zero padding is exact,
  since q(0) = 0.

On the card the product is ``torch._int_mm`` (cuBLASLt's int8 GEMM, the
H100's 1,979 dense int8 TOPS): a 1×1 conv is (B·H·W, Cin) × (Cin, Cout), a
k×k conv an im2col of the int8 activations, then the same product.  The
JAX package leaves this product to XLA (``lax.conv_general_dilated`` with
``preferred_element_type=int32``), not to a Pallas kernel.  ``_int_mm``
wants more than 16 rows and K, N multiples of 8: the rows are padded, and
an eligible site that cannot meet K or N raises naming the site.  On the
CPU the same product is an exact integer product in float64 (the plain
version; every partial sum is an integer below 2⁵³).  A
quantized site never computes in float on the card.

Which convolutions quantize is decided per call (``models/blocks.py``
``QuantConv``), as the JAX package decides per apply:

- inside :func:`recording` (a calibration pass): each site that is
  :func:`eligible` at this call's shape records the running maximum of
  its input's abs-max, and computes in float;
- inside :func:`quantized`: a site runs int8 when it has a range *and* is
  eligible at this call's shape (test-time augmentation's scales change
  the pixel count), else float;
- outside both: float.  Training never enters either, so it never reads
  the ranges; they live outside the model's ``state_dict``, keyed by the
  module's qualified name (the JAX ``quant`` collection's path joined with
  ``.``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from ..kernels import same_pads
from ..parallel import mesh, spatial

# Both channel counts must reach this for a conv to quantize; the JAX
# package measured it on a TPU v5e (one MXU tile side).  No H100 number
# moved it: chip_smoke.py's int8 phase times both gate edges on the card.
MIN_QUANT_CHANNELS = 128

# Spatial gate: a site with more than this many positions stays float (the
# per-tensor quantize and dequantize passes grow with H·W).  None disables
# it.  The JAX package's value, measured on a TPU v5e.
MAX_QUANT_PIXELS: int | None = 4096

# int8 convolutions run since the last reset (not a kernel of the port:
# the product is a library GEMM), by where they ran; and the calls of each
# site (its qualified name) that took the int8 path, on every rank of a
# space split alike
counts = {"int8_conv": 0}
sites: dict[str, int] = {}


def reset_counts() -> None:
    counts["int8_conv"] = 0
    sites.clear()


def eligible(cin: int, cout: int, pixels: int | None = None) -> bool:
    """Does a conv with these channel counts (and, when known, this many
    spatial positions) quantize?"""
    if min(int(cin), int(cout)) < MIN_QUANT_CHANNELS:
        return False
    if pixels is not None and MAX_QUANT_PIXELS is not None:
        return int(pixels) <= MAX_QUANT_PIXELS
    return True


def _over_127(a: torch.Tensor) -> torch.Tensor:
    """a / 127, correctly rounded on every device: PyTorch's CUDA division
    by a Python number multiplies by its reciprocal instead, one ulp off
    the CPU's (and JAX's) quotient now and then."""
    return a / torch.full((), 127.0, device=a.device)


def quantize_weight_per_channel(w: torch.Tensor):
    """Symmetric per-output-channel int8 of an OIHW weight: (w_q int8 OIHW,
    scale (O,) float32)."""
    w = w.float()
    scale = _over_127(torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12))
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -127.0, 127.0)
    return wq.to(torch.int8), scale


def quantize_activation(x: torch.Tensor, absmax: torch.Tensor):
    """Symmetric per-tensor int8 from a calibrated abs-max, from float32:
    (x_q int8, scale () float32)."""
    scale = _over_127(torch.clamp(absmax.float().to(x.device), min=1e-12))
    xq = torch.clamp(torch.round(x.float() / scale), -127.0, 127.0)
    return xq.to(torch.int8), scale


def _pads(H: int, W: int, k: int, stride: int, padding):
    """(top, bottom, left, right) of TF ``SAME``, ``VALID`` or explicit
    ``((top, bottom), (left, right))`` padding, as ``blocks.Conv`` pads."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding == "SAME":
        _, pt, pb = same_pads(H, k, stride, 1)
        _, pl, pr = same_pads(W, k, stride, 1)
        return pt, pb, pl, pr
    (pt, pb), (pl, pr) = padding
    return pt, pb, pl, pr


def _patches(xq: torch.Tensor, k: int, stride: int, pads) -> torch.Tensor:
    """im2col of NHWC ``xq``: (B, Ho, Wo, k·k·C), taps in (kh, kw, c)
    order, zero padded (q(0) = 0)."""
    pt, pb, pl, pr = pads
    if any(pads):
        xq = F.pad(xq, (0, 0, pl, pr, pt, pb))
    Ho = (xq.shape[1] - k) // stride + 1
    Wo = (xq.shape[2] - k) // stride + 1
    taps = [xq[:, i:i + (Ho - 1) * stride + 1:stride, j:j + (Wo - 1) * stride + 1:stride]
            for i in range(k) for j in range(k)]
    return taps[0] if k == 1 else torch.cat(taps, dim=-1)


def int8_product(a: torch.Tensor, wq: torch.Tensor, site: str = "") -> torch.Tensor:
    """(M, K) int8 × (N, K)ᵀ int8 → (M, N) int32, exactly.  On the card
    ``torch._int_mm`` (rows padded past 16; K and N must be multiples of
    8, else it raises naming ``site``); on the CPU a float64 matmul, exact
    for integers: every product and partial sum is an integer of magnitude
    below K·127² < 2⁵³ (an int64 matmul takes a second a site on the
    CPU, float64's BLAS milliseconds)."""
    if not a.is_cuda:
        return (a.double() @ wq.double().t()).to(torch.int32)
    M, K = a.shape
    N = wq.shape[0]
    if K % 8 or N % 8:
        raise ValueError(
            f"int8 site {site}: K={K}, N={N}; torch._int_mm needs both to be "
            "multiples of 8 (no float fallback on the card)")
    if M <= 16:
        a = F.pad(a, (0, 0, 0, 17 - M))
    out = torch._int_mm(a.contiguous(), wq.t())
    return out[:M] if M <= 16 else out


def int8_conv(x: torch.Tensor, w: torch.Tensor, in_absmax: torch.Tensor, *,
              strides: int = 1, padding="SAME", site: str = "") -> torch.Tensor:
    """Quantized conv of NCHW ``x`` by OIHW ``w``: s8×s8→s32, dequantized
    to float32 (NCHW in ``channels_last`` memory).  ``in_absmax`` is the
    calibrated activation range (a scalar tensor)."""
    counts["int8_conv"] += 1
    O, _, k, _ = w.shape
    B, _, H, W = x.shape
    xq, sx = quantize_activation(x, in_absmax)
    wq, sw = quantize_weight_per_channel(w)
    cols = _patches(xq.permute(0, 2, 3, 1), k, strides, _pads(H, W, k, strides, padding))
    _, Ho, Wo, K = cols.shape
    acc = int8_product(cols.reshape(B * Ho * Wo, K), wq.permute(0, 2, 3, 1).reshape(O, K), site)
    y = acc.float() * (sx * sw)
    return y.reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


class _Pass:
    """One calibration (``record``) or quantized pass over ``model``."""

    def __init__(self, model: torch.nn.Module, ranges: dict, record: bool):
        self.names = {m: n for n, m in model.named_modules() if getattr(m, "quantizable", False)}
        self.ranges, self.record = ranges, record

    def conv(self, module, x: torch.Tensor) -> torch.Tensor | None:
        """The site's int8 result, or None where it computes in float.
        Under ``mesh_space`` the gate reads the image's pixels (the global
        height, as the JAX gate reads its traced global shape), a shard
        with no rows records a range of 0, and the product runs on the
        rank's row window."""
        name = self.names.get(module)
        cout, cin = module.weight.shape[:2]
        grid = spatial.active()
        H = spatial.global_height(x) if grid else x.shape[-2]
        if name is None or not eligible(cin, cout, H * x.shape[-1]):
            return None
        if self.record:
            amax = (x.detach().abs().amax().float() if x.numel()
                    else x.new_zeros((), dtype=torch.float32))
            prev = self.ranges.get(name)
            self.ranges[name] = amax if prev is None else torch.maximum(prev, amax)
            return None
        amax = self.ranges.get(name)
        if amax is None:
            return None
        sites[name] = sites.get(name, 0) + 1
        w, k, stride = module.weight, module.kernel, module.strides
        if grid is None:
            y = int8_conv(x, w, amax, strides=stride, padding=module.padding, site=name)
        else:
            pt, pb, pl, pr = _pads(H, x.shape[-1], k, stride, module.padding)
            y = spatial.window_op(
                x, lambda xw: int8_conv(xw, w, amax, strides=stride,
                                        padding=((0, 0), (pl, pr)), site=name),
                k=k, stride=stride, pads_h=(pt, pb),
                out_width=(x.shape[-1] + pl + pr - k) // stride + 1, out_channels=cout)
        return y.to(x.dtype)


_active = threading.local()


def active() -> _Pass | None:
    """The pass the current thread is in, if any."""
    return getattr(_active, "pass_", None)


@contextlib.contextmanager
def _entered(p: _Pass):
    prev = active()
    _active.pass_ = p
    try:
        yield p
    finally:
        _active.pass_ = prev


def recording(model: torch.nn.Module, ranges: dict):
    """Calibration: ``model``'s eligible sites record their input's abs-max
    into ``ranges`` (running max) and compute in float."""
    return _entered(_Pass(model, ranges, record=True))


def quantized(model: torch.nn.Module, ranges: dict):
    """Inference: ``model``'s calibrated sites that are eligible at the
    call's shape run int8."""
    return _entered(_Pass(model, ranges, record=False))


def calibrate(model: torch.nn.Module, batches) -> dict[str, torch.Tensor]:
    """Run ``batches`` of images (B, H, W, 3) through ``model`` in eval
    mode recording the eligible sites' activation abs-max (a running max
    over the batches); returns the ranges {site name: float32 scalar} for
    :func:`quantized`.  Under a process group the ranges are the maximum
    over every rank's batches, so N ranks quantize as one process does;
    under ``mesh_space`` the batches are whole images, whose rows each
    rank cuts.
    (The JAX function's ``train`` flag, BN on batch statistics, has no
    caller outside the JAX package's own tests, and is not ported.)"""
    device = next(model.parameters()).device
    ranges: dict[str, torch.Tensor] = {}
    was_training = model.training
    model.eval()
    n = 0
    grid = spatial.active()
    try:
        with torch.inference_mode(), recording(model, ranges):
            for images in batches:
                x = torch.as_tensor(images, device=device)
                H, W = x.shape[1], x.shape[2]
                if grid is not None:  # the rank's image rows, as the steps cut them
                    x = x[:, slice(*grid.rows_of(H))]
                with spatial.use_heights({W: H}):
                    model(x)
                n += 1
    finally:
        model.train(was_training)
    if not n:
        raise ValueError("calibrate() needs at least one batch")
    if not ranges:
        raise ValueError(
            "no quantizable conv in this model: every site is below "
            f"MIN_QUANT_CHANNELS={MIN_QUANT_CHANNELS} channels or above "
            f"MAX_QUANT_PIXELS={MAX_QUANT_PIXELS} positions; int8_infer gains nothing "
            "here — unset it")
    return _max_over_ranks(ranges, device)


def _max_over_ranks(ranges: dict, device) -> dict[str, torch.Tensor]:
    """Each range's maximum over the ranks (one all-reduce of rank slots:
    the group's collectives are sums)."""
    names = sorted(ranges)
    if not mesh.is_active():
        return {n: ranges[n].clone() for n in names}
    slots = torch.zeros(mesh.world_size(), len(names), dtype=torch.float32, device=device)
    slots[mesh.rank()] = torch.stack([ranges[n] for n in names])
    top = mesh.all_reduce_(slots).amax(0)
    return {n: top[i].clone() for i, n in enumerate(names)}
