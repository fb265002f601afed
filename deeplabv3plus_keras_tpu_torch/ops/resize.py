"""Resizes (port of ``deeplabv3plus_keras_tpu/ops/resize.py:36-234``).

Two bilinear conventions, which must not be mixed up:

1. **Data-path resize** (:func:`affine_resize`): SciPy's
   ``affine_transform`` with ``order=1`` and matrix ``diag(in/out)``, a
   corner-anchored sample ``out[i, j] = in[i·h_in/h_out, j·w_in/w_out]``.
   ``'constant'`` mode zeroes a neighbour beyond the edge without
   renormalising; ``'nearest'`` clamps.  This is not ``F.interpolate``.
   :func:`resize_symmetric` is the reference's symmetric resize-and-pad
   with its quirks: the short side is truncated, an odd height pad puts
   the extra row at the bottom, an odd width pad the extra column on the
   left.

2. **In-model resize** (:func:`tf_resize_images`): TF2's half-pixel
   bilinear.  Only integer upscales occur in the model, and for those
   ``jax.image.resize(method='linear')`` and
   ``F.interpolate(mode='bilinear', align_corners=False)`` take the same
   taps and weights, edges clamped.  Tensors are NCHW (any memory format).
   Under ``mesh_space`` the in-model resizes run on a rank's rows: the
   source rows its output rows need are fetched and resized, and the rows
   it owns kept (``parallel/spatial.py`` ``resize_rows``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spatial


def _axis_coords(out_size: int, in_size: int, mode: str, device=None):
    """Neighbour indices and weights of one axis: ``(i0, i1, (w0, w1),
    valid)``, the sample being ``w0·x[i0] + w1·x[i1]`` (weights already
    zero a neighbour outside the image in ``'constant'`` mode) and
    ``valid`` masking samples whose source lies outside [0, in − 1]
    (``'nearest'``: none)."""
    scale = in_size / out_size  # corner-anchored: src = i · in/out
    src = torch.arange(out_size, dtype=torch.float32, device=device) * torch.tensor(
        scale, dtype=torch.float32)
    i0f = torch.floor(src)
    w1 = src - i0f
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1
    last = in_size - 1
    i0c, i1c = i0.clamp(0, last), i1.clamp(0, last)
    if mode == "nearest":
        return i0c, i1c, (1.0 - w1, w1), torch.ones(out_size, dtype=torch.bool, device=device)
    if mode == "constant":
        w0 = (1.0 - w1) * ((i0 >= 0) & (i0 <= last))
        w1v = w1 * ((i1 >= 0) & (i1 <= last))
        return i0c, i1c, (w0, w1v), (src >= 0) & (src <= in_size - 1 + 1e-6)
    raise ValueError(f"unknown boundary mode {mode!r}")


def affine_resize(image: torch.Tensor, out_h: int, out_w: int, mode: str = "constant") -> torch.Tensor:
    """Corner-anchored bilinear resize of an (H, W, C) tensor to
    (out_h, out_w, C) (SciPy ``affine_transform``, order 1; ``mode``
    ``'constant'`` fills zeros, ``'nearest'`` clamps).  The output keeps
    the input's dtype; integer inputs are rounded half to even."""
    in_h, in_w = image.shape[0], image.shape[1]
    img = image.to(torch.float32)
    y0, y1, (wy0, wy1), vy = _axis_coords(out_h, in_h, mode, image.device)
    x0, x1, (wx0, wx1), vx = _axis_coords(out_w, in_w, mode, image.device)
    col = img[y0] * wy0[:, None, None] + img[y1] * wy1[:, None, None]
    out = col[:, x0] * wx0[None, :, None] + col[:, x1] * wx1[None, :, None]
    if mode == "constant":
        out = out * (vy[:, None, None] & vx[None, :, None])
    if not image.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(image.dtype)


def symmetric_geometry(h, w, size: int):
    """Target geometry of the reference's symmetric resize:
    ``(h_p, w_p, pad_t, pad_l, pad_b, pad_r)``, the pads as applied (an odd
    width pad's extra column on the left).  Python ints give Python ints
    (the float64 arithmetic of the host path); integer tensors give tensors
    (the float32 arithmetic of the device path, elementwise)."""
    if not isinstance(h, torch.Tensor) and not isinstance(w, torch.Tensor):
        h, w = int(h), int(w)
        if w >= h:
            w_p = size
            h_p = int(h / w * size)
            pad = size - h_p
            pad_t, pad_b = pad // 2, pad - pad // 2  # extra row at the bottom
            pad_l = pad_r = 0
        else:
            h_p = size
            w_p = int(w / h * size)
            pad = size - w_p
            # the reference computes pad_l = pad//2, pad_r = pad//2 + 1 but
            # applies np.pad((pad_r, pad_l)): the extra column on the left
            pad_l, pad_r = pad - pad // 2, pad // 2
            pad_t = pad_b = 0
        return h_p, w_p, pad_t, pad_l, pad_b, pad_r
    h, w = torch.as_tensor(h).to(torch.int32), torch.as_tensor(w).to(torch.int32)
    wide = w >= h
    long_side = torch.maximum(h, w).to(torch.float32)
    short_side = torch.minimum(h, w).to(torch.float32)
    scaled_short = (short_side / long_side * size).to(torch.int32)  # truncates
    pad = size - scaled_short
    zero = torch.zeros_like(pad)
    h_p = torch.where(wide, scaled_short, size)
    w_p = torch.where(wide, size, scaled_short)
    pad_t = torch.where(wide, pad // 2, zero)
    pad_b = torch.where(wide, pad - pad // 2, zero)
    pad_l = torch.where(wide, zero, pad - pad // 2)
    pad_r = torch.where(wide, zero, pad // 2)
    return h_p, w_p, pad_t, pad_l, pad_b, pad_r


def resize_symmetric(image: torch.Tensor, size: int):
    """The reference's ``resize_image_to_target_symmeric_size`` on an
    (H, W, C) tensor: ``(image_p, w, h, pad_t, pad_l, pad_b, pad_r)`` with
    the reference's return convention (the width branch reports
    pad_l = pad//2, pad_r = pad//2 + 1, though it applies them swapped)."""
    h, w = int(image.shape[0]), int(image.shape[1])
    h_p, w_p, pad_t, pad_l, pad_b, pad_r = symmetric_geometry(h, w, size)
    resized = affine_resize(image, h_p, w_p, mode="nearest")
    out = F.pad(resized, (0, 0, pad_l, pad_r, pad_t, pad_b))
    return out, w, h, pad_t, pad_r, pad_b, pad_l


def tf_resize_images(x: torch.Tensor, height_factor: int, width_factor: int) -> torch.Tensor:
    """``K.resize_images(..., 'bilinear')`` for integer factors.

    In bfloat16 and float16 the JAX package's ``jax.image.resize`` is an
    einsum of x with the two interpolation matrices, held in the dtype:
    two contractions, each rounded to the dtype, in the order opt_einsum's
    greedy path takes (the one whose result is smaller for the matrix it
    removes; the rows first on a square map).  The port contracts in that
    order, so it rounds where JAX does."""
    if spatial.active():
        return _rows(_tf_resize_images, x, height_factor, width_factor)
    return _tf_resize_images(x, height_factor, width_factor)


def _rows(fn, x: torch.Tensor, height_factor: int, width_factor: int) -> torch.Tensor:
    """``fn`` (a resize) of a row-sharded x: this rank's output rows."""
    if int(height_factor) != int(width_factor):
        raise ValueError(f"mesh_space: resize factors {height_factor} x {width_factor} of a "
                         "square map must be equal")
    return spatial.resize_rows(x, int(height_factor), lambda b: fn(b, height_factor, width_factor),
                               out_width=x.shape[-1] * int(width_factor), out_channels=x.shape[1])


def _tf_resize_images(x: torch.Tensor, height_factor: int, width_factor: int) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float16):
        return F.interpolate(
            x, scale_factor=(int(height_factor), int(width_factor)),
            mode="bilinear", align_corners=False, antialias=False,
        )
    n, h, w = x.shape[0] * x.shape[1], x.shape[-2], x.shape[-1]
    H, W = h * int(height_factor), w * int(width_factor)
    if n * H * w - H * h <= n * h * W - W * w:  # rows first: the matmul form
        return _tf_resize_images_matmul(x, height_factor, width_factor)
    ah = interpolation_matrix(h, height_factor, x.dtype, x.device)
    aw = interpolation_matrix(w, width_factor, x.dtype, x.device)
    return torch.einsum("Hh,bchW->bcHW", ah, torch.einsum("Ww,bchw->bchW", aw, x))


def interpolation_matrix(n: int, factor: int, dtype, device) -> torch.Tensor:
    """(n·factor, n) operator of a ×factor half-pixel bilinear resize: row i
    holds the ≤2 weights of output tap i (the resize of an identity)."""
    eye = torch.eye(n, dtype=torch.float32, device=device)[None, None]
    a = F.interpolate(
        eye, size=(n * int(factor), n), mode="bilinear", align_corners=False
    )
    return a[0, 0].to(dtype)


def tf_resize_images_matmul(x: torch.Tensor, height_factor: int, width_factor: int) -> torch.Tensor:
    """:func:`tf_resize_images` as two interpolation-matrix contractions
    (the JAX package's form for the pyramid-pooling branch and the fp32
    final upsample); the same ≤2-tap sums, operators built in fp32."""
    if spatial.active():
        return _rows(_tf_resize_images_matmul, x, height_factor, width_factor)
    return _tf_resize_images_matmul(x, height_factor, width_factor)


def _tf_resize_images_matmul(x: torch.Tensor, height_factor: int, width_factor: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    ah = interpolation_matrix(h, height_factor, x.dtype, x.device)
    aw = interpolation_matrix(w, width_factor, x.dtype, x.device)
    y = torch.einsum("Hh,bchw->bcHw", ah, x)
    return torch.einsum("Ww,bcHw->bcHW", aw, y)
