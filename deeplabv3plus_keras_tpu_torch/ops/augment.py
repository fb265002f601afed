"""On-device train-time augmentation (port of
``deeplabv3plus_keras_tpu/ops/augment.py:45-185``).

A random horizontal flip and a random scale with a crop or a placement,
as one resample with a fixed output shape (S, S):

    out(y, x) = in((y − ty) / z, (x − tx) / z)

with per-sample zoom ``z`` and offset t = u·(S − S·z), u ∈ [0, 1]: for
z > 1 a random crop of the enlarged image, for z < 1 the shrunk image at a
random place, the outside filled (images with 0.0, the letterbox pad's
value after normalisation; labels with class 0).  Images are sampled
bilinearly, labels by nearest neighbour (rounded half to even), so a label
map never gains a class.

Config (extra key ``augment``; absent means off):

    "augment": true                      → flip + scale [0.5, 2.0]
    "augment": {"random_flip": true,     → each part on its own
                "scale_range": [0.75, 1.25]}

The port cannot reproduce ``jax.random``: :func:`sample_params` draws from
a ``torch.Generator``, and :func:`apply_augment` of the same parameters
equals the JAX package's.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F


def parse_augment_conf(value: Any):
    """The ``augment`` value → (flip, scale_range), or None when off;
    scale_range is None for flip alone."""
    if not value:
        return None
    flip, scale_range = True, (0.5, 2.0)
    if isinstance(value, dict):
        flip = bool(value.get("random_flip", True))
        sr = value.get("scale_range", (0.5, 2.0))
        scale_range = None if sr in (None, False) else (float(sr[0]), float(sr[1]))
        if scale_range is not None:
            lo, hi = scale_range
            if not (0.0 < lo <= hi):
                raise ValueError(f"augment scale_range must be 0 < lo <= hi, got {sr}")
    if not flip and scale_range is None:
        return None
    return flip, scale_range


def sample_params(generator: torch.Generator, batch: int, flip: bool, scale_range) -> dict:
    """Per-sample parameters drawn from ``generator`` on its device: (B,)
    tensors ``flip`` (bool), ``z`` (zoom) and ``uy``/``ux`` (the unit
    offsets, t = u·(S − S·z) at apply time)."""
    dev = generator.device
    do_flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    if not flip:
        do_flip = torch.zeros_like(do_flip)
    z = torch.rand(batch, generator=generator, device=dev)
    if scale_range is not None:
        lo, hi = scale_range
        z = lo + (hi - lo) * z
    else:
        z = torch.ones_like(z)
    uy = torch.rand(batch, generator=generator, device=dev)
    ux = torch.rand(batch, generator=generator, device=dev)
    return {"flip": do_flip, "z": z, "uy": uy, "ux": ux}


def _axis_coords(size: int, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(B, size) source coordinates src = (idx − t)/z, t = u·(size − size·z)."""
    t = u * (size - size * z)
    idx = torch.arange(size, dtype=torch.float32, device=z.device)
    return (idx[None] - t[:, None]) / z[:, None]


def _lerp_indices(src: torch.Tensor, n: int):
    i0f = torch.floor(src)
    w1 = src - i0f
    i0 = i0f.long().clamp(0, n - 1)
    return i0, (i0 + 1).clamp(0, n - 1), w1


def _resample_image(img: torch.Tensor, z, uy, ux) -> torch.Tensor:
    """Bilinear resample of (B, H, W, C) images to (B, H, H, C); outside
    fills 0.0.  Both axes are sampled at S = H, as JAX samples them: where
    W < H the column gather's indices clamp to W − 1, as JAX's
    out-of-range gathers do (the square path is unchanged)."""
    B, S, W, C = img.shape
    sy, sx = _axis_coords(S, z, uy), _axis_coords(S, z, ux)
    vy = (sy >= 0.0) & (sy <= S - 1.0)
    vx = (sx >= 0.0) & (sx <= S - 1.0)
    y0, y1, wy = _lerp_indices(sy, S)
    x0, x1, wx = _lerp_indices(sx, S)

    def rows(i):
        return torch.gather(img, 1, i[:, :, None, None].expand(B, S, W, C))

    col = rows(y0) * (1.0 - wy)[:, :, None, None] + rows(y1) * wy[:, :, None, None]

    def cols(i):
        return torch.gather(col, 2, i.clamp(max=W - 1)[:, None, :, None].expand(B, S, S, C))

    out = cols(x0) * (1.0 - wx)[:, None, :, None] + cols(x1) * wx[:, None, :, None]
    return out * (vy[:, :, None] & vx[:, None, :])[..., None]


def _resample_label(lab: torch.Tensor, z, uy, ux) -> torch.Tensor:
    """Nearest-neighbour resample of (B, H, W) integer labels to (B, H, H)
    (columns clamped to W − 1, as :func:`_resample_image`'s); outside
    fills class 0."""
    B, S, W = lab.shape
    sy, sx = _axis_coords(S, z, uy), _axis_coords(S, z, ux)
    iy = torch.round(sy).long().clamp(0, S - 1)
    ix = torch.round(sx).long().clamp(0, min(S, W) - 1)
    valid = ((sy >= -0.5) & (sy <= S - 0.5))[:, :, None] & ((sx >= -0.5) & (sx <= S - 0.5))[:, None, :]
    out = torch.gather(lab, 1, iy[:, :, None].expand(B, S, W))
    out = torch.gather(out, 2, ix[:, None, :].expand(B, S, S))
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def apply_augment(image: torch.Tensor, label: torch.Tensor | None, params: dict):
    """Apply sampled parameters to a batch: image (B, H, W, 3) float; label
    one-hot (B, H, W, C) float, integer (B, H, W), or None.  The result is
    H × H, as the JAX function's (S = H on both axes).  One-hot labels go
    through as their integer form (argmax is exact on a one-hot) and are
    encoded again at the end."""
    flip = params["flip"]
    z, uy, ux = params["z"], params["uy"], params["ux"]
    image = torch.where(flip[:, None, None, None], image.flip(2), image)
    image = _resample_image(image, z, uy, ux)
    if label is None:
        return image, None
    one_hot = label.dim() == 4
    lab = label.argmax(-1).to(torch.int32) if one_hot else label
    lab = torch.where(flip[:, None, None], lab.flip(2), lab)
    lab = _resample_label(lab, z, uy, ux)
    if one_hot:
        lab = F.one_hot(lab.long(), label.shape[-1]).to(label.dtype)
    return image, lab


def augment_batch(image, label, generator: torch.Generator, *, flip: bool = True,
                  scale_range=(0.5, 2.0), rows: torch.Tensor | None = None,
                  batch: int | None = None):
    """Draw per-image parameters from ``generator`` and apply them.  Under a
    process group ``image`` holds one rank's ``rows`` (a device index
    tensor) of a global batch of ``batch``: the parameters are drawn for the
    whole global batch, as one process draws them, and the rank applies
    its rows'."""
    params = sample_params(generator, image.shape[0] if batch is None else batch, flip,
                           scale_range)
    if rows is not None:
        params = {k: v[rows] for k, v in params.items()}
    return apply_augment(image, label, params)
