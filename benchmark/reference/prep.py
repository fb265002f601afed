"""Preprocessing of one decoded VOC sample, as the Keras reference does it
on the host (SciPy semantics), in float64.

- The image is normalised, 2·(x/255 − 0.5).
- Its long side is resized to ``size`` by a corner-anchored bilinear
  sample (SciPy ``affine_transform``, order 1, matrix diag(in/out), edges
  clamped); the short side to int(short/long·size), truncated.
- It is zero padded to size × size: an odd height pad puts the extra row
  at the bottom, an odd width pad the extra column on the left.
- Labels above C − 1 (VOC's 255 border) become 0 before the resize; the
  label map is resized as the image is, rounded half to even, clamped
  again and one-hot encoded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def geometry(h: int, w: int, size: int) -> tuple[int, int, int, int]:
    """(h_p, w_p, pad_top, pad_left) of an h × w sample."""
    if w >= h:
        h_p, w_p = int(h / w * size), size
        return h_p, w_p, (size - h_p) // 2, 0
    h_p, w_p = size, int(w / h * size)
    pad = size - w_p
    return h_p, w_p, 0, pad - pad // 2


def _axis(n_in: int, n_out: int, device):
    src = torch.arange(n_out, dtype=torch.float64, device=device) * (n_in / n_out)
    i0 = torch.floor(src)
    w1 = src - i0
    i0 = i0.long().clamp(0, n_in - 1)
    return i0, (i0 + 1).clamp(0, n_in - 1), w1


def _resize(x: torch.Tensor, h_p: int, w_p: int) -> torch.Tensor:
    """(H, W, C) float64 → (h_p, w_p, C), corner-anchored, clamped."""
    y0, y1, wy = _axis(x.shape[0], h_p, x.device)
    x0, x1, wx = _axis(x.shape[1], w_p, x.device)
    col = x[y0] * (1.0 - wy)[:, None, None] + x[y1] * wy[:, None, None]
    return col[:, x0] * (1.0 - wx)[None, :, None] + col[:, x1] * wx[None, :, None]


def prepare(image: np.ndarray, label: np.ndarray, size: int, num_classes: int, device):
    """(H, W, 3) uint8 image and (H, W) uint8 label → (size, size, 3)
    float32 image in (−1, 1) and (size, size, C) float32 one-hot."""
    h, w = image.shape[:2]
    h_p, w_p, pt, pl = geometry(h, w, size)
    pads = (0, 0, pl, size - w_p - pl, pt, size - h_p - pt)
    img = torch.as_tensor(np.array(image), device=device).to(torch.float64)
    img = 2.0 * (img / 255.0 - 0.5)
    img = F.pad(_resize(img, h_p, w_p), pads)
    lab = torch.as_tensor(np.array(label), device=device).to(torch.float64)
    lab = torch.where(lab > num_classes - 1, 0.0, lab)
    lab = torch.round(_resize(lab[..., None], h_p, w_p))
    lab = torch.where(lab > num_classes - 1, 0.0, lab)
    lab = F.pad(lab, pads)[..., 0].long()
    return img.to(torch.float32), F.one_hot(lab, num_classes).to(torch.float32)


def decode(image_path: str, label_path: str) -> tuple[np.ndarray, np.ndarray]:
    """A JPEG image as RGB uint8 and a PNG label map as uint8."""
    from PIL import Image

    with Image.open(image_path) as im:
        img = np.asarray(im.convert("RGB"), np.uint8)
    with Image.open(label_path) as lb:
        lab = np.asarray(lb, np.uint8)
    if lab.ndim == 3:
        lab = lab[..., 0]
    return img, lab
