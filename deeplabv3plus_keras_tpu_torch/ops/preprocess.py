"""Image and label preprocessing (port of
``deeplabv3plus_keras_tpu/ops/preprocess.py:31-289``).

The host decodes JPEG/PNG into fixed-size uint8 canvases and records each
sample's true (h, w); :func:`prepare_batch` then does all the arithmetic
on the canvases' device: the corner-anchored bilinear scale of the long
side to ``size`` (SciPy semantics, clamped edges), the symmetric zero pad
with the reference's odd-pad quirks, the (−1, 1) normalisation
``2·(x/255 − 0.5)``, the label clamp ``label[label > C − 1] = 0`` (VOC's
ignore id 255 becomes background) and the one-hot.

:func:`host_symmetric_downscale` and :func:`host_prepare_sample` are the
host SciPy path (``prepro_device == -1``), the reference's own per-sample
pipeline.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .resize import symmetric_geometry


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """``2·(x/255 − 0.5)`` in float32."""
    return 2.0 * (image.to(torch.float32) / 255.0 - 0.5)


def clamp_label(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``label[label > num_classes − 1] = 0``."""
    return torch.where(label > num_classes - 1, torch.zeros_like(label), label)


def one_hot(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(…, H, W) or (…, H, W, 1) integer labels → float32 (…, H, W, C)."""
    if label.shape[-1] == 1 and label.dim() >= 3:
        label = label[..., 0]
    return F.one_hot(label.long(), num_classes).to(torch.float32)


def _dynamic_axis_sample(canvas_len: int, out_size: int, in_size: torch.Tensor,
                         target_len: torch.Tensor):
    """Corner-anchored gather indices and weights of one axis for each
    sample, where the true extent ``in_size`` (B,) and the scaled extent
    ``target_len`` (B,) are device tensors and the buffers static.
    Positions ≥ target_len are dead (the pad masks them); their indices
    are clamped to stay in range."""
    scale = in_size.to(torch.float32) / torch.clamp(target_len, min=1).to(torch.float32)
    src = torch.arange(out_size, dtype=torch.float32, device=in_size.device)[None] * scale[:, None]
    i0f = torch.floor(src)
    w1 = src - i0f
    last = (in_size - 1)[:, None].long()
    zero = torch.zeros_like(last)
    i0 = torch.clamp(i0f.long(), zero, last)
    i1 = torch.clamp(i0 + 1, zero, last)
    return i0.clamp(0, canvas_len - 1), i1.clamp(0, canvas_len - 1), w1


def _shifted(index: torch.Tensor, pad: torch.Tensor, size: int) -> torch.Tensor:
    """For each output position r of each sample, the resized position it
    shows after a shift by ``pad``: clip(r − pad, 0, size − 1)."""
    r = torch.arange(size, device=pad.device)[None]
    return torch.gather(index, 1, torch.clamp(r - pad[:, None].long(), 0, size - 1))


def _resize_pad_canvas(canvas: torch.Tensor, sizes: torch.Tensor, size: int) -> torch.Tensor:
    """Resize the (h, w) region at the origin of each (CH, CW, C) float32
    canvas of a batch (B, CH, CW, C) to the symmetric target (B, size,
    size, C): long side → ``size`` (corner-anchored bilinear, clamped
    edges), short side scaled and truncated, the zero pad split with the
    extra row at the bottom and the extra column on the left."""
    B, ch, cw, C = canvas.shape
    h, w = sizes[:, 0], sizes[:, 1]
    h_p, w_p, pad_t, pad_l, _, _ = symmetric_geometry(h, w, size)
    y0, y1, wy = _dynamic_axis_sample(ch, size, h, h_p)
    x0, x1, wx = _dynamic_axis_sample(cw, size, w, w_p)
    # the pad's shift, composed into the gathers: output (r, c) shows the
    # resized sample (clip(r − pad_t), clip(c − pad_l))
    y0, y1, wy = (_shifted(t, pad_t, size) for t in (y0, y1, wy))
    x0, x1, wx = (_shifted(t, pad_l, size) for t in (x0, x1, wx))

    def rows(i):
        return torch.gather(canvas, 1, i[:, :, None, None].expand(B, size, cw, C))

    col = rows(y0) * (1.0 - wy)[:, :, None, None] + rows(y1) * wy[:, :, None, None]

    def cols(i):
        return torch.gather(col, 2, i[:, None, :, None].expand(B, size, size, C))

    resized = cols(x0) * (1.0 - wx)[:, None, :, None] + cols(x1) * wx[:, None, :, None]
    r = torch.arange(size, device=canvas.device)
    vy = (r[None] >= pad_t[:, None]) & (r[None] < (pad_t + h_p)[:, None])
    vx = (r[None] >= pad_l[:, None]) & (r[None] < (pad_l + w_p)[:, None])
    return resized * (vy[:, :, None] & vx[:, None, :])[..., None]


def prepare_batch(image_canvas: torch.Tensor, image_sizes: torch.Tensor,
                  label_canvas: torch.Tensor | None = None, *, size: int,
                  num_classes: int = 21, with_labels: bool = True,
                  one_hot_labels: bool = True):
    """Batched preprocessing on the canvases' device.

    image_canvas (B, CH, CW, 3) uint8, pixels at the origin; image_sizes
    (B, 2) int32, each sample's true (h, w); label_canvas (B, CH, CW) uint8
    label ids, or None.  Returns (images (B, size, size, 3) float32 in
    (−1, 1), labels: one-hot float32 (B, size, size, num_classes), int32
    (B, size, size) when ``one_hot_labels`` is false, or None).

    Labels are clamped before the resize, resized through float as the
    image is, rounded half to even, and clamped again."""
    images = _resize_pad_canvas(normalize_image(image_canvas), image_sizes, size)
    labels = None
    if with_labels and label_canvas is not None:
        lab = clamp_label(label_canvas, num_classes).to(torch.float32)
        lab = _resize_pad_canvas(lab[..., None], image_sizes, size)[..., 0]
        lab = clamp_label(torch.round(lab).to(torch.int32), num_classes)
        labels = one_hot(lab, num_classes) if one_hot_labels else lab
    return images, labels


def prepare_batch_from_cache(data_img: torch.Tensor, data_lab: torch.Tensor | None,
                             data_sizes: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, *,
                             size: int, num_classes: int = 21, with_labels: bool = True,
                             one_hot_labels: bool = True):
    """A batch of the device-resident dataset (``data/pipeline.py``
    ``DeviceDataset``): the rows ``idx`` (B,) of data_img (N, CH, CW, 3)
    uint8, data_lab (N, CH, CW) uint8 or None and data_sizes (N, 2) int32,
    gathered on their device, then :func:`prepare_batch`.

    Rows whose ``valid`` is 0 (the padded tail of an epoch) are zeroed with
    sizes (1, 1), exactly the streaming path's pre-zeroed canvases, so the
    tail's BN statistics and the histories equal the streaming path's."""
    v = valid.to(torch.uint8)
    img = data_img.index_select(0, idx).mul_(v[:, None, None, None])
    sizes = torch.where(v[:, None].bool(), data_sizes.index_select(0, idx), 1)
    lab = None
    if with_labels and data_lab is not None:
        lab = data_lab.index_select(0, idx).mul_(v[:, None, None])
    return prepare_batch(img, sizes, lab, size=size, num_classes=num_classes,
                         with_labels=with_labels, one_hot_labels=one_hot_labels)


# ---------------------------------------------------------------------------
# The host SciPy path (prepro_device == -1)
# ---------------------------------------------------------------------------

def _scipy_resize(arr: np.ndarray, h_p: int, w_p: int) -> np.ndarray:
    """SciPy's corner-anchored order-1 resize of an (H, W, C) array to
    (h_p, w_p, C), clamped edges."""
    from scipy import ndimage

    m = np.eye(4)
    m[0, 0] = arr.shape[0] / float(h_p)
    m[1, 1] = arr.shape[1] / float(w_p)
    return ndimage.affine_transform(
        arr, m[0:3], order=1, output_shape=(h_p, w_p, arr.shape[2]), mode="nearest")


def host_symmetric_downscale(image, label, size: int, num_classes: int | None = None):
    """Symmetric resize on the host of an image larger than the canvas to
    its final (h_p, w_p) geometry for network size ``size``: the long side
    lands on ``size``, so the device's resize after it is an exact
    identity.  Labels are clamped before and rounded after, as on the
    device.

    image (H, W, 3) uint8; label (H, W) uint8 or None.  Returns (image
    (h_p, w_p, 3) uint8, label (h_p, w_p) uint8 or None)."""
    h_p, w_p, *_ = symmetric_geometry(image.shape[0], image.shape[1], size)
    img = _scipy_resize(np.asarray(image, np.float64), h_p, w_p)
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    lab_out = None
    if label is not None:
        lab = np.asarray(label, np.float64)
        if num_classes is not None:
            lab = np.where(lab > num_classes - 1, 0.0, lab)
        lab = _scipy_resize(lab[..., None], h_p, w_p)[..., 0]
        lab_out = np.rint(lab).clip(0, 255).astype(np.uint8)
    return img, lab_out


def host_prepare_sample(image, label, size: int, num_classes: int = 21):
    """The reference's per-sample pipeline on the host: normalise →
    symmetric resize and pad; label: clamp → resize → clamp → one-hot.
    Returns (image (size, size, 3) float32, one-hot (size, size, C) float32
    or None)."""

    def scipy_symmetric(arr):
        h_p, w_p, pad_t, pad_l, pad_b, pad_r = symmetric_geometry(arr.shape[0], arr.shape[1], size)
        return np.pad(_scipy_resize(arr, h_p, w_p), ((pad_t, pad_b), (pad_l, pad_r), (0, 0)))

    image = 2.0 * (np.asarray(image, np.float64) / 255.0 - 0.5)
    image = scipy_symmetric(image).astype(np.float32)
    onehot = None
    if label is not None:
        label = np.asarray(label)
        if label.ndim == 2:
            label = label[..., None]
        label = label.copy()
        label[label > num_classes - 1] = 0
        label = scipy_symmetric(label)
        label[label > num_classes - 1] = 0
        onehot = np.eye(num_classes, dtype=np.float32)[label[..., 0].astype(np.int64)]
    return image, onehot
