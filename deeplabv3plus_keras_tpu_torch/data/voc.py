"""Pascal VOC 2012 / VOC 2012 Aug ("ext") dataset sources (the port's own
copy of ``deeplabv3plus_keras_tpu/data/voc.py``).

Reference: ``TrainingSequencePascalVOC2012`` (semantic_segmentation.py:
1605-1791) and ``TrainingSequencePascalVOC2012Ext`` (:1420-1603).

Directory layout (as in the reference / runbook notebook):
    <resource_path>/VOCdevkit/VOC2012/
        ImageSets/Segmentation/{train_aug.txt, val.txt, train_aug_val.txt}
        JPEGImages/<name>.jpg
        SegmentationClassAug/<name>.png
    <resource_path>/pascal-voc-2012-test/VOCdevkit/VOC2012/
        ImageSets/Segmentation/test.txt     (test images, no labels)

Ext split semantics (:1463-1468): ONE combined list ``train_aug_val.txt``;
train = first (1−val_ratio) slice, val = last val_ratio slice, NO shuffle.

Step bookkeeping (:1487-1509): steps = ceil(total/batch) with a ragged
last batch; these are written back into ``hps`` as tr_step/val_step/
test_step.  Here the loader emits a fixed-size final batch padded with a
``valid`` mask instead (one batch shape for every step).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

MODE_TRAIN = 0
MODE_VAL = 1
MODE_TEST = 2

# The 21 Pascal VOC semantic classes in label-id order (id 0 = background),
# used for readable per-class IoU reports (MeanIoU.report).
CLASS_NAMES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


@dataclass
class SampleSpec:
    name: str
    image_path: str
    label_path: str | None
    # Open Images: mask pixels equal to 1 are remapped to this class index
    # (reference :1358-1359); None for id-coded labels (VOC).
    label_remap_value: int | None = None
    # False marks a padding duplicate (multi-host shard_specs with
    # mark_duplicates): still decoded for shape-stable batches, but the
    # batch 'valid' mask zeroes it out of loss and confusion matrix, so
    # multi-host evaluation never double-counts wrapped samples.
    valid: bool = True


def _read_list(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _voc_root(resource_path: str) -> str:
    return os.path.join(resource_path, "VOCdevkit", "VOC2012")


def _specs(root: str, names: list[str], with_labels: bool) -> list[SampleSpec]:
    img_dir = os.path.join(root, "JPEGImages")
    lab_dir = os.path.join(root, "SegmentationClassAug")
    return [
        SampleSpec(
            name=n,
            image_path=os.path.join(img_dir, n + ".jpg"),
            label_path=os.path.join(lab_dir, n + ".png") if with_labels else None,
        )
        for n in names
    ]


def pascal_voc_2012(resource_path: str, mode: int) -> list[SampleSpec]:
    """Plain VOC source: train_aug.txt / val.txt / test.txt (:1612-1660)."""
    root = _voc_root(resource_path)
    sets = os.path.join(root, "ImageSets", "Segmentation")
    if mode == MODE_TRAIN:
        return _specs(root, _read_list(os.path.join(sets, "train_aug.txt")), True)
    if mode == MODE_VAL:
        return _specs(root, _read_list(os.path.join(sets, "val.txt")), True)
    if mode == MODE_TEST:
        test_root = os.path.join(
            resource_path, "pascal-voc-2012-test", "VOCdevkit", "VOC2012"
        )
        names = _read_list(
            os.path.join(test_root, "ImageSets", "Segmentation", "test.txt")
        )
        return _specs(test_root, names, False)
    raise ValueError(f"invalid mode {mode}")


def pascal_voc_2012_ext(
    resource_path: str, mode: int, val_ratio: float
) -> list[SampleSpec]:
    """Aug/Ext source: single train_aug_val.txt split by val_ratio
    (:1463-1468 — train = head slice, val = tail slice, unshuffled)."""
    root = _voc_root(resource_path)
    sets = os.path.join(root, "ImageSets", "Segmentation")
    names = _read_list(os.path.join(sets, "train_aug_val.txt"))
    # exact reference formula (:1464, :1467): train = int(n·(1−r)) head
    # rows — NOT n − int(n·r), which is one sample larger whenever n·r is
    # fractional (e.g. 12031 specs at r=0.1: 10827/1204, not 10828/1203)
    n_train = int(len(names) * (1.0 - val_ratio))
    if mode == MODE_TRAIN:
        return _specs(root, names[:n_train], True)
    if mode == MODE_VAL:
        return _specs(root, names[n_train:], True)
    if mode == MODE_TEST:
        return pascal_voc_2012(resource_path, MODE_TEST)
    raise ValueError(f"invalid mode {mode}")
