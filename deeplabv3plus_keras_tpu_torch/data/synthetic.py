"""Synthetic mini-VOC fixture generator (the port's own copy of
``deeplabv3plus_keras_tpu/data/synthetic.py``).

Creates a tiny on-disk dataset with the exact directory layout the VOC
sources expect (data/voc.py), for end-to-end train/eval/test smoke tests
(SURVEY §4: the reference has no tests; its only 'integration test' is the
Colab runbook against the real VOC download).
"""

from __future__ import annotations

import os

import numpy as np


def make_synthetic_voc(
    root: str,
    n_train: int = 8,
    n_val: int = 4,
    n_test: int = 2,
    num_classes: int = 21,
    min_size: int = 60,
    max_size: int = 140,
    seed: int = 1024,
) -> str:
    """Write JPEG/PNG pairs + list files under ``root``; returns root.

    Labels are blocky class-id masks (ids can exceed num_classes−1 to
    exercise the ignore-id clamp).
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    img_dir = os.path.join(voc, "JPEGImages")
    lab_dir = os.path.join(voc, "SegmentationClassAug")
    set_dir = os.path.join(voc, "ImageSets", "Segmentation")
    test_voc = os.path.join(root, "pascal-voc-2012-test", "VOCdevkit", "VOC2012")
    test_img_dir = os.path.join(test_voc, "JPEGImages")
    test_set_dir = os.path.join(test_voc, "ImageSets", "Segmentation")
    for d in (img_dir, lab_dir, set_dir, test_img_dir, test_set_dir):
        os.makedirs(d, exist_ok=True)

    def write_pair(name, directory_img, directory_lab=None):
        h = int(rng.integers(min_size, max_size))
        w = int(rng.integers(min_size, max_size))
        img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(directory_img, name + ".jpg"), quality=90)
        if directory_lab is not None:
            blocky = rng.integers(0, 25, size=(h // 16 + 1, w // 16 + 1)).astype(np.uint8)
            lab = np.repeat(np.repeat(blocky, 16, 0), 16, 1)[:h, :w]
            lab[0, 0] = 255  # VOC ignore id, must clamp to background
            Image.fromarray(lab).save(os.path.join(directory_lab, name + ".png"))

    train_names = [f"tr_{i:04d}" for i in range(n_train)]
    val_names = [f"val_{i:04d}" for i in range(n_val)]
    test_names = [f"te_{i:04d}" for i in range(n_test)]
    for n in train_names + val_names:
        write_pair(n, img_dir, lab_dir)
    for n in test_names:
        write_pair(n, test_img_dir)

    with open(os.path.join(set_dir, "train_aug.txt"), "w") as f:
        f.write("\n".join(train_names) + "\n")
    with open(os.path.join(set_dir, "val.txt"), "w") as f:
        f.write("\n".join(val_names) + "\n")
    # Ext combined list: train head, val tail (split by val_ratio).
    with open(os.path.join(set_dir, "train_aug_val.txt"), "w") as f:
        f.write("\n".join(train_names + val_names) + "\n")
    with open(os.path.join(test_set_dir, "test.txt"), "w") as f:
        f.write("\n".join(test_names) + "\n")
    return root


def make_synthetic_openimages(
    root: str,
    n_train: int = 6,
    n_val: int = 2,
    min_size: int = 60,
    max_size: int = 120,
    seed: int = 1024,
) -> str:
    """Synthetic Google Open Images V5 layout for the CSV-driven source
    (data/openimages.py): class-description CSV, per-split annotation CSVs,
    JPEG images and binary mask PNGs (value 1 = object)."""
    import csv as csv_mod

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    classes = [
        ("/m/01g317", "Person"),
        ("/m/01yrx", "Cat"),
        ("/m/0bt9lr", "Dog"),
        ("/m/0k4j", "Car"),
        ("/m/01bjv", "Bus"),
        ("/m/04_sv", "Motorcycle"),
        ("/m/0199g", "Bicycle"),
        ("/m/0cmf2", "Airplane"),  # outside the 7-class subset → filtered
    ]
    with open(os.path.join(root, "class-description-boxable.csv"), "w", newline="") as f:
        w = csv_mod.writer(f)
        for ic, sc in classes:
            w.writerow([ic, sc])

    def make_split(csv_name, img_dir, mask_dir, n, prefix):
        os.makedirs(os.path.join(root, img_dir), exist_ok=True)
        os.makedirs(os.path.join(root, mask_dir), exist_ok=True)
        with open(os.path.join(root, csv_name), "w", newline="") as f:
            w = csv_mod.writer(f)
            w.writerow(["Unused", "MaskPath", "ImageID", "LabelName"])
            for i in range(n):
                ic, sc = classes[rng.integers(0, len(classes))]
                h = int(rng.integers(min_size, max_size))
                wdt = int(rng.integers(min_size, max_size))
                image_id = f"{prefix}{i:04d}"
                mask_name = f"{image_id}_{ic.replace('/', '')}_0.png"
                img = rng.integers(0, 256, (h, wdt, 3)).astype(np.uint8)
                Image.fromarray(img).save(
                    os.path.join(root, img_dir, image_id + ".jpg"), quality=90
                )
                mask = (rng.uniform(size=(h, wdt)) < 0.3).astype(np.uint8)  # 0/1
                Image.fromarray(mask).save(
                    os.path.join(root, mask_dir, mask_name)
                )
                w.writerow(["x", mask_name, image_id, ic])

    make_split(
        "train_valid-annotation-object-segmentation.csv", "train", "train-masks",
        n_train, "tr",
    )
    make_split(
        "validation-annotation-object-segmentation.csv", "validation",
        "validation-masks", n_val, "va",
    )
    make_split(
        "test-annotation-object-segmentation.csv", "test", "test-masks",
        n_val, "te",
    )
    return root
