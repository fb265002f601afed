"""Google Open Images V5 segmentation source (CSV-annotation driven; the
port's own copy of ``deeplabv3plus_keras_tpu/data/openimages.py``).

Reference: ``TrainingSequenceGoogleOpenImagesV5`` (semantic_segmentation
.py:1229-1418).  Semantics mirrored:

- per-split annotation CSVs (``{train_valid,validation,test}-annotation-
  object-segmentation.csv``) whose first column is dropped; column 0 is the
  mask file name ``<imageid>_<labelid>_....png`` (image = ``<imageid>.jpg``
  in ``<split>/``, mask in ``<split>-masks/``), column 2 the class id;
- class-description-boxable.csv maps class ids to semantic names, filtered
  to the 7-class subset ``GOIV5_SPECIFIC_SET`` (:118) with 1-based class
  indices (0 = background);
- mask pixels with value 1 are remapped to the class index (:1358-1359).

The reference implementation was non-functional as written (SURVEY §2.3):
``issuperset`` called on a *string* compares characters, the class index
counter is never incremented, and the row filter iterates an empty
DataFrame (:1285-1292).  This is the working equivalent: name-level set
membership, incrementing indices in class-description order, and filtering
the annotation rows themselves.  'Bicycle' is accepted alongside the
reference's typo'd 'Bicyle'.
"""

from __future__ import annotations

import csv
import os

from .voc import MODE_TEST, MODE_TRAIN, MODE_VAL, SampleSpec

# Reference :118 (typo kept, correct spelling added).
GOIV5_SPECIFIC_SET = {"Person", "Cat", "Dog", "Car", "Bus", "Motorcycle", "Bicyle", "Bicycle"}

_SPLIT_FILES = {
    MODE_TRAIN: ("train_valid-annotation-object-segmentation.csv", "train", "train-masks"),
    MODE_VAL: ("validation-annotation-object-segmentation.csv", "validation", "validation-masks"),
    MODE_TEST: ("test-annotation-object-segmentation.csv", "test", "test-masks"),
}


def load_class_maps(resource_path: str):
    """ic2sc / sc2ic / ic2in / sc2in maps for the 7-class subset, indices
    1-based in class-description file order (reference :1266-1281)."""
    ic2sc, sc2ic, ic2in, sc2in = {}, {}, {}, {}
    index_num = 0
    path = os.path.join(resource_path, "class-description-boxable.csv")
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 2:
                continue
            ic, sc = row[0], row[1]
            if sc in GOIV5_SPECIFIC_SET:
                index_num += 1
                ic2sc[ic] = sc
                sc2ic[sc] = ic
                ic2in[ic] = index_num
                sc2in[sc] = index_num
    return ic2sc, sc2ic, ic2in, sc2in


def google_open_images_v5(resource_path: str, mode: int) -> list[SampleSpec]:
    """Annotation rows filtered to the class subset → SampleSpecs with the
    per-sample mask remap value (mask==1 → class index)."""
    csv_name, img_dir, mask_dir = _SPLIT_FILES[mode]
    _, _, ic2in, _ = load_class_maps(resource_path)

    specs: list[SampleSpec] = []
    with open(os.path.join(resource_path, csv_name), newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        for row in reader:
            row = row[1:]  # reference drops the first CSV column (:1263)
            if len(row) < 3:
                continue
            mask_name, index_class = row[0], row[2]
            if index_class not in ic2in:
                continue
            image_name = mask_name.split("_")[0] + ".jpg"
            specs.append(
                SampleSpec(
                    name=os.path.splitext(image_name)[0],
                    image_path=os.path.join(resource_path, img_dir, image_name),
                    label_path=(
                        os.path.join(resource_path, mask_dir, mask_name)
                        if mode != MODE_TEST
                        else None
                    ),
                    label_remap_value=ic2in[index_class],
                )
            )
    return specs


def extract_valid_train_list(resource_path: str, csv_name: str) -> list[list[str]]:
    """Drop annotation rows whose image file is missing/unreadable.

    Working equivalent of ``utils.extract_valid_train_list`` (reference
    utils.py:11-24, where a ``continue`` before the append made it dead
    code — SURVEY §2.3).
    """
    from PIL import Image

    rows_out = []
    with open(os.path.join(resource_path, csv_name), newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        for row in reader:
            mask_name = row[1] if len(row) > 1 else ""
            image_path = os.path.join(
                resource_path, "train", mask_name.split("_")[0] + ".jpg"
            )
            try:
                with Image.open(image_path):
                    pass
            except Exception:
                continue
            rows_out.append(row)
    return rows_out
