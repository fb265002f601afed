"""Datasets and the host loader of the port (port of
``deeplabv3plus_keras_tpu/data/``)."""

from .pipeline import DeviceDataset, HostLoader, device_batches, load_sample
from .synthetic import make_synthetic_openimages, make_synthetic_voc
from .voc import (
    CLASS_NAMES,
    MODE_TEST,
    MODE_TRAIN,
    MODE_VAL,
    SampleSpec,
    pascal_voc_2012,
    pascal_voc_2012_ext,
)

__all__ = [
    "CLASS_NAMES",
    "DeviceDataset",
    "MODE_TEST",
    "MODE_TRAIN",
    "MODE_VAL",
    "HostLoader",
    "SampleSpec",
    "device_batches",
    "load_sample",
    "make_synthetic_openimages",
    "make_synthetic_voc",
    "pascal_voc_2012",
    "pascal_voc_2012_ext",
]
