"""Backbone registry (port of ``deeplabv3plus_keras_tpu/models/backbones/__init__.py``):
the reference's 14-backbone ladder (semantic_segmentation.py:494-771) as
a table keyed by the config's ``base_model``.  Every backbone takes the
output stride and is cut where the reference cuts it; EfficientNet also
takes the compute dtype, which it casts the images to after its float32
prologue."""

from __future__ import annotations

from functools import partial

import torch

from ...config import ALL_BASE_MODELS, BASE_MODEL_MOBILENETV2
from .densenet import DENSENET_VARIANTS, DenseNetBackbone
from .efficientnet import EFFICIENTNET_VARIANTS, EfficientNetBackbone
from .mobilenetv2 import MobileNetV2Backbone
from .nasnet import NASNET_VARIANTS, NASNetBackbone
from .xception import XceptionBackbone

_REGISTRY = {
    BASE_MODEL_MOBILENETV2: MobileNetV2Backbone,
    "xception": XceptionBackbone,
    **{v: partial(EfficientNetBackbone, v) for v in EFFICIENTNET_VARIANTS},
    **{v: partial(NASNetBackbone, v) for v in NASNET_VARIANTS},
    **{v: partial(DenseNetBackbone, v) for v in DENSENET_VARIANTS},
}


def get_backbone(name: str, output_stride: int, dtype: torch.dtype | None = None):
    """Instantiate the backbone module for a config ``base_model`` name;
    ``dtype`` is the compute dtype of a backbone that casts its own images
    (EfficientNet); the others compute in their input's dtype."""
    if name not in _REGISTRY:
        raise ValueError(f"Unknown base_model {name!r}; known: {sorted(ALL_BASE_MODELS)}")
    if name in EFFICIENTNET_VARIANTS:
        return _REGISTRY[name](output_stride=output_stride, dtype=dtype)
    return _REGISTRY[name](output_stride=output_stride)
