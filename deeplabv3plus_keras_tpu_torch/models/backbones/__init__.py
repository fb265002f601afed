"""Backbone registry (port of ``deeplabv3plus_keras_tpu/models/backbones/__init__.py``).

The port carries MobileNetV2 and Xception so far."""

from __future__ import annotations

from ...config import ALL_BASE_MODELS, BASE_MODEL_MOBILENETV2
from .mobilenetv2 import MobileNetV2Backbone
from .xception import XceptionBackbone

_REGISTRY = {BASE_MODEL_MOBILENETV2: MobileNetV2Backbone, "xception": XceptionBackbone}


def get_backbone(name: str, output_stride: int):
    """Instantiate the backbone module for a config ``base_model`` name."""
    if name in _REGISTRY:
        return _REGISTRY[name](output_stride=output_stride)
    if name in ALL_BASE_MODELS:
        raise NotImplementedError(
            f"base_model {name!r} is not ported to PyTorch yet (ROADMAP.md "
            f"Queue A item 14); the port has {sorted(_REGISTRY)}"
        )
    raise ValueError(f"Unknown base_model {name!r}; known: {sorted(ALL_BASE_MODELS)}")

