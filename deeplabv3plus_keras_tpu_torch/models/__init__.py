"""Model modules of the PyTorch port."""

from .deeplab import DeepLabV3Plus

__all__ = ["DeepLabV3Plus"]
