"""Serving steps of the PyTorch port."""

from .step import build_label_step, build_predict_step

__all__ = ["build_label_step", "build_predict_step"]
