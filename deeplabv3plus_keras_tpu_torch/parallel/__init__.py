"""Train, eval and serving steps of the PyTorch port."""

from .step import (
    build_eval_step,
    build_label_step,
    build_predict_step,
    build_train_step,
    create_train_state,
    default_class_weights,
    resolve_class_weights,
)

__all__ = [
    "build_eval_step",
    "build_label_step",
    "build_predict_step",
    "build_train_step",
    "create_train_state",
    "default_class_weights",
    "resolve_class_weights",
]
