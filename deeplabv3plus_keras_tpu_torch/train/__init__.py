"""Training pieces of the PyTorch port: the class-balanced loss and Keras
L2, the confusion matrix and mean IoU, and Keras-semantics Adam."""

from .callbacks import LRSchedule, ReduceLROnPlateau
from .loss import (
    SS_NW,
    SS_PW,
    class_balanced_loss,
    class_balanced_loss_sparse,
    compute_class_balance_weights,
    l2_penalty,
)
from .metrics import (
    MeanIoU,
    confusion_matrix_update,
    confusion_matrix_update_sparse,
    mean_iou_from_cm,
)
from .optimizer import KerasAdam, get_learning_rate, make_optimizer, set_learning_rate

__all__ = [
    "LRSchedule",
    "ReduceLROnPlateau",
    "SS_PW",
    "SS_NW",
    "class_balanced_loss",
    "class_balanced_loss_sparse",
    "compute_class_balance_weights",
    "l2_penalty",
    "MeanIoU",
    "confusion_matrix_update",
    "confusion_matrix_update_sparse",
    "mean_iou_from_cm",
    "KerasAdam",
    "make_optimizer",
    "get_learning_rate",
    "set_learning_rate",
]
