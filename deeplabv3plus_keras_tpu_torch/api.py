"""Public facade: JSON-config-driven DeepLabV3+ (port of
``deeplabv3plus_keras_tpu/api.py:71-192, 634-648``).

It builds and initialises the model (``base_model`` ``mobilenetv2`` or
``xception``), the training state (Keras Adam) and the train, eval and
label steps, as the JAX facade does, and answers ``train_step(batch)``,
``eval_step(batch)`` and ``segment(images)``.  The epoch loops
``train()``, ``evaluate()`` and ``test()`` need the data slice, and model
export comes later (ROADMAP.md Queue A).  Config keys that would change
the result and are not ported yet (``model_loading``, ``multi_gpu`` with
``num_gpus`` > 1, ``int8_infer``, ``backbone_weights``, ``mesh_space`` > 1)
raise ``NotImplementedError``.

The environment variable ``DLV3_DW_LAYOUT=bhcw`` routes the 3×3 stride-1
undilated depthwise sites through the channels-first kernels
(``kernels/depthwise.py``), as it does in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .models.deeplab import DeepLabV3Plus
from .parallel.step import (
    build_eval_step,
    build_label_step,
    build_train_step,
    create_train_state,
    resolve_class_weights,
)

_SEED = 1024  # the reference seeds 1024 (semantic_segmentation.py:1797-1802)


def resolve_device(device=None) -> torch.device:
    """The given device, else the first CUDA card; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


class SemanticSegmentation:
    """JSON-config-driven DeepLabV3+ semantic segmentation model."""

    def __init__(self, conf: dict | Config, work_dir: str = ".", device=None):
        self.conf = conf if isinstance(conf, Config) else Config.from_dict(conf)
        self.work_dir = work_dir
        self.device = resolve_device(device)
        if self.conf.hps.dtype != "float32":
            raise NotImplementedError(
                f"hps.dtype {self.conf.hps.dtype!r}: the port serves float32 only so far"
            )
        if self.conf.extra.get("int8_infer", False):
            raise NotImplementedError("int8_infer is not ported yet (ROADMAP.md Queue A item 15)")
        if self.conf.model_loading:
            raise NotImplementedError(
                "model_loading (restore the checkpoint in work_dir) is not ported yet "
                "(ROADMAP.md Queue A item 11, checkpointing)"
            )
        if self.conf.multi_gpu and self.conf.num_gpus > 1:
            raise NotImplementedError(
                f"multi_gpu with num_gpus={self.conf.num_gpus}: the port trains on one "
                "device so far (ROADMAP.md Queue A item 13, multi-GPU data parallelism)"
            )
        # the JAX facade loads these weights or raises (api.py:131-133); it
        # skips only an unset or empty key (utils/pretrained.py:79-81)
        if self.conf.extra.get("backbone_weights"):
            raise NotImplementedError(
                f"backbone_weights={self.conf.extra['backbone_weights']!r}: pretrained "
                "backbones are not ported yet (ROADMAP.md Queue A item 14, the converter)"
            )
        if int(self.conf.extra.get("mesh_space", 1)) > 1:
            raise NotImplementedError(
                f"mesh_space={self.conf.extra['mesh_space']}: spatial sharding is not "
                "ported yet (ROADMAP.md Queue A item 13, multi-GPU data parallelism)"
            )

        self.model = DeepLabV3Plus(self.conf)
        self.model.init_weights(torch.Generator().manual_seed(_SEED))
        self.model.to(self.device, memory_format=torch.channels_last).eval()
        self.optimizer = create_train_state(self.conf, self.model)
        # extra key 'class_weights_npz': the loss's class-balance weights
        cw = resolve_class_weights(self.conf)
        self._train_step = build_train_step(self.model, self.optimizer, self.conf,
                                            class_weights=cw, seed=_SEED)
        self._eval_step = build_eval_step(self.model, self.conf, class_weights=cw,
                                          with_probs=False)
        self._label_step = build_label_step(self.model)

    def train_step(self, batch: dict) -> dict:
        """One Keras-Adam step on ``batch`` (``image`` (B,S,S,3), ``label``
        one-hot (B,S,S,C) or int (B,S,S), optional ``valid`` (B,)), BN in
        training mode.  Returns ``{"loss", "cm"}`` as device tensors, so a
        loop of steps does not wait on each one."""
        return self._train_step(self._batch(batch))

    def eval_step(self, batch: dict) -> dict:
        """Validation loss (+ L2) and confusion matrix of ``batch``, BN on
        running statistics."""
        return self._eval_step(self._batch(batch))

    def segment(self, images) -> np.ndarray:
        """Programmatic batch inference: images (B,S,S,3) in (−1,1) →
        argmax class-index labels (B,S,S) int32 (reference segment,
        :1207-1227).  Only the labels cross to the host."""
        return self._label_step(self._images(images)).cpu().numpy()

    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"images must be (B, S, S, 3), got {tuple(x.shape)}")
        return x

    def _batch(self, batch: dict) -> dict:
        image = self._images(batch["image"])
        label = torch.as_tensor(batch["label"], device=self.device)
        if label.shape[:3] != image.shape[:3]:
            raise ValueError(f"label {tuple(label.shape)} does not match images {tuple(image.shape)}")
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(image.shape[0], dtype=torch.int32, device=self.device)
        return {"image": image, "label": label,
                "valid": torch.as_tensor(valid, device=self.device)}
