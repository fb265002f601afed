"""Public facade: JSON-config-driven DeepLabV3+ serving (port of
``deeplabv3plus_keras_tpu/api.py:71-192, 634-648``).

This slice of the port serves: it builds and initialises the model and
answers ``segment(images)``.  Training, evaluation, the test loop and model
export are later slices (ROADMAP.md Queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .models.deeplab import DeepLabV3Plus
from .parallel.step import build_label_step

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

        self.model = DeepLabV3Plus(self.conf)
        self.model.init_weights(torch.Generator().manual_seed(_SEED))
        self.model.to(self.device, memory_format=torch.channels_last).eval()
        self._label_step = build_label_step(self.model)

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
