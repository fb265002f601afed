"""Configuration schema (PyTorch port's own copy).

A copy of ``deeplabv3plus_keras_tpu/config.py``: the port imports nothing
of the JAX package, so it keeps this framework-free schema itself.  The
two must accept and emit the same JSON (tests/test_torch_config.py).

Mirrors the reference's single JSON config file verbatim
(reference: semantic_segmentation_deeplabv3plus_conf.json:1-54, loaded by
``main()`` at semantic_segmentation.py:1804-1806).  The JSON dict is the
public configuration surface; this module wraps it in typed dataclasses with
validation while preserving round-tripping of unknown keys.

The interesting sub-schema is ``nn_arch.encoder_middle_conf`` — a mini-IR of
ASPP branch ops interpreted at model-build time (reference
semantic_segmentation.py:806-860).  Each entry:

    {"kernel": int, "rate": [ry, rx], "op": "conv"|"pyramid_pooling",
     "input": -1 | branch_index, "target_size_factor": [fy, fx]}

``input: -1`` consumes the backbone output; ``input: k`` consumes branch
``k``'s output, making the encoder middle a chainable DAG rather than a
parallel-only ASPP.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# Run modes (reference semantic_segmentation.py:1807-1843).
MODE_TRAIN = "train"
MODE_EVALUATE = "evaluate"
MODE_TEST = "test"
MODE_CONVERT_TO_TF_LITE = "convert_to_tf_lite"

# Resource types (reference semantic_segmentation.py:115-117).
RESOURCE_TYPE_PASCAL_VOC_2012 = "pascal_voc_2012"
RESOURCE_TYPE_PASCAL_VOC_2012_EXT = "pascal_voc_2012_ext"
RESOURCE_TYPE_GOOGLE_OPEN_IMAGES_V5 = "google_open_images_v5"

# Preprocessing device selector (reference semantic_segmentation.py:49,
# ``DEVICE_CPU = -1``; >= 0 selects the on-device preprocessing).
DEVICE_CPU = -1

# Backbone names (reference semantic_segmentation.py:96-112).
BASE_MODEL_MOBILENETV2 = "mobilenetv2"
ALL_BASE_MODELS = (
    BASE_MODEL_MOBILENETV2,
    "xception",
    *(f"efficientnetb{i}" for i in range(8)),
    "nasnetmobile",
    "nasnetlarge",
    "densenet121",
    "densenet169",
    "densenet201",
)


@dataclasses.dataclass
class MiddleOp:
    """One entry of ``encoder_middle_conf`` (reference :806-860)."""

    op: str = "conv"  # 'conv' | 'pyramid_pooling'
    kernel: int = 3
    rate: tuple[int, int] = (1, 1)
    input: int = -1
    target_size_factor: tuple[int, int] = (1, 1)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MiddleOp":
        op = d.get("op", "conv")
        if op not in ("conv", "pyramid_pooling"):
            raise ValueError(f"Invalid operation. (op={op!r})")
        return cls(
            op=op,
            kernel=int(d.get("kernel", 3)),
            rate=tuple(d.get("rate", (1, 1))),
            input=int(d.get("input", -1)),
            target_size_factor=tuple(d.get("target_size_factor", (1, 1))),
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "kernel": self.kernel,
            "rate": list(self.rate),
            "op": self.op,
            "input": self.input,
        }
        if self.op == "pyramid_pooling":
            d["target_size_factor"] = list(self.target_size_factor)
        return d


@dataclasses.dataclass
class HParams:
    """``hps`` block (reference conf.json:15-28)."""

    dtype: str = "float32"
    val_ratio: float = 0.1
    lr: float = 1e-4
    beta_1: float = 0.5
    beta_2: float = 0.99
    decay: float = 0.0
    epochs: int = 1
    batch_size: int = 1
    weight_decay: float = 4e-5
    bn_momentum: float = 0.9
    bn_scale: bool = True
    reduce_lr_factor: float = 0.99
    # Steps are written back into hps by the data pipeline, mirroring the
    # reference Sequences (semantic_segmentation.py:1487-1509).
    tr_step: int | None = None
    val_step: int | None = None
    test_step: int | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "HParams":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in ("tr_step", "val_step", "test_step"):
            if d[k] is None:
                del d[k]
        return d


@dataclasses.dataclass
class NNArch:
    """``nn_arch`` block (reference conf.json:29-53)."""

    boundary_refinement: bool = True
    output_stride: int = 16
    image_size: int = 224
    num_classes: int = 21
    mv2_depth_multiplier: int = 1
    depth_multiplier: int = 1
    conv_rate_multiplier: int = 1
    reduction_size: int = 256
    dropout_rate: float = 0.5
    concat_channels: int = 256
    encoder_middle_conf: list[MiddleOp] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # Reference asserts output_stride ∈ {8, 16} (:468).
        if self.output_stride not in (8, 16):
            raise ValueError(
                f"output_stride must be 8 or 16, got {self.output_stride}"
            )

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "NNArch":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        kwargs["encoder_middle_conf"] = [
            MiddleOp.from_dict(e) for e in d.get("encoder_middle_conf", [])
        ]
        return cls(**kwargs)

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["encoder_middle_conf"] = [e.to_dict() for e in self.encoder_middle_conf]
        return d


@dataclasses.dataclass
class Config:
    """Top-level config (reference conf.json:1-54).

    ``multi_gpu``/``num_gpus`` were vestigial in the reference (never built a
    parallel model, semantic_segmentation.py:1222-1223).  As the JAX
    package's mesh does, the port takes them: ``multi_gpu`` with ``num_gpus``
    N > 1 starts N ranks of a ``torch.distributed`` process group, one device
    each (``parallel/mesh.py``, ``api.py`` ``join_ranks``).  Keys the
    dataclass does not name (``backbone_weights``, ``int8_infer``,
    ``int8_calib_batches``, ``fused_tail``, ...) land in ``extra``.
    """

    mode: str = "train"
    resource_type: str = "pascal_voc_2012_ext"
    resource_path: str = "resource"
    model_loading: bool = False
    multi_gpu: bool = False
    num_gpus: int = 1
    prepro_device: int = 0
    eval_data_mode: int = 1
    eval_result_saving: bool = False
    base_model: str = BASE_MODEL_MOBILENETV2
    max_queue_size: int = 80
    workers: int = 4
    hps: HParams = dataclasses.field(default_factory=HParams)
    nn_arch: NNArch = dataclasses.field(default_factory=NNArch)
    # Extra keys preserved for round-tripping.
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)} - {"hps", "nn_arch", "extra"}
        kwargs = {k: v for k, v in d.items() if k in known}
        extra = {
            k: v
            for k, v in d.items()
            if k not in known and k not in ("hps", "nn_arch", "extra")
        }
        # An explicit top-level "extra" dict merges flat: extra keys normally
        # live at the top level of the JSON (any unknown key lands here), but
        # {"extra": {...}} would otherwise nest silently and never be read.
        nested = d.get("extra")
        if isinstance(nested, dict):
            extra = {**nested, **extra}
        return cls(
            hps=HParams.from_dict(d.get("hps", {})),
            nn_arch=NNArch.from_dict(d.get("nn_arch", {})),
            extra=extra,
            **kwargs,
        )

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        d = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("hps", "nn_arch", "extra")
        }
        d["hps"] = self.hps.to_dict()
        d["nn_arch"] = self.nn_arch.to_dict()
        d.update(self.extra)
        return d

