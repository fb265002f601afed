"""Pretrained ImageNet backbone initialisation, wired to the config (port
of ``deeplabv3plus_keras_tpu/utils/pretrained.py``).

The reference builds every backbone from ``tf.keras.applications`` with
the default ``weights='imagenet'`` (semantic_segmentation.py:494-771), so
training always fine-tunes from ImageNet.  One extra config key gives the
port the same start:

    "backbone_weights": "imagenet"          # the Keras cache's weight file
    "backbone_weights": "/path/to/w.h5"     # an offline .h5 / .weights.h5 file
    (absent / null / "")                    # the random init

Both go through :mod:`.keras_weights`.  TensorFlow/Keras is imported only
when the key is set, and never pulls in ``jax`` (TensorFlow's TFLite module
imports it where it is installed; the import is refused while TensorFlow
loads, unless ``jax`` is loaded already).  Nothing is downloaded:
``"imagenet"`` reads the file Keras would have cached
(``$KERAS_HOME/models`` or ``~/.keras/models``) and raises naming it when
it is absent.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from ..config import Config
from .jax_weights import export_jax_variables, load_jax_variables
from .keras_weights import load_keras_h5_backbone

# base_model name → keras.applications attribute.  Weights do not depend on
# the spatial size (conv kernels and BN vectors), so the Keras architecture
# is built at the config's image_size, as the reference builds it.
_KERAS_APP = {
    "mobilenetv2": "MobileNetV2",
    "xception": "Xception",
    "efficientnetb0": "EfficientNetB0",
    "efficientnetb1": "EfficientNetB1",
    "efficientnetb2": "EfficientNetB2",
    "efficientnetb3": "EfficientNetB3",
    "efficientnetb4": "EfficientNetB4",
    "efficientnetb5": "EfficientNetB5",
    "efficientnetb6": "EfficientNetB6",
    "efficientnetb7": "EfficientNetB7",
    "nasnetmobile": "NASNetMobile",
    "nasnetlarge": "NASNetLarge",
    "densenet121": "DenseNet121",
    "densenet169": "DenseNet169",
    "densenet201": "DenseNet201",
}


def imagenet_weight_file(base_model: str, image_size: int) -> str:
    """The name of the include_top=False ImageNet weight file
    ``keras.applications`` caches for ``base_model`` (MobileNetV2's depends
    on the input size: one of 96–224, else 224's)."""
    if base_model == "mobilenetv2":
        rows = image_size if image_size in (96, 128, 160, 192, 224) else 224
        return f"mobilenet_v2_weights_tf_dim_ordering_tf_kernels_1.0_{rows}_no_top.h5"
    if base_model == "xception":
        return "xception_weights_tf_dim_ordering_tf_kernels_notop.h5"
    if base_model.startswith("efficientnet"):
        return f"{base_model}_notop.h5"
    if base_model.startswith("nasnet"):
        return f"nasnet_{base_model[len('nasnet'):]}_no_top.h5"
    return f"{base_model}_weights_tf_dim_ordering_tf_kernels_notop.h5"


def keras_cache_dir() -> str:
    """Where Keras caches downloaded weights: ``$KERAS_HOME/models``, else
    ``~/.keras/models``."""
    home = os.environ.get("KERAS_HOME") or os.path.join(os.path.expanduser("~"), ".keras")
    return os.path.join(home, "models")


@contextlib.contextmanager
def _without_jax():
    """``import jax`` fails inside the block, unless jax is loaded already."""
    if "jax" in sys.modules:
        yield
        return
    sys.modules["jax"] = None  # an ImportError for `import jax`
    try:
        yield
    finally:
        if sys.modules.get("jax", 0) is None:
            del sys.modules["jax"]


def keras_applications():
    """``tensorflow.keras.applications``, imported without ``jax``; raises
    RuntimeError naming TensorFlow where it is missing."""
    try:
        with _without_jax():
            from tensorflow.keras import applications
    except Exception as e:
        raise RuntimeError(
            f"backbone_weights requires TensorFlow/Keras to build the source "
            f"architecture ({type(e).__name__}: {e})") from e
    return applications


def keras_builder(base_model: str, image_size: int, weights=None):
    """A zero-argument callable building the matching Keras architecture
    (include_top=False, reference :496-499 et seq.)."""
    app_fn = getattr(keras_applications(), _KERAS_APP[base_model])

    def build():
        return app_fn(input_shape=(image_size, image_size, 3), include_top=False,
                      weights=weights)

    return build


def load_pretrained_backbone(conf: Config, model: torch.nn.Module,
                             base_path: str = "base") -> dict | None:
    """Replace the backbone weights and BN statistics of the port's
    ``model`` (in place) per ``conf.extra['backbone_weights']``; nothing
    happens when the key is unset or empty.

    Returns the conversion report, or None.  Raises if the source leaves any
    backbone layer unconverted (then ``model`` is left as it was): silently
    training a half-random "pretrained" backbone would be worse than
    failing."""
    spec = conf.extra.get("backbone_weights")
    if not spec:
        return None
    if conf.base_model not in _KERAS_APP:
        raise ValueError(f"unknown base_model {conf.base_model!r}")
    size = conf.nn_arch.image_size
    if spec == "imagenet":
        path = os.path.join(keras_cache_dir(), imagenet_weight_file(conf.base_model, size))
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"backbone_weights='imagenet': the Keras ImageNet weight file {path} is "
                "missing, and nothing is downloaded; put it there (or set KERAS_HOME), "
                "or pass the path of an .h5 file")
    else:
        path = str(spec)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"backbone_weights: no such file {path}")
    builder = keras_builder(conf.base_model, size, weights=None)
    with _without_jax():
        variables, report = load_keras_h5_backbone(path, builder, export_jax_variables(model),
                                                    base_path)
    if report["missing"]:
        raise RuntimeError(
            f"backbone_weights: {len(report['missing'])} layers not found in "
            f"the Keras source, e.g. {report['missing'][:5]}")
    load_jax_variables(model, variables)
    return report
