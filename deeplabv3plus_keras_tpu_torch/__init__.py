"""DeepLabV3+ in PyTorch for one NVIDIA H100: the port of the JAX package
``deeplabv3plus_keras_tpu``, with hand-written CUDA kernels for Hopper
(``csrc/``) in place of its Pallas TPU kernels.

This package imports ``torch`` and never ``jax``, ``flax`` or the JAX
package.  Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .api import SemanticSegmentation
from .config import Config

__all__ = ["Config", "SemanticSegmentation"]
