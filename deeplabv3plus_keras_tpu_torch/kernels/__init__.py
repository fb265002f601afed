"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Importing this package builds nothing; a kernel's shared library is built
by :mod:`._build` on its first launch.
"""

from . import depthwise as _depthwise
from . import parity_tail as _parity_tail
from . import upsample_argmax as _upsample_argmax
from .depthwise import (
    depthwise_cf,
    depthwise_cf_backward,
    depthwise_conv,
    depthwise_conv_backward,
    depthwise_conv_backward_plain,
    depthwise_conv_plain,
    depthwise_route,
    same_pads,
)
from .parity_tail import (
    parity_tail_backward,
    parity_tail_backward_plain,
    parity_tail_forward,
    parity_tail_forward_plain,
)
from .upsample_argmax import upsample_argmax, upsample_argmax_plain

_COUNTERS = (_depthwise.launches, _upsample_argmax.launches, _parity_tail.launches)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


def launch_counts_by_dtype() -> dict[str, int]:
    """The depthwise kernels' launches since the last reset, by
    ``"<kernel>/<dtype>"``."""
    return dict(_depthwise.launches_by_dtype)


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
    _depthwise.launches_by_dtype.clear()


__all__ = [
    "depthwise_cf",
    "depthwise_cf_backward",
    "depthwise_conv",
    "depthwise_conv_backward",
    "depthwise_conv_backward_plain",
    "depthwise_conv_plain",
    "depthwise_route",
    "launch_counts",
    "launch_counts_by_dtype",
    "parity_tail_backward",
    "parity_tail_backward_plain",
    "parity_tail_forward",
    "parity_tail_forward_plain",
    "reset_launch_counts",
    "same_pads",
    "upsample_argmax",
    "upsample_argmax_plain",
]
