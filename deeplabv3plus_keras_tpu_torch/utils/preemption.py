"""SIGTERM preemption guard (the port's own copy of
``deeplabv3plus_keras_tpu/utils/preemption.py``).

The reference's only resilience was manual best-checkpoint resume
(semantic_segmentation.py:482-490).  Here every long-running entry point
runs under a ``PreemptionGuard``: SIGTERM (a scheduler's preemption
signal) sets a flag; step loops poll it (finishing the step in flight),
and long host phases poll ``check_active()`` and unwind with
``Preempted``, so the caller can save and exit cleanly instead of dying
mid-phase.
"""

from __future__ import annotations

import signal


class Preempted(Exception):
    """Raised from ``check``/``check_active`` after SIGTERM arrived."""


class PreemptionGuard:
    """Context manager installing a SIGTERM flag handler.

    ``enabled=False`` (config ``preemption_save: false``) or running off
    the main thread → no handler, never triggers.  The innermost active
    guard is visible process-wide through ``check_active`` so deep phases
    (data-cache builds) need no plumbing.
    """

    _active: "PreemptionGuard | None" = None

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.signum: int | None = None
        self._prev = None
        self._outer: "PreemptionGuard | None" = None

    # -- polling -------------------------------------------------------
    @property
    def triggered(self) -> bool:
        return self.signum is not None

    def check(self) -> None:
        if self.triggered:
            raise Preempted()

    @classmethod
    def check_active(cls) -> None:
        """Raise ``Preempted`` if any enclosing guard has triggered."""
        if cls._active is not None:
            cls._active.check()

    # -- context -------------------------------------------------------
    def __enter__(self) -> "PreemptionGuard":
        if self.enabled:
            try:
                self._prev = signal.signal(
                    signal.SIGTERM, lambda s, f: setattr(self, "signum", s)
                )
            except ValueError:  # not the main thread: no handler
                self._prev = None
        self._outer = PreemptionGuard._active
        PreemptionGuard._active = self
        return self

    def __exit__(self, *exc):
        PreemptionGuard._active = self._outer
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
        return False
