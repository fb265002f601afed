"""Utilities of the PyTorch port."""

from .profiling import MetricsLogger, StepTimer, profiler_trace, span

__all__ = ["MetricsLogger", "StepTimer", "profiler_trace", "span"]
