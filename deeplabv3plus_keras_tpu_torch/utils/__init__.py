"""Utilities of the PyTorch port."""

from .profiling import MetricsLogger, StepTimer, profiler_trace

__all__ = ["MetricsLogger", "StepTimer", "profiler_trace"]
