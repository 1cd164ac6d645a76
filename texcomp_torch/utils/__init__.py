"""Auxiliary helpers: timing and tracing on the card, and texture
archives."""

from texcomp_torch.utils.archive import load_archive, save_archive
from texcomp_torch.utils.profiling import (cuda_time_ms, device_trace, span,
                                           throughput)

__all__ = ["cuda_time_ms", "device_trace", "span", "throughput",
           "save_archive", "load_archive"]
