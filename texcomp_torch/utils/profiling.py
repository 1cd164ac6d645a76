"""Timing on the card with CUDA events.

``cuda_time_ms`` warms an operation up, then times each of several
repeats between two CUDA events on the current stream and returns the
median. Before each repeat it overwrites a buffer larger than the H100's
50 MB L2 cache, so every repeat starts from device memory, as a caller
that has just uploaded or produced other data would.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

_L2_FLUSH_BYTES = 256 << 20


def cuda_time_ms(fn: Callable[[], object], *, device="cuda",
                 warmup: int = 2, repeats: int = 10) -> float:
    """Median milliseconds of ``fn()`` on ``device``'s current stream."""
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
