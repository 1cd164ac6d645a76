"""Timing and tracing on the card.

``cuda_time_ms`` warms an operation up, then times each of several
repeats between two CUDA events on the current stream and returns the
median. Before each repeat it overwrites a buffer larger than the H100's
50 MB L2 cache, so every repeat starts from device memory, as a caller
that has just uploaded or produced other data would. ``throughput`` turns
that time into Mpix/s. ``device_trace`` records a torch.profiler trace of
a block of work into a log directory. ``span`` names a step of the port
on that trace's timeline.

This module imports nothing of the package, so that every layer, the
codecs included, can import :func:`span`.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler

_L2_FLUSH_BYTES = 256 << 20

#: What :func:`span` returns while no profiler records: one shared context
#: that does nothing.
NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks a step of the port as a host event ``name`` on
    a recording torch.profiler's timeline (the clock of the card's kernels
    and copies), so that each idle gap of the card can be put down to the
    step above it. While no profiler records it costs one check and
    returns :data:`NO_SPAN`:

        with span("texcomp.api.upload"):
            ...
    """
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return torch.profiler.record_function(name)


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


def throughput(op: Callable, arg, *, pixels: int, device="cuda",
               warmup: int = 2, repeats: int = 10) -> float:
    """Mpix/s of ``op(arg)`` on ``device``: ``pixels`` over the
    :func:`cuda_time_ms` median."""
    ms = cuda_time_ms(lambda: op(arg), device=device, warmup=warmup,
                      repeats=repeats)
    return pixels / (ms * 1e-3) / 1e6


@contextlib.contextmanager
def device_trace(logdir: str, *, device="cuda"):
    """Record a torch.profiler trace of the block's work into ``logdir``
    (a Chrome trace, ``*.pt.trace.json``, which TensorBoard's profiler
    plugin and Perfetto read); the card's kernels too unless ``device`` is
    the CPU. Yields ``logdir``:

        with device_trace("traces/encode"):
            encode(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(logdir))
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=handler):
        yield logdir
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
