"""The least time each of the port's kernels could take, from its call's
shapes: every input byte read once and every output byte written once,
over the HBM rate of the H100 SXM (NVIDIA's data sheet, 3.35 TB/s at the
full 700 W power limit). The count does not depend on how a kernel is
written, so a redesign of a kernel can never read above 100% of it.

In a traced span :class:`CallRecorder` wraps every kernel wrapper of the
port (``texcomp_torch/ops/*_cuda.py``, the functions named ``*_cuda``),
records the bytes of each call, and counts the device kernels the call
launches, so that the reader can hold the calls to the kernels the
profiler saw.
"""

from __future__ import annotations

import functools
import importlib

import torch

HBM_BYTES_PER_S = 3.35e12

#: The port's modules of kernel wrappers.
WRAPPER_MODULES = ("texcomp_torch.ops.dxt_cuda", "texcomp_torch.ops.etc_cuda",
                   "texcomp_torch.ops.pvrtc_cuda",
                   "texcomp_torch.ops.dxt_hq_cuda")

#: Every kernel wrapper of the port -> the device kernels one call with
#: work launches (csrc/*.cu): the HQ cluster fit launches its table kernel
#: before the top-4 kernel.
KERNELS_PER_CALL = {
    "dxt1_encode_cuda": 1, "dxt5_encode_cuda": 1, "dxt1_decode_cuda": 1,
    "dxt5_decode_cuda": 1, "dxtc_downsample_cuda": 1,
    "etc1_encode_cuda": 1, "etc1_decode_cuda": 1, "etc1_downsample_cuda": 1,
    "etc1_hq_search_cuda": 1,
    "pvrtc_morph_cuda": 1, "pvrtc_morph_strip_cuda": 1,
    "pvrtc_morph_batched_cuda": 1, "pvrtc_upscale_modulate_cuda": 1,
    "pvrtc_upscale_modulate_halo_cuda": 1, "pvrtc_modes_pack_cuda": 1,
    "pvrtc_modes_pack_strip_cuda": 1,
    "cluster_topk4_cuda": 2,
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def call_bytes(args: tuple, out) -> int:
    """Bytes of one call: its tensor arguments read once and its tensor
    results written once; a tensor passed twice, or a result that is a
    view of another, counts once."""
    seen, total = set(), 0
    for t in (*_tensors(args), *_tensors(out)):
        key = (t.data_ptr(), t.numel() * t.element_size())
        if key not in seen:
            seen.add(key)
            total += key[1]
    return total


class CallRecorder:
    """Context manager: while open, every call of a port kernel wrapper
    appends (name, bytes, kernels launched) to :attr:`calls`. A wrapper
    that this table does not know is recorded with bytes None, and the
    reader then reports nothing."""

    def __init__(self):
        self.calls: list[tuple[str, int | None, int]] = []
        self._saved: list[tuple[object, str, object]] = []

    def _wrap(self, name: str, fn):
        @functools.wraps(fn)
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            work = any(t.numel() for t in _tensors(out))
            per = KERNELS_PER_CALL.get(name)
            self.calls.append((name, call_bytes(args, out) if per else None,
                               (per or 1) if work else 0))
            return out

        return recorded

    def __enter__(self):
        for modname in WRAPPER_MODULES:
            mod = importlib.import_module(modname)
            for name, fn in list(vars(mod).items()):
                if name.endswith("_cuda") and callable(fn):
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()
        return False

    def least_s(self) -> float | None:
        """Sum of the recorded calls' least times; None if any call was of
        a wrapper this table does not know."""
        if any(b is None for _, b, _ in self.calls):
            return None
        return sum(b for _, b, _ in self.calls) / HBM_BYTES_PER_S

    def kernels(self) -> int:
        return sum(k for _, _, k in self.calls)
