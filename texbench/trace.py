"""Reduce one torch.profiler trace of a traced span to what the per-layer
readers and the result's ``device`` and ``breakdown`` take.

The events stay in memory: no trace file is written. The span is the
host interval of the benchmark's ``texbench.window`` annotation; the
device's busy time is the union of the kernels and copies that ran in it.
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

#: The port's kernels: the __global__ functions of texcomp_torch/csrc/*.cu,
#: in its anonymous namespaces (PyTorch has kernels in anonymous namespaces
#: too, such as arange's elementwise_kernel_with_index).
PORT_KERNELS = ("encode_kernel", "decode_kernel", "downsample_kernel",
                "cluster_topk4_kernel", "pack_table_kernel",
                "hq_search_kernel", "rate_kernel", "morph_kernel",
                "upscale_modulate_kernel", "upscale_modulate_halo_kernel",
                "modes_pack_kernel", "modes_pack_strip_kernel")
_PORT_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::(%s)[<(]"
                          % "|".join(PORT_KERNELS))
SPAN = "texbench.window"


@dataclass
class Reading:
    """What a traced span showed. Times in seconds."""

    span_s: float
    busy_s: float
    kernels: list = field(default_factory=list)  # [(name, seconds)]
    copies: list = field(default_factory=list)   # [(name, seconds)]
    idle_gaps: list = field(default_factory=list)  # [(host label, seconds)]
    mpix: float = 0.0            # level-0 megapixels of the span's work
    least_s: float | None = None  # the port's kernels' least time
    recorded_kernels: int = 0     # kernels the recorded wrapper calls launched
    stage_host_s: dict | None = None  # the pipeline's StageTimes.host_s

    def port_kernels(self) -> list:
        return [(n, s) for n, s in self.kernels if _PORT_KERNEL.match(n)]

    # The arithmetic of the per-layer readers (texbench/metrics/).

    def idle_pct(self) -> float | None:
        """Share of the span with no kernel or copy on the device."""
        if self.span_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.span_s)

    def roofline_pct(self) -> float | None:
        """The port's kernels' least time over their device time, when the
        recorded wrapper calls account for exactly the port's kernels the
        profiler saw."""
        port = self.port_kernels()
        device_s = sum(s for _, s in port)
        if (self.least_s is None or not port or device_s <= 0
                or len(port) != self.recorded_kernels):
            return None
        return 100.0 * self.least_s / device_s

    def host_pct(self) -> float | None:
        """The pipeline's own host stages (stacking and container packing,
        StageTimes.host_s) over the span."""
        if not self.stage_host_s or self.span_s <= 0:
            return None
        return 100.0 * sum(self.stage_host_s.values()) / self.span_s

    def kernels_per_mpix(self) -> float | None:
        """Device kernels, the port's and PyTorch's, per megapixel."""
        if not self.kernels or self.mpix <= 0:
            return None
        return len(self.kernels) / self.mpix

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        by_name: dict = {}
        for n, s in self.kernels + self.copies:
            by_name[n] = by_name.get(n, 0.0) + s
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], s] for n, s in ranked]

    def top_idle_gaps(self, top: int = 10) -> list:
        by_label: dict = {}
        for label, s in self.idle_gaps:
            by_label[label] = by_label.get(label, 0.0) + s
        ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], s] for n, s in ranked]


def _ns(ev, what: str) -> int:
    """An event's start or duration in ns, whichever the torch has."""
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")() * 1000)


def raw_events(prof) -> tuple[list, list]:
    """(host events, device events) of a finished profile, each a list of
    (name, start ns, end ns)."""
    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        item = (ev.name(), start, start + _ns(ev, "duration"))
        if "CUDA" not in str(ev.device_type()):
            host.append(item)
        elif not (ev.name().startswith("texbench.")
                  or getattr(ev, "is_user_annotation", lambda: False)()):
            # The device timeline also carries the host's annotations.
            device.append(item)
    return host, device


def _union(intervals: list) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps: list, host: list) -> list:
    """Name each idle gap by the innermost host event that covers its
    middle: [(label, seconds)]."""
    queries = sorted(((s + e) / 2, e - s) for s, e in gaps)
    events = sorted(host, key=lambda h: h[1])
    heap: list = []
    out, k = [], 0
    for mid, length in queries:
        while k < len(events) and events[k][1] <= mid:
            name, s, e = events[k]
            heapq.heappush(heap, (e - s, e, name))
            k += 1
        # Past the ended ones, the shortest open event covers the middle:
        # a longer one that has ended is never on top.
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out.append((heap[0][2] if heap else "no_host_event", length / 1e9))
    return out


def reduce(host: list, device: list) -> Reading:
    """The span's reading from raw events (see :func:`raw_events`)."""
    spans = [(s, e) for n, s, e in host if n == SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    t0, t1 = min(s for s, _ in spans), max(e for _, e in spans)
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in device
              if e > t0 and s < t1]
    kernels, copies = [], []
    for n, s, e in inside:
        (copies if n.startswith(("Memcpy", "Memset")) else kernels).append(
            (n, (e - s) / 1e9))
    busy = _union([[s, e] for _, s, e in inside])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host_in = [(n, s, e) for n, s, e in host
               if n != SPAN and e > t0 and s < t1]
    return Reading(span_s=(t1 - t0) / 1e9,
                   busy_s=sum(e - s for s, e in busy) / 1e9,
                   kernels=kernels, copies=copies,
                   idle_gaps=_label_gaps(gaps, host_in))
