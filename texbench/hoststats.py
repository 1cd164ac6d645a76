"""What the host did during each unit of a window, printed beside it.

Every cell is paced by the host, so a window that runs slow has to be put
down to something the host did: more work in the kernel (system CPU
seconds), less of the CPU for the same work (user CPU seconds that grow
with the unit's wall time), or the garbage collector. Each unit records
the process's user and system CPU seconds (``getrusage``) and the
collector's seconds. Reading them costs some microseconds a unit. (Page
faults, context switches, steal time and the CPU a process is on are not
read: some hosts report them all as 0.)
"""

from __future__ import annotations

import gc
import resource
import time


class UnitStats:
    """Context manager open over a window; :meth:`mark` after each unit."""

    KEYS = ("user_s", "sys_s", "gc_s")

    def __init__(self):
        self.units: dict = {k: [] for k in self.KEYS}
        self._gc_s = 0.0
        self._gc_t0 = None
        self._last = None

    def _callback(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._gc_s += time.perf_counter() - self._gc_t0

    def _now(self) -> tuple:
        r = resource.getrusage(resource.RUSAGE_SELF)
        return r.ru_utime, r.ru_stime, self._gc_s

    def __enter__(self):
        gc.callbacks.append(self._callback)
        self._last = self._now()
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False

    def mark(self) -> None:
        now = self._now()
        for k, a, b in zip(self.KEYS, self._last, now):
            self.units[k].append(b - a)
        self._last = now

    def summary(self) -> dict:
        """Per key, the window's total and the per-unit values."""
        return {k: {"total": round(sum(v), 4),
                    "per_unit": [round(x, 4) for x in v]}
                for k, v in self.units.items()}
