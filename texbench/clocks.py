"""The card's SM clock, power draw and temperature beside a window, read
with ``nvidia-smi`` (read only, one sample every ``interval_ms``)."""

from __future__ import annotations

import shutil
import statistics
import subprocess

QUERY = "clocks.sm,power.draw,temperature.gpu"


class Clocks:
    """Context manager: samples while open. Without ``nvidia-smi`` it
    records nothing."""

    def __init__(self, interval_ms: int = 500, index: int = 0):
        self.cmd = ["nvidia-smi", f"--query-gpu={QUERY}",
                    "--format=csv,noheader,nounits", "-lms", str(interval_ms),
                    "-i", str(index)]
        self.proc = None
        self.samples: list[tuple[float, float, float]] = []

    def __enter__(self):
        if shutil.which("nvidia-smi"):
            self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                self.samples.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                continue
        return False

    def summary(self) -> dict | None:
        """n, and [min, median, max] of each quantity; None if unsampled."""
        if not self.samples:
            return None
        cols = list(zip(*self.samples))
        return {"n": len(self.samples),
                **{k: [min(c), statistics.median(c), max(c)] for k, c in
                   zip(("sm_mhz", "power_w", "temp_c"), cols)}}


def card() -> dict | None:
    """The card's name and power limit in W, or None."""
    if not shutil.which("nvidia-smi"):
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, timeout=30).stdout
    name, _, limit = out.strip().rpartition(",")
    return {"name": name.strip(), "power_limit_w": limit.strip()}
