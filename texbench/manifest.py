"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``texbench/configs/<config>.json``, its traffic
mix ``texbench/traffic/<traffic>.json`` and each per-layer metric a reader
``texbench/metrics/<metric>.py`` with a function ``read(reading)``. A
later change adds a cell, a mix or a metric as new files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.data = json.loads(path.read_text())
        self.root = path.parent

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file as ``BENCHMARK.json`` names it, else
        ``texbench/configs/<name>.json`` (one no cell uses yet)."""
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        return json.loads((HERE / "configs" / f"{name}.json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    @staticmethod
    def _in(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.data["end_to_end"] if self._in(m, cell)]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics read in ``cell``: those that list it, and
        those that list no cells and move an end-to-end metric it
        reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in reported)]


def reader(metric: str):
    """The ``read`` function of ``texbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"texbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
