"""Cells by name for the tests: those of ``BENCHMARK.json``, and the
cells PERF.md keeps for a later benchmark change, whose mixes stay in
``texbench/traffic/`` so that the change adds only an entry. Their
inputs, their comparison and their faults are tested all the same."""

from texbench.manifest import Manifest

MAN = Manifest()

LATER = [{"name": "fleet5.ref", "config": "fleet5", "traffic": "fleet_ref",
          "chips": 1},
         {"name": "fleet5.mip", "config": "fleet5", "traffic": "fleet_mip",
          "chips": 1}]

NAMES = [w["name"] for w in MAN.data["workloads"]] + [c["name"] for c in LATER]


def cell(name: str) -> dict:
    for c in LATER:
        if c["name"] == name:
            return c
    return MAN.cell(name)
