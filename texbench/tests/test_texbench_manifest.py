"""BENCHMARK.json loads, keeps to its contract's shape, and every name in
it finds its file."""

import json
import re

import pytest

from texbench.manifest import HERE, ROOT, Manifest

MAN = Manifest()
D = MAN.data
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_keys():
    assert set(D) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert D["paths"] == ["texbench"]
    assert 1 <= D["run_seconds"] <= 51
    assert len(json.dumps(D)) < 64 * 1024
    for c in D["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in D["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in D["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in D["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in D[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for m in D["end_to_end"] + D["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in D["configs"] + D["workloads"]:
        assert LINE.match(x["why"])
    for m in D["per_layer"]:
        assert LINE.match(m["layer"])
    for c in D["configs"]:
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_name_finds_its_file():
    for c in D["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("texbench/")
        assert set(c["reduced"]) <= set(json.loads(path.read_text())["reduced"])
    assert len({c["source"] for c in D["configs"]}) == len(D["configs"])
    used = {w["config"] for w in D["workloads"]}
    assert used == {c["name"] for c in D["configs"]}
    for w in D["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1
    for m in D["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in D["workloads"]])
def test_each_cell_reports_what_the_contract_asks(cell):
    e2e = {m["name"] for m in MAN.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = MAN.per_layer(cell)
    assert layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], cell)
    mix = MAN.traffic(MAN.cell(cell)["traffic"])
    assert set(mix["metrics"]) == e2e - {"setup_s"}


def test_per_layer_metrics_move_a_metric_of_every_cell_they_list():
    for m in D["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in MAN.end_to_end(cell)}


def test_a_metric_of_one_layer_names_it_alike():
    layers = {m["layer"] for m in D["per_layer"]}
    assert layers == {"HQ codecs", "Kernels", "Device"}


def test_the_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (D["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
