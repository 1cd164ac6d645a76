"""The comparison that decides ``correct`` fails its control and each
fault a cell can have, and passes the port: at small sizes on the CPU,
driving the rest of a run (the look for a card skipped), with the timed
path broken underneath."""

import pytest
import torch

from texbench import control, run
from texbench.manifest import Manifest
from texcomp_torch.dist import pipeline
from texcomp_torch.ops import etc_cuda

from cells import cell as cell_named

MAN = Manifest()


def small(cell: str):
    c = cell_named(cell)
    config, mix = MAN.config(c["config"]), MAN.traffic(c["traffic"])
    if "sizes" in config:
        config["sizes"] = [[64, 6], [128, 3]]
        mix["sample_every"] = 2
    else:
        config["side"] = 32
        mix["pool"] = 2
    return c, config, mix


def run_small(cell: str, seed: int = 2**31 + 7):
    c, config, mix = small(cell)
    result, _ = run.run_cell(MAN, c, seed, 0.5, False, "cpu", config=config,
                             mix=mix)
    return result


@pytest.mark.parametrize("cell", ["fleet5.ref", "fleet5.mip", "etc1k.hq"])
def test_the_port_passes_and_the_control_fails(cell):
    _, config, mix = small(cell)
    got = control.readings(cell, 11, "cpu", config=config, mix=mix)
    assert all(v == 0 for v in got["program"].values())
    assert got["control"]["wrong_payloads"] > 0
    assert run_small(cell)["correct"]


def _altered_batch(monkeypatch):
    encode = pipeline._batch_encode

    def altered(images, *args, **kwargs):
        out = encode(images, *args, **kwargs).clone()
        out[0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(pipeline, "_batch_encode", altered)


def _half_batch(monkeypatch):
    encode = pipeline._batch_encode

    def half(images, *args, **kwargs):
        b = images.shape[0]
        out = encode(images[:max(1, b // 2)], *args, **kwargs)
        return torch.cat([out, out, out])[:b]

    monkeypatch.setattr(pipeline, "_batch_encode", half)


def _altered_tail(monkeypatch):
    step = pipeline._tail_step_batched

    def altered(*args, **kwargs):
        out = step(*args, **kwargs).clone()
        out[-1, 0, 0] ^= 1
        return out

    monkeypatch.setattr(pipeline, "_tail_step_batched", altered)


def _altered_search(monkeypatch):
    search = etc_cuda.etc1_hq_search

    def altered(pixels, cands, flip):
        hi, lo, err = search(pixels, cands, flip)
        lo = lo.clone()
        lo[0] ^= 1
        return hi, lo, err

    monkeypatch.setattr(etc_cuda, "etc1_hq_search", altered)


def _half_blocks(monkeypatch):
    encode = etc_cuda.etc1_hq_encode_blocks

    def half(rgb):
        n = rgb.shape[0]
        out = encode(rgb[: n // 2])
        return torch.cat([out, out])[:n]

    monkeypatch.setattr(etc_cuda, "etc1_hq_encode_blocks", half)


@pytest.mark.parametrize("cell,fault", [
    ("fleet5.ref", _altered_batch), ("fleet5.ref", _half_batch),
    ("fleet5.mip", _altered_tail), ("fleet5.mip", _half_batch),
    ("etc1k.hq", _altered_search), ("etc1k.hq", _half_blocks)],
    ids=lambda x: getattr(x, "__name__", x))
def test_each_fault_fails(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run_small(cell)
    assert not result["correct"]
    assert result["checks"]["wrong_payloads"]["value"] > 0
