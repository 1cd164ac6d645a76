"""The request client on the CPU: the compressor of each codec, the pool
cycled in order, the HQ ETC1 cell's requests as before, and no codec or
quality without a reference and a control."""

import json

import pytest

from texbench import inputs
from texbench.drive import Requests
from texbench.manifest import HERE, Manifest
from texcomp_torch import (DxtcCompressor, EtcCompressor, Format,
                           Pvrtc4bppCompressor, PvrtcCompressor)

MAN = Manifest()
CONTENT = json.loads((HERE / "configs" / "fleet5.json").read_text())["content"]
MIX = {"entry": "compress", "pool": 3, "warmup": 1, "trace_units": 1,
       "metrics": {"hq_mpix_s": "rate"}}


def config(codec, quality="high", **extra):
    return {"codec": codec, "quality": quality, "side": 16, "kind": "banded",
            "content": CONTENT, **extra}


@pytest.mark.parametrize("codec,cls,fmt,channels", [
    ("dxt1", DxtcCompressor, Format.RGB, 3),
    ("dxt5", DxtcCompressor, Format.RGBA, 4),
    ("etc1", EtcCompressor, Format.RGB, 3),
    ("pvrtc", PvrtcCompressor, Format.RGBA, 4),
    ("pvrtc4", Pvrtc4bppCompressor, Format.RGBA, 4)])
def test_each_codec_gets_its_compressor(codec, cls, fmt, channels):
    client = Requests(config(codec), MIX, 5, "cpu")
    assert type(client.comp) is cls and client.comp._quality == "high"
    assert client.format == fmt
    assert [img.shape for img in client.images] == [(16, 16, channels)] * 3
    assert client.mpix == 16 * 16 / 1e6


@pytest.mark.parametrize("codec", ["dxt5", "pvrtc4"])
def test_requests_cycle_the_pool_in_order(codec):
    client = Requests(config(codec), {**MIX, "pool": 2}, 5, "cpu")
    for _ in range(5):
        client.unit()
    assert [k for k, _, _ in client.answers] == [0, 1, 0, 1, 0]
    name = {"dxt5": "dxtc", "pvrtc4": "pvrtc4"}[codec]
    assert all(got[0][:2] == (2, name) for _, got, _ in client.answers)
    readings, attempted, failed, checked = client.check()
    assert all(v == 0 for v, _ in readings.values())
    assert (attempted, failed, checked) == (5, 0, 5)


@pytest.mark.parametrize("codec,quality", [
    ("dxt1", "reference"), ("etc1", "reference"), ("pvrtc", "reference"),
    ("bc7", "high")])
def test_a_pair_with_no_reference_or_control_raises(codec, quality):
    with pytest.raises(ValueError, match="no reference and control"):
        Requests(config(codec, quality), MIX, 5, "cpu")


@pytest.mark.parametrize("codec,channels", [("dxt1", 4), ("pvrtc", 3)])
def test_channels_other_than_the_codec_encodes_raise(codec, channels):
    with pytest.raises(ValueError, match="channels"):
        Requests(config(codec, channels=channels), MIX, 5, "cpu")


def test_the_hq_etc1_cell_makes_its_requests_as_before():
    """The pool request_pool makes, request i on pool image i % pool, one
    EtcCompressor of the configured strategy on RGB."""
    c = MAN.cell("etc1k.hq")
    cfg, mix = MAN.config(c["config"]), MAN.traffic(c["traffic"])
    cfg["side"] = 16
    client = Requests(cfg, mix, 9, "cpu")
    want = inputs.request_pool(cfg, mix["pool"], 9, "cpu")
    assert all((a == b).all() for a, b in zip(client.images, want))
    assert [img.shape for img in client.images] == [(16, 16, 3)] * mix["pool"]
    assert isinstance(client.comp, EtcCompressor)
    assert client.format == Format.RGB
    assert client.comp.get_compression_strategy() == cfg["strategy"]
    for _ in range(mix["pool"] + 1):
        client.unit()
    assert [k for k, _, _ in client.answers] == [
        i % mix["pool"] for i in range(mix["pool"] + 1)]
