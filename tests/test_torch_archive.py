"""Texture archives ("TXC1") and the utils facade: texcomp_torch.utils
against texcomp.utils on the CPU.

An archive written by either package loads in the other, and for the same
images both write the same file bytes.
"""

import numpy as np
import pytest
import torch

import texcomp
import texcomp_torch
from texcomp.utils import load_archive as jload
from texcomp.utils import save_archive as jsave
from texcomp_torch.utils import (device_trace, load_archive, save_archive,
                                 throughput)
from tests.conftest import make_test_image


def _entries(pkg, rng, **kw):
    """The same textures compressed by one package: DXT1, DXT5, ETC1, a
    padded-row DXT1, PVRTC 2bpp and 4bpp, and a name with a slash and a
    non-ASCII letter."""
    out = {}
    specs = [
        ("a/dxt1", pkg.DxtcCompressor(**kw), pkg.Format.RGB, 20, 24, 0),
        ("b/dxt5", pkg.DxtcCompressor(**kw), pkg.Format.RGBA, 16, 16, 0),
        ("c/etc", pkg.EtcCompressor(**kw), pkg.Format.RGB, 12, 8, 0),
        ("d/padded", pkg.DxtcCompressor(**kw), pkg.Format.BGR, 8, 12, 5),
        ("e/pvrtc", pkg.PvrtcCompressor(**kw), pkg.Format.RGBA, 32, 32, 0),
        ("f/pvrtc4 é", pkg.Pvrtc4bppCompressor(**kw), pkg.Format.RGBA, 16,
         16, 0),
    ]
    for name, comp, fmt, h, w, pad in specs:
        c = 3 if fmt in (pkg.Format.RGB, pkg.Format.BGR) else 4
        img = make_test_image(rng, h, w, c).reshape(h, -1)
        rows = np.concatenate([img, np.zeros((h, pad), np.uint8)], axis=1)
        ci = pkg.CompressedImage()
        assert comp.compress(fmt, h, w, pad, rows.tobytes(), ci), name
        out[name] = ci
    return out


def _fields(ci):
    md = ci.get_metadata()
    return (int(md.format), md.compressor_name, md.uncompressed_height,
            md.uncompressed_width, md.compressed_height, md.compressed_width,
            md.padding_bytes_per_row, ci.get_data().tobytes())


@pytest.fixture()
def both(rng):
    seed = int(rng.integers(1 << 30))
    ours = _entries(texcomp_torch, np.random.default_rng(seed), device="cpu")
    theirs = _entries(texcomp, np.random.default_rng(seed))
    return ours, theirs


def test_same_textures_same_entries(both):
    ours, theirs = both
    assert list(ours) == list(theirs)
    for name in ours:
        assert _fields(ours[name]) == _fields(theirs[name]), name


def test_both_packages_write_the_same_bytes(both, tmp_path):
    ours, theirs = both
    save_archive(str(tmp_path / "port.txc"), ours)
    jsave(str(tmp_path / "texcomp.txc"), theirs)
    assert ((tmp_path / "port.txc").read_bytes()
            == (tmp_path / "texcomp.txc").read_bytes())


@pytest.mark.parametrize("writer,reader", [(jsave, load_archive),
                                           (save_archive, jload),
                                           (save_archive, load_archive)])
def test_cross_load(both, tmp_path, writer, reader):
    ours, theirs = both
    src = theirs if writer is jsave else ours
    path = str(tmp_path / "x.txc")
    writer(path, src)
    loaded = reader(path)
    assert list(loaded) == list(src)
    for name in src:
        assert _fields(loaded[name]) == _fields(src[name]), name


def test_loaded_archive_decodes(both, tmp_path):
    """Entries texcomp wrote decode in the port as the port's own do."""
    ours, theirs = both
    jsave(str(tmp_path / "t.txc"), theirs)
    loaded = load_archive(str(tmp_path / "t.txc"))
    comp = texcomp_torch.DxtcCompressor(device="cpu")
    for name in ("a/dxt1", "b/dxt5"):
        a, b = bytearray(), bytearray()
        assert comp.decompress(loaded[name], a)
        assert comp.decompress(ours[name], b)
        assert a == b


def test_empty_archive_and_bad_magic(tmp_path):
    path = str(tmp_path / "e.txc")
    save_archive(path, {})
    assert load_archive(path) == {}
    assert jload(path) == {}
    (tmp_path / "bad.txc").write_bytes(b"TXC0\0\0\0\0")
    with pytest.raises(ValueError, match="not a texcomp archive"):
        load_archive(str(tmp_path / "bad.txc"))


def test_device_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with device_trace(str(logdir), device="cpu") as d:
        assert d == str(logdir)
        (torch.arange(1000) * 2).sum()
    traces = list(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_throughput_needs_the_card():
    """CUDA events time the card only: on the CPU it raises, it does not
    fall back to a host clock."""
    x = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        throughput(lambda v: v + 1, x, pixels=16, device="cpu")
