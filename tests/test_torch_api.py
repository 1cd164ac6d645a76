"""The slice as a whole: texcomp_torch.DxtcCompressor(device="cpu") against
texcomp.DxtcCompressor() on the CPU, byte for byte, for all four formats and
every operation of the Compressor API; payloads carried between the two
packages; and the port's hygiene (no JAX, no silent device fallback).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import texcomp
import texcomp_torch

ROOT = Path(__file__).resolve().parent.parent
FORMATS = [0, 1, 2, 3]  # RGB, BGR -> DXT1; RGBA, BGRA -> DXT5


def _comps(fmt):
    return 3 if fmt < 2 else 4


def _buffer(rng, h, w, c, padding):
    """A row-padded input buffer with noise in the padding bytes."""
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[: h // 2, : w // 2] = img[0, 0]  # solid blocks: const-color path
    if c == 4:
        img[h // 2 :, :, 3] = 255
    bpr = w * c + padding
    buf = rng.integers(0, 256, (h - 1) * bpr + w * c, dtype=np.uint8)
    for y in range(h):
        buf[y * bpr : y * bpr + w * c] = img[y].reshape(-1)
    return buf.tobytes()


def _pair():
    return texcomp.DxtcCompressor(), texcomp_torch.DxtcCompressor(device="cpu")


def _compress_both(rng, fmt, h, w, padding=0):
    jc, tc = _pair()
    buf = _buffer(rng, h, w, _comps(fmt), padding)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress(texcomp.Format(fmt), h, w, padding, buf, ji)
    assert tc.compress(texcomp_torch.Format(fmt), h, w, padding, buf, ti)
    return (jc, ji), (tc, ti)


def _assert_same(ti, ji):
    np.testing.assert_array_equal(ti.get_data(), ji.get_data())
    assert ti.to_arrays()[0] == _md_dict(ji)


def _md_dict(image):
    md = image.get_metadata()
    return {"format": int(md.format), "compressor_name": md.compressor_name,
            "uncompressed_height": md.uncompressed_height,
            "uncompressed_width": md.uncompressed_width,
            "compressed_height": md.compressed_height,
            "compressed_width": md.compressed_width,
            "padding_bytes_per_row": md.padding_bytes_per_row}


@pytest.mark.parametrize("padding", [0, 3])
@pytest.mark.parametrize("h,w", [(57, 33), (2, 5), (64, 48)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_compress_decompress(rng, fmt, h, w, padding):
    (jc, ji), (tc, ti) = _compress_both(rng, fmt, h, w, padding)
    _assert_same(ti, ji)
    jbuf, tbuf = bytearray(), bytearray()
    assert jc.decompress(ji, jbuf)
    assert tc.decompress(ti, tbuf)
    assert tbuf == jbuf


@pytest.mark.parametrize("fmt", FORMATS)
def test_compress_and_pad(rng, fmt):
    jc, tc = _pair()
    h, w, ph, pw, padding = 21, 18, 40, 36, 3
    buf = _buffer(rng, h, w, _comps(fmt), padding)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress_and_pad(texcomp.Format(fmt), h, w, ph, pw, padding, buf, ji)
    assert tc.compress_and_pad(texcomp_torch.Format(fmt), h, w, ph, pw, padding,
                               buf, ti)
    _assert_same(ti, ji)
    # A padded payload decodes sequentially over the uncompressed grid.
    jbuf, tbuf = bytearray(), bytearray()
    assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf


@pytest.mark.parametrize("fmt", FORMATS)
def test_pad(rng, fmt):
    (jc, ji), (tc, ti) = _compress_both(rng, fmt, 20, 12)
    for ph, pw in [(32, 28), (20, 28), (32, 12), (8, 8)]:
        jo, to = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
        assert jc.pad(ji, ph, pw, jo) and tc.pad(ti, ph, pw, to)
        _assert_same(to, jo)


@pytest.mark.parametrize("h,w", [(64, 48), (8, 8), (2, 2), (1, 4), (3, 4),
                                 (12, 8)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_downsample(rng, fmt, h, w):
    """Per-level route: decode, 2x2 truncating average, encode; including
    the single-block cases and grids that cannot be downsampled."""
    (jc, ji), (tc, ti) = _compress_both(rng, fmt, h, w)
    jo, to = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    ok = jc.downsample(ji, jo)
    assert tc.downsample(ti, to) == ok
    if ok:
        _assert_same(to, jo)


@pytest.mark.parametrize("fmt", FORMATS)
def test_create_solid_image(fmt):
    jc, tc = _pair()
    color = np.array([13, 77, 200, 128], dtype=np.uint8)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.create_solid_image(texcomp.Format(fmt), 12, 20, color, ji)
    assert tc.create_solid_image(texcomp_torch.Format(fmt), 12, 20, color, ti)
    _assert_same(ti, ji)


@pytest.mark.parametrize("fmt", FORMATS)
def test_copy_subimage(rng, fmt):
    (jc, ji), (tc, ti) = _compress_both(rng, fmt, 24, 32)
    for args in [(4, 8, 16, 12), (0, 0, 24, 32), (2, 0, 4, 4), (20, 28, 8, 8)]:
        jo, to = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
        ok = jc.copy_subimage(ji, *args, jo)
        assert tc.copy_subimage(ti, *args, to) == ok
        if ok:
            _assert_same(to, jo)


@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_payload_decodes_in_port(rng, fmt):
    """A payload made by texcomp, carried by from_arrays, decodes to the
    same bytes in texcomp_torch."""
    jc, tc = _pair()
    h, w = 22, 30
    buf = _buffer(rng, h, w, _comps(fmt), 0)
    ji = texcomp.CompressedImage()
    assert jc.compress(texcomp.Format(fmt), h, w, 0, buf, ji)
    ti = texcomp_torch.CompressedImage.from_arrays(_md_dict(ji), ji.get_data())
    assert tc.is_valid_compressed_image(ti)
    jbuf, tbuf = bytearray(), bytearray()
    assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_payload_decodes_in_jax(rng, fmt):
    """The reverse: a texcomp_torch payload, exported by to_arrays, decodes
    to the same bytes in texcomp."""
    jc, tc = _pair()
    h, w = 22, 30
    buf = _buffer(rng, h, w, _comps(fmt), 0)
    ti = texcomp_torch.CompressedImage()
    assert tc.compress(texcomp_torch.Format(fmt), h, w, 0, buf, ti)
    md, data = ti.to_arrays()
    ji = texcomp.CompressedImage()
    ji.create_owned_data(texcomp.Metadata(**{**md, "format": texcomp.Format(md["format"])}),
                         data.size)
    ji.get_mutable_data()[:] = data
    assert jc.is_valid_compressed_image(ji)
    jbuf, tbuf = bytearray(), bytearray()
    assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf


def test_port_imports_no_jax():
    """Every module of texcomp_torch, and chip_smoke.py, import without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import texcomp_torch\n"
        "for m in pkgutil.walk_packages(texcomp_torch.__path__, 'texcomp_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'texcomp.')) or k == 'texcomp')\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_cuda_device_without_cuda_raises(rng):
    """DxtcCompressor(device="cuda") raises where there is no CUDA device;
    it never returns bytes made on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    comp = texcomp_torch.DxtcCompressor(device="cuda")
    ci = texcomp_torch.CompressedImage()
    with pytest.raises((AssertionError, RuntimeError)):
        comp.compress(texcomp_torch.Format.RGB, 8, 8, 0, _buffer(rng, 8, 8, 3, 0), ci)


def test_default_device_is_cuda(rng):
    """DxtcCompressor() runs on the card unless the caller asks for the CPU:
    where there is no CUDA device its first operation raises, and it never
    returns bytes made on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    comp = texcomp_torch.DxtcCompressor()
    ci = texcomp_torch.CompressedImage()
    with pytest.raises((AssertionError, RuntimeError)):
        comp.compress(texcomp_torch.Format.RGB, 8, 8, 0, _buffer(rng, 8, 8, 3, 0), ci)
    assert ci.get_data_size() == 0 or not ci.get_data().any()


@pytest.mark.parametrize("name", ["dxt.cu", "shared.cuh", "tables.h"])
def test_library_hash_covers_every_source(tmp_path, name):
    """Touching any source under csrc/, a header included, names another
    library, so a stale build is never loaded."""
    import shutil

    from texcomp_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    (csrc / "shared.cuh").write_text("// shared device helpers\n")
    (csrc / "tables.h").write_text("// tables\n")
    before = _build.library_path(csrc)
    assert _build.library_path(csrc) == before
    with open(csrc / name, "a") as f:
        f.write("// touched\n")
    touched = _build.library_path(csrc)
    assert touched != before
    (csrc / "notes.txt").write_text("not a source")
    assert _build.library_path(csrc) == touched


def test_signatures_name_every_entry_point():
    """Every C entry point in csrc/*.cu has its argtypes in SIGNATURES."""
    import re

    from texcomp_torch.ops import _build

    entries = set()
    for src in _build.CSRC_DIR.glob("*.cu"):
        entries |= set(re.findall(r"^int (texcomp_\w+)\(", src.read_text(), re.M))
    assert entries == set(_build.SIGNATURES)


def test_quality_high_not_ported(rng):
    """quality="high" raised NotImplementedError until the HQ DXTC slice;
    now DxtcCompressor("high") compresses and builds its mip chain as
    texcomp's does (PVRTC HQ: test_torch_pvrtc_api.py and
    test_torch_pvrtc_hq.py). An unknown quality still raises."""
    h, w = 16, 32
    buf = _buffer(rng, h, w, 4, 0)
    jc = texcomp.DxtcCompressor("high")
    tc = texcomp_torch.DxtcCompressor("high", device="cpu")
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress(texcomp.Format.RGBA, h, w, 0, buf, ji)
    assert tc.compress(texcomp_torch.Format.RGBA, h, w, 0, buf, ti)
    _assert_same(ti, ji)
    jchain, tchain = jc.downsample_chain(ji), tc.downsample_chain(ti)
    assert len(tchain) == len(jchain) == 5
    for jl, tl in zip(jchain, tchain):
        _assert_same(tl, jl)
    with pytest.raises(ValueError):
        texcomp_torch.DxtcCompressor("best", device="cpu")
