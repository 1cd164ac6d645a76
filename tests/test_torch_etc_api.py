"""The ETC1 slice as a whole: texcomp_torch.EtcCompressor(device="cpu") and
transcode_dxt1_to_etc1 against texcomp's on the CPU, byte for byte, for
all four strategies and every operation of the Compressor API; payloads
carried between the two packages; and no silent device fallback.
"""

import numpy as np
import pytest
import torch

import texcomp
import texcomp_torch
from texcomp_torch.codecs import dxt as tdxt
from texcomp_torch.codecs import etc as tetc

STRATEGIES = [0, 1, 2, 3]
RGB = 0


def _buffer(rng, h, w, padding):
    """A row-padded RGB buffer with noise in the padding bytes."""
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[: h // 2, : w // 2] = img[0, 0]  # solid blocks
    bpr = w * 3 + padding
    buf = rng.integers(0, 256, (h - 1) * bpr + w * 3, dtype=np.uint8)
    for y in range(h):
        buf[y * bpr : y * bpr + w * 3] = img[y].reshape(-1)
    return buf.tobytes()


def _pair(strategy):
    return (texcomp.EtcCompressor(texcomp.CompressionStrategy(strategy)),
            texcomp_torch.EtcCompressor(texcomp_torch.CompressionStrategy(strategy),
                                        device="cpu"))


def _md_dict(image):
    md = image.get_metadata()
    return {"format": int(md.format), "compressor_name": md.compressor_name,
            "uncompressed_height": md.uncompressed_height,
            "uncompressed_width": md.uncompressed_width,
            "compressed_height": md.compressed_height,
            "compressed_width": md.compressed_width,
            "padding_bytes_per_row": md.padding_bytes_per_row}


def _assert_same(ti, ji):
    np.testing.assert_array_equal(ti.get_data(), ji.get_data())
    assert ti.to_arrays()[0] == _md_dict(ji)


def _compress_both(rng, strategy, h, w, padding=0):
    jc, tc = _pair(strategy)
    buf = _buffer(rng, h, w, padding)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress(texcomp.Format.RGB, h, w, padding, buf, ji)
    assert tc.compress(texcomp_torch.Format.RGB, h, w, padding, buf, ti)
    return (jc, ji), (tc, ti)


@pytest.mark.parametrize("h,w,padding", [(28, 20, 0), (2, 5, 3), (21, 14, 0)])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_compress_decompress(rng, strategy, h, w, padding):
    (jc, ji), (tc, ti) = _compress_both(rng, strategy, h, w, padding)
    _assert_same(ti, ji)
    jbuf, tbuf = bytearray(), bytearray()
    assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_compress_and_pad(rng, strategy):
    jc, tc = _pair(strategy)
    h, w, ph, pw = 10, 14, 24, 20
    buf = _buffer(rng, h, w, 0)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress_and_pad(texcomp.Format.RGB, h, w, ph, pw, 0, buf, ji)
    assert tc.compress_and_pad(texcomp_torch.Format.RGB, h, w, ph, pw, 0, buf, ti)
    _assert_same(ti, ji)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pad(rng, strategy):
    (jc, ji), (tc, ti) = _compress_both(rng, strategy, 20, 12)
    for ph, pw in [(28, 24), (20, 24), (28, 12), (8, 8)]:
        jo, to = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
        assert jc.pad(ji, ph, pw, jo) and tc.pad(ti, ph, pw, to)
        _assert_same(to, jo)


@pytest.mark.parametrize("h,w", [(16, 24), (8, 8), (2, 2), (1, 4), (3, 4),
                                 (12, 8), (30, 30)])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_downsample(rng, strategy, h, w):
    """The fused route on grids of more than one block each way, the
    level-by-level route on single-block rows and columns, and grids that
    cannot be downsampled."""
    (jc, ji), (tc, ti) = _compress_both(rng, strategy, h, w)
    jo, to = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    ok = jc.downsample(ji, jo)
    assert tc.downsample(ti, to) == ok
    if ok:
        _assert_same(to, jo)


@pytest.mark.parametrize("color", [(13, 77, 200), (1, 2, 3), (255, 0, 128)])
def test_create_solid_image(color):
    jc, tc = _pair(2)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    c = np.array(color, dtype=np.uint8)
    assert jc.create_solid_image(texcomp.Format.RGB, 12, 20, c, ji)
    assert tc.create_solid_image(texcomp_torch.Format.RGB, 12, 20, c, ti)
    _assert_same(ti, ji)


def test_copy_subimage(rng):
    (jc, ji), (tc, ti) = _compress_both(rng, 2, 24, 32)
    for args in [(4, 8, 16, 12), (0, 0, 24, 32), (2, 0, 4, 4), (20, 28, 8, 8)]:
        jo, to = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
        ok = jc.copy_subimage(ji, *args, jo)
        assert tc.copy_subimage(ti, *args, to) == ok
        if ok:
            _assert_same(to, jo)


def test_format_and_size_rules():
    jc, tc = _pair(2)
    for fmt in range(4):
        assert tc.supports_format(texcomp_torch.Format(fmt)) == \
            jc.supports_format(texcomp.Format(fmt))
        for h, w in [(0, 4), (4, 4), (5, 9), (1, 1)]:
            assert tc.compute_compressed_data_size(
                texcomp_torch.Format(fmt), h, w) == \
                jc.compute_compressed_data_size(texcomp.Format(fmt), h, w)
    ti = texcomp_torch.CompressedImage()
    assert not tc.compress(texcomp_torch.Format.RGBA, 4, 4, 0, bytes(64), ti)
    assert not tc.is_valid_compressed_image(ti)


def test_strategy_get_and_set():
    tc = texcomp_torch.EtcCompressor(device="cpu")
    assert tc.get_compression_strategy() == texcomp_torch.CompressionStrategy.SMALLER_ERROR
    tc.set_compression_strategy(texcomp_torch.CompressionStrategy.HEURISTIC)
    assert tc.get_compression_strategy() == 3
    assert [int(s) for s in texcomp_torch.CompressionStrategy] == \
        [int(s) for s in texcomp.CompressionStrategy]


def test_jax_payload_decodes_in_port(rng):
    jc, tc = _pair(2)
    buf = _buffer(rng, 22, 30, 0)
    ji = texcomp.CompressedImage()
    assert jc.compress(texcomp.Format.RGB, 22, 30, 0, buf, ji)
    ti = texcomp_torch.CompressedImage.from_arrays(_md_dict(ji), ji.get_data())
    assert tc.is_valid_compressed_image(ti)
    jbuf, tbuf = bytearray(), bytearray()
    assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf


def test_port_payload_decodes_in_jax(rng):
    jc, tc = _pair(2)
    buf = _buffer(rng, 22, 30, 0)
    ti = texcomp_torch.CompressedImage()
    assert tc.compress(texcomp_torch.Format.RGB, 22, 30, 0, buf, ti)
    md, data = ti.to_arrays()
    ji = texcomp.CompressedImage()
    ji.create_owned_data(
        texcomp.Metadata(**{**md, "format": texcomp.Format(md["format"])}),
        data.size)
    ji.get_mutable_data()[:] = data
    assert jc.is_valid_compressed_image(ji)
    jbuf, tbuf = bytearray(), bytearray()
    assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf


# --- the transcoder ---------------------------------------------------------


@pytest.mark.parametrize("h,w", [(24, 16), (6, 10)])
def test_transcode_dxt1_to_etc1(rng, h, w):
    """In place on the payload; the metadata (compressor_name included)
    stays as it is."""
    buf = _buffer(rng, h, w, 0)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert texcomp.DxtcCompressor().compress(texcomp.Format.RGB, h, w, 0, buf, ji)
    assert texcomp_torch.DxtcCompressor(device="cpu").compress(
        texcomp_torch.Format.RGB, h, w, 0, buf, ti)
    md_before = ti.to_arrays()[0]
    texcomp.transcode_dxt1_to_etc1(ji)
    texcomp_torch.transcode_dxt1_to_etc1(ti, device="cpu")
    _assert_same(ti, ji)
    assert ti.to_arrays()[0] == md_before


# --- no silent device fallback, no HQ yet -----------------------------------


def test_cuda_device_without_cuda_raises(rng):
    """EtcCompressor() and transcode_dxt1_to_etc1 run on the card by
    default; where there is none they raise, and never return bytes made
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    for comp in (texcomp_torch.EtcCompressor(),
                 texcomp_torch.EtcCompressor(device="cuda")):
        ci = texcomp_torch.CompressedImage()
        with pytest.raises((AssertionError, RuntimeError)):
            comp.compress(texcomp_torch.Format.RGB, 8, 8, 0,
                          _buffer(rng, 8, 8, 0), ci)
    ci = texcomp_torch.CompressedImage()
    assert texcomp_torch.DxtcCompressor(device="cpu").compress(
        texcomp_torch.Format.RGB, 8, 8, 0, _buffer(rng, 8, 8, 0), ci)
    before = ci.get_data().copy()
    for kwargs in ({}, {"device": "cuda"}):
        with pytest.raises((AssertionError, RuntimeError)):
            texcomp_torch.transcode_dxt1_to_etc1(ci, **kwargs)
        np.testing.assert_array_equal(ci.get_data(), before)


def test_quality_high_not_ported(rng):
    """quality="high" raised NotImplementedError until the HQ ETC1 slice;
    now EtcCompressor(quality="high") compresses (ragged sizes too) and
    builds its mip chain, and transcode_dxt1_to_etc1(quality="high")
    rewrites the payload, as texcomp's do. An unknown quality still
    raises."""
    jc = texcomp.EtcCompressor(quality="high")
    tc = texcomp_torch.EtcCompressor(quality="high", device="cpu")
    for h, w in ((28, 20), (5, 3)):
        buf = _buffer(rng, h, w, 0)
        ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
        assert jc.compress(texcomp.Format.RGB, h, w, 0, buf, ji)
        assert tc.compress(texcomp_torch.Format.RGB, h, w, 0, buf, ti)
        _assert_same(ti, ji)
    h, w = 32, 16
    buf = _buffer(rng, h, w, 0)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress(texcomp.Format.RGB, h, w, 0, buf, ji)
    assert tc.compress(texcomp_torch.Format.RGB, h, w, 0, buf, ti)
    jchain, tchain = jc.downsample_chain(ji), tc.downsample_chain(ti)
    assert len(tchain) == len(jchain) == 5
    for jl, tl in zip(jchain, tchain):
        _assert_same(tl, jl)

    # The transcode: the reference DXT1 payload of the same image, HQ ETC1
    # blocks out, no worse than the heuristic's against the DXT1 pixels.
    dj, dt = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert texcomp.DxtcCompressor().compress(texcomp.Format.RGB, h, w, 0, buf, dj)
    assert texcomp_torch.DxtcCompressor(device="cpu").compress(
        texcomp_torch.Format.RGB, h, w, 0, buf, dt)
    pixels = tdxt.decode_dxt1_blocks(
        torch.from_numpy(dt.get_data().reshape(-1, 8).copy())).numpy()
    ref = texcomp_torch.CompressedImage()
    ref.duplicate(dt)
    texcomp_torch.transcode_dxt1_to_etc1(ref, device="cpu")
    texcomp.transcode_dxt1_to_etc1(dj, quality="high")
    texcomp_torch.transcode_dxt1_to_etc1(dt, "high", device="cpu")
    _assert_same(dt, dj)

    def err(ci):
        dec = tetc.decode_etc1_blocks(
            torch.from_numpy(ci.get_data().reshape(-1, 8).copy())).numpy()
        return ((dec.astype(np.int64) - pixels) ** 2).sum(axis=(1, 2))

    assert np.all(err(dt) <= err(ref))
    with pytest.raises(ValueError):
        texcomp_torch.EtcCompressor(quality="best", device="cpu")
    with pytest.raises(ValueError):
        texcomp_torch.transcode_dxt1_to_etc1(dt, "best", device="cpu")
