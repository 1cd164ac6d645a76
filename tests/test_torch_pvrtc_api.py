"""The PVRTC slice as a whole: texcomp_torch.PvrtcCompressor and
Pvrtc4bppCompressor (device="cpu") against texcomp's on the CPU, byte for
byte: payload, metadata, the decode extension, the 4bpp decode, the input
rules and the operations the reference does not support; payloads carried
between the two packages; and no silent device fallback.
"""

import numpy as np
import pytest
import torch

import texcomp
import texcomp_torch
from texcomp.codecs import pvrtc4 as jpvrtc4
from texcomp_torch.codecs import pvrtc4 as tpvrtc4

RGBA = 2
CODECS = ["pvrtc", "pvrtc4"]


def _image(rng, side):
    """Noise with an all-black corner and alpha bands 0 / 255 / noise."""
    img = rng.integers(0, 256, (side, side, 4), dtype=np.uint8)
    img[: side // 3, :, 3] = 0
    img[side // 3 : 2 * side // 3, :, 3] = 255
    img[: max(4, side // 8), : max(8, side // 4)] = 0
    return img


def _pair(codec):
    if codec == "pvrtc":
        return (texcomp.PvrtcCompressor(),
                texcomp_torch.PvrtcCompressor(device="cpu"))
    return (texcomp.Pvrtc4bppCompressor(),
            texcomp_torch.Pvrtc4bppCompressor(device="cpu"))


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


def _compress_both(rng, codec, side):
    jc, tc = _pair(codec)
    buf = _image(rng, side).tobytes()
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress(texcomp.Format.RGBA, side, side, 0, buf, ji)
    assert tc.compress(texcomp_torch.Format.RGBA, side, side, 0, buf, ti)
    return (jc, ji), (tc, ti)


@pytest.mark.parametrize("side", [8, 16, 64])
@pytest.mark.parametrize("codec", CODECS)
def test_compress_and_decode(rng, codec, side):
    """Payload and metadata; the 2bpp decode extension, the 4bpp decode."""
    (jc, ji), (tc, ti) = _compress_both(rng, codec, side)
    _assert_same(ti, ji)
    jbuf, tbuf = bytearray(), bytearray()
    if codec == "pvrtc":
        assert jc.decompress_extension(ji, jbuf)
        assert tc.decompress_extension(ti, tbuf)
    else:
        assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert len(tbuf) == side * side * 4
    assert tbuf == jbuf


def test_pvrtc4_codec_equals_texcomp_on_random_bytes(rng):
    """The 4bpp decode of random records, every flag combination."""
    for side in (4, 16, 32):
        data = rng.integers(0, 256, (side * side // 16, 8), dtype=np.uint8)
        want = np.asarray(jpvrtc4.decode_pvrtc_4bpp_device(
            data, height=side, width=side))
        got = tpvrtc4.decode_pvrtc_4bpp(torch.from_numpy(data), side, side)
        np.testing.assert_array_equal(got.numpy(), want)


def test_pvrtc4_smallest_image(rng):
    (jc, ji), (tc, ti) = _compress_both(rng, "pvrtc4", 4)
    _assert_same(ti, ji)


@pytest.mark.parametrize("codec", CODECS)
def test_rejected_inputs(rng, codec):
    """Non-square, non-power-of-two, row padding, too small, and no
    buffer: compress returns False in both packages."""
    jc, tc = _pair(codec)
    buf = rng.integers(0, 256, 64 * 64 * 4 + 256, dtype=np.uint8).tobytes()
    for h, w, pad in [(16, 32, 0), (32, 16, 0), (24, 24, 0), (12, 12, 0),
                      (16, 16, 4), (0, 16, 0), (4, 4, 0), (2, 2, 0),
                      (1, 1, 0)]:
        ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
        want = jc.compress(texcomp.Format.RGBA, h, w, pad, buf, ji)
        assert tc.compress(texcomp_torch.Format.RGBA, h, w, pad, buf, ti) == want
        if want:
            _assert_same(ti, ji)
    assert not tc.compress(texcomp_torch.Format.RGBA, 8, 8, 0, None,
                           texcomp_torch.CompressedImage())


@pytest.mark.parametrize("codec", CODECS)
def test_format_size_and_validity_rules(rng, codec):
    jc, tc = _pair(codec)
    for fmt in range(4):
        assert tc.supports_format(texcomp_torch.Format(fmt)) == \
            jc.supports_format(texcomp.Format(fmt))
        for h, w in [(8, 8), (64, 64), (4, 4)]:
            assert tc.compute_compressed_data_size(
                texcomp_torch.Format(fmt), h, w) == \
                jc.compute_compressed_data_size(texcomp.Format(fmt), h, w)
    (_, ji), (_, ti) = _compress_both(rng, codec, 16)
    assert tc.is_valid_compressed_image(ti) and jc.is_valid_compressed_image(ji)
    other = "pvrtc4" if codec == "pvrtc" else "pvrtc"
    md = {**ti.to_arrays()[0], "compressor_name": other}
    wrong = texcomp_torch.CompressedImage.from_arrays(md, ti.get_data())
    assert not tc.is_valid_compressed_image(wrong)
    short = texcomp_torch.CompressedImage.from_arrays(
        ti.to_arrays()[0], ti.get_data()[:-8])
    assert not tc.is_valid_compressed_image(short)
    assert not tc.is_valid_compressed_image(texcomp_torch.CompressedImage())


@pytest.mark.parametrize("codec", CODECS)
def test_unsupported_operations_return_false(rng, codec):
    """Everything the reference's PVRTC compressor does not support
    (pvrtc_compressor.cc:669-705) returns False in both packages; 2bpp
    decompress is one of them, 4bpp decompress is not."""
    (jc, ji), (tc, ti) = _compress_both(rng, codec, 16)
    buf = _image(rng, 16).tobytes()
    for c, i, pkg in ((jc, ji, texcomp), (tc, ti, texcomp_torch)):
        out = pkg.CompressedImage()
        assert not c.downsample(i, out)
        assert not c.pad(i, 32, 32, out)
        assert not c.compress_and_pad(pkg.Format.RGBA, 16, 16, 32, 32, 0, buf,
                                      out)
        assert not c.create_solid_image(pkg.Format.RGBA, 16, 16,
                                        np.array([1, 2, 3, 4], np.uint8), out)
        assert not c.copy_subimage(i, 0, 0, 8, 8, out)
        assert c.decompress(i, bytearray()) == (codec == "pvrtc4")


def test_decompress_extension_rejects_invalid(rng):
    tc = texcomp_torch.PvrtcCompressor(device="cpu")
    assert not tc.decompress_extension(texcomp_torch.CompressedImage(),
                                       bytearray())
    (_, _), (_, ti) = _compress_both(rng, "pvrtc", 16)
    assert not tc.decompress_extension(ti, None)


# --- payloads carried across the packages -----------------------------------


@pytest.mark.parametrize("codec", CODECS)
def test_jax_payload_decodes_in_port(rng, codec):
    jc, tc = _pair(codec)
    ji = texcomp.CompressedImage()
    assert jc.compress(texcomp.Format.RGBA, 32, 32, 0,
                       _image(rng, 32).tobytes(), ji)
    ti = texcomp_torch.CompressedImage.from_arrays(_md_dict(ji), ji.get_data())
    assert tc.is_valid_compressed_image(ti)
    jbuf, tbuf = bytearray(), bytearray()
    if codec == "pvrtc":
        assert jc.decompress_extension(ji, jbuf)
        assert tc.decompress_extension(ti, tbuf)
    else:
        assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf


@pytest.mark.parametrize("codec", CODECS)
def test_port_payload_decodes_in_jax(rng, codec):
    jc, tc = _pair(codec)
    ti = texcomp_torch.CompressedImage()
    assert tc.compress(texcomp_torch.Format.RGBA, 32, 32, 0,
                       _image(rng, 32).tobytes(), ti)
    md, data = ti.to_arrays()
    ji = texcomp.CompressedImage()
    ji.create_owned_data(
        texcomp.Metadata(**{**md, "format": texcomp.Format(md["format"])}),
        data.size)
    ji.get_mutable_data()[:] = data
    assert jc.is_valid_compressed_image(ji)
    jbuf, tbuf = bytearray(), bytearray()
    if codec == "pvrtc":
        assert jc.decompress_extension(ji, jbuf)
        assert tc.decompress_extension(ti, tbuf)
    else:
        assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf


# --- no silent device fallback; quality="high" ------------------------------


@pytest.mark.parametrize("codec", CODECS)
def test_cuda_device_without_cuda_raises(rng, codec):
    """Both compressors run on the card by default; where there is none
    they raise, and never return bytes made on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    cls = (texcomp_torch.PvrtcCompressor if codec == "pvrtc"
           else texcomp_torch.Pvrtc4bppCompressor)
    for comp in (cls(), cls(device="cuda")):
        ci = texcomp_torch.CompressedImage()
        with pytest.raises((AssertionError, RuntimeError)):
            comp.compress(texcomp_torch.Format.RGBA, 16, 16, 0,
                          _image(rng, 16).tobytes(), ci)


@pytest.mark.parametrize("codec", CODECS)
def test_quality_high_parity(rng, codec):
    """quality="high" compresses as texcomp's does: payload, metadata and
    the decode of the payload. An unknown quality still raises."""
    side = 32
    buf = _image(rng, side).tobytes()
    cls = {"pvrtc": (texcomp.PvrtcCompressor, texcomp_torch.PvrtcCompressor),
           "pvrtc4": (texcomp.Pvrtc4bppCompressor,
                      texcomp_torch.Pvrtc4bppCompressor)}[codec]
    jc, tc = cls[0](quality="high"), cls[1]("high", device="cpu")
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress(texcomp.Format.RGBA, side, side, 0, buf, ji)
    assert tc.compress(texcomp_torch.Format.RGBA, side, side, 0, buf, ti)
    _assert_same(ti, ji)
    jbuf, tbuf = bytearray(), bytearray()
    if codec == "pvrtc":
        assert jc.decompress_extension(ji, jbuf)
        assert tc.decompress_extension(ti, tbuf)
    else:
        assert jc.decompress(ji, jbuf) and tc.decompress(ti, tbuf)
    assert tbuf == jbuf
    with pytest.raises(ValueError):
        cls[1](quality="best", device="cpu")
