"""texcomp_torch's quality="high" DXT1/DXT5 image entries and
``DxtcCompressor("high")`` against texcomp's.

The image entries (``codecs.dxt_hq.encode_dxt{1,5}_hq_image``, the route
``DxtcCompressor("high")`` compresses through) are held to texcomp's block
entries on the same blocks, at 256 blocks: the jit shape of texcomp's API
bucket, so the compressor tests below reuse it. Then the compressor in all
four formats, ragged sizes included. Tolerance 0: bytes equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import texcomp
import texcomp_torch
from texcomp.blocks import image_to_blocks
from texcomp.codecs import dxt_hq as jhq
from texcomp_torch.codecs import dxt_hq as thq


def _image(seed, h, w, fmt):
    """A seeded image: noise, a solid quarter and a smooth ramp."""
    rng = np.random.default_rng(seed)
    c = 3 if fmt < 2 else 4
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[: h // 2, : w // 2] = img[0, 0]
    yy, xx = np.mgrid[0:h, 0:w]
    img[h // 2:, : w // 2, 0] = (xx[h // 2:, : w // 2] * 7) % 256
    img[h // 2:, : w // 2, 1] = (yy[h // 2:, : w // 2] * 5) % 256
    return img


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
def test_image_entry_matches_texcomp_blocks(channels, swap):
    """A 32x128 image (256 blocks): the port's image entry equals texcomp's
    block entry on the image's blocks (texcomp's own tests hold its image
    entry to its block entry). For a swapped format texcomp takes blocks
    already in RGB order plus the flag."""
    img = _image(7 + channels, 32, 128, 0 if channels == 3 else 2)
    blocks = image_to_blocks(jnp.asarray(img)).astype(jnp.int32)
    if swap:
        blocks = jnp.concatenate([blocks[:, :, 2::-1], blocks[:, :, 3:]], -1)
    if channels == 3:
        want = jhq.encode_dxt1_hq_blocks(blocks, swap_red_and_blue=swap)
        got = thq.encode_dxt1_hq_image(torch.from_numpy(img), swap)
    else:
        outside = jnp.zeros(blocks.shape[0], bool)
        want = jhq.encode_dxt5_hq_blocks(blocks, outside,
                                         swap_red_and_blue=swap)
        got = thq.encode_dxt5_hq_image(torch.from_numpy(img), swap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("channels", [3, 4])
def test_image_entry_grid_replicates_edges(channels):
    """A 10x14 image on a 12x16 grid encodes as its edge-replicated blocks
    (the padded compress route)."""
    img = _image(3, 10, 14, 0 if channels == 3 else 2)
    padded = np.pad(img, ((0, 2), (0, 2), (0, 0)), mode="edge")
    if channels == 3:
        fn = thq.encode_dxt1_hq_image
    else:
        fn = thq.encode_dxt5_hq_image
    got = fn(torch.from_numpy(img), grid_height=12, grid_width=16)
    np.testing.assert_array_equal(got.numpy(),
                                  fn(torch.from_numpy(padded)).numpy())


# ---------------------------------------------------------------------------
# DxtcCompressor("high") against texcomp's, all four formats.
# ---------------------------------------------------------------------------

FORMATS = [0, 1, 2, 3]  # RGB, BGR -> DXT1; RGBA, BGRA -> DXT5


def _both(fmt, h, w, seed, *, padded=None):
    """texcomp's and the port's HQ payloads of one image."""
    img = _image(seed, h, w, fmt).tobytes()
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    jc = texcomp.DxtcCompressor("high")
    tc = texcomp_torch.DxtcCompressor("high", device="cpu")
    if padded is None:
        assert jc.compress(texcomp.Format(fmt), h, w, 0, img, ji)
        assert tc.compress(texcomp_torch.Format(fmt), h, w, 0, img, ti)
    else:
        assert jc.compress_and_pad(texcomp.Format(fmt), h, w, *padded, 0, img, ji)
        assert tc.compress_and_pad(texcomp_torch.Format(fmt), h, w, *padded, 0,
                                   img, ti)
    return (jc, ji), (tc, ti)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("size", [(24, 36), (57, 33), (5, 3)])
def test_compress_matches_texcomp(fmt, size):
    """Ragged sizes too: edge blocks replicate, as the reference's."""
    (_, ji), (_, ti) = _both(fmt, *size, seed=size[0] * 100 + fmt)
    np.testing.assert_array_equal(ti.get_data(), ji.get_data())


@pytest.mark.parametrize("fmt", FORMATS)
def test_compress_and_pad_matches_texcomp(fmt):
    """Blocks wholly outside the image: has_one_pixel for the DXT5
    reference candidate."""
    (_, ji), (_, ti) = _both(fmt, 10, 14, 21, padded=(24, 20))
    np.testing.assert_array_equal(ti.get_data(), ji.get_data())


@pytest.mark.parametrize("fmt", FORMATS)
def test_downsample_chain_matches_texcomp(fmt):
    """Level by level, each re-encoded swap-free in HQ, down to 1x1: 32x64
    -> 16x32 -> 8x16 -> 4x8 (one block row) -> 2x4 -> 1x2 -> 1x1."""
    (jc, ji), (tc, ti) = _both(fmt, 32, 64, 31 + fmt)
    jchain, tchain = jc.downsample_chain(ji), tc.downsample_chain(ti)
    assert len(tchain) == len(jchain) == 6
    for jl, tl in zip(jchain, tchain):
        np.testing.assert_array_equal(tl.get_data(), jl.get_data())


@pytest.mark.parametrize("fmt", FORMATS)
def test_downsample_stops_where_texcomp_does(fmt):
    """32x48 -> 16x24 -> 8x12, whose 3 block columns the reference does not
    downsample: both chains end after 2 levels."""
    (jc, ji), (tc, ti) = _both(fmt, 32, 48, 51 + fmt)
    jchain, tchain = jc.downsample_chain(ji), tc.downsample_chain(ti)
    assert len(tchain) == len(jchain) == 2
    for jl, tl in zip(jchain, tchain):
        np.testing.assert_array_equal(tl.get_data(), jl.get_data())


@pytest.mark.parametrize("fmt", FORMATS)
def test_hq_never_worse_all_formats(fmt):
    """Per block the HQ round trip's error is at most the reference's
    (twin of test_dxt_hq.py's four-format check)."""
    h, w = 32, 48
    img = _image(41 + fmt, h, w, fmt)
    c = img.shape[2]

    def errors(quality):
        comp = texcomp_torch.DxtcCompressor(quality, device="cpu")
        ci, buf = texcomp_torch.CompressedImage(), bytearray()
        assert comp.compress(texcomp_torch.Format(fmt), h, w, 0, img.tobytes(), ci)
        assert comp.decompress(ci, buf)
        dec = np.frombuffer(bytes(buf), np.uint8).reshape(h, w, c)
        d = (dec.astype(int) - img.astype(int)) ** 2
        return d.reshape(h // 4, 4, w // 4, 4, c).sum(axis=(1, 3, 4))

    e_ref, e_hq = errors("reference"), errors("high")
    assert np.all(e_hq <= e_ref)
    assert np.sum(e_hq < e_ref) > 10


def test_quality_validation():
    with pytest.raises(ValueError):
        texcomp_torch.DxtcCompressor("best", device="cpu")
