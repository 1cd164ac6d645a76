"""texcomp_torch ETC1 codec, bit helpers and image ops against the JAX
package.

The block codec is held to ``texcomp.codecs.etc``; each image op's plain
twin (what a CPU tensor runs) is held to the JAX Pallas kernel run in
interpret mode, as tests/test_pallas.py runs it. Tolerance is 0: every
step is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texcomp.api.transcode import transcode_dxt1_to_etc1_blocks as jtranscode
from texcomp.codecs import etc as jetc
from texcomp.core import bits as jbits
from texcomp.ops import dxt_pallas as dp
from texcomp.ops import etc_pallas as ep
from texcomp_torch.codecs import etc as tetc
from texcomp_torch.core import bits as tbits
from texcomp_torch.ops import _launch, etc_cuda

H, W = 16, 24  # image ops: 24 blocks, one Pallas grid step
STRATEGIES = [0, 1, 2, 3]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _symmetric_blocks(rng, n):
    """Blocks with p(y, x) == p(x, y): the left/right and top/bottom splits
    then have equal errors, and SMALLER_ERROR must keep left/right."""
    px = rng.integers(0, 256, (n, 4, 4, 3))
    px = np.triu(px.transpose(0, 3, 1, 2)) + np.triu(
        px.transpose(0, 3, 1, 2), 1).transpose(0, 1, 3, 2)
    return px.transpose(0, 2, 3, 1).reshape(n, 16, 3).astype(np.int32)


def _etc_blocks(rng, n=700):
    """Random, constant and near-constant blocks, blocks whose halves
    straddle the differential window, and flip-symmetric blocks."""
    px = rng.integers(0, 256, (n, 16, 3)).astype(np.int32)
    px[5:10] = px[5:6, 0:1]
    px[10] = 7
    px[20:60] = np.clip(px[20:21, 0:1] + rng.integers(-3, 4, (40, 16, 3)),
                        0, 255)
    # Left and right halves 8 * d apart in each channel, d in -6..5: their
    # 555 averages differ by about d, on both sides of -4 <= d <= 3.
    for i, d in enumerate(range(-6, 6)):
        for j in range(4):
            base = rng.integers(60, 190, 3)
            blk = np.empty((4, 4, 3), np.int32)
            blk[:, :2] = base
            blk[:, 2:] = np.clip(base + 8 * d + j, 0, 255)
            px[60 + 4 * i + j] = blk.reshape(16, 3)
    px[110:150] = _symmetric_blocks(rng, 40)
    return px


# --- core/bits.py ------------------------------------------------------------


_WORDS = np.random.default_rng(11).integers(0, 1 << 32, 500,
                                            dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("start,num", [(0, 1), (1, 1), (2, 3), (5, 3), (8, 3),
                                       (11, 5), (24, 4), (27, 5), (28, 4),
                                       (16, 16), (31, 1)])
def test_bits_get_and_set(start, num):
    words = _t(_WORDS.view(np.int32))
    want = np.asarray(jbits.get_bits(jnp.asarray(_WORDS), start, num))
    np.testing.assert_array_equal(tbits.get_bits(words, start, num).numpy(), want)
    values = np.arange(-8, 492, dtype=np.int32)
    want = np.asarray(jbits.set_bits(jnp.asarray(_WORDS), start, num,
                                     jnp.asarray(values)))
    got = tbits.set_bits(words, start, num, _t(values))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("num", [3, 4, 8])
def test_bits_extend_sign_bit(num):
    v = np.arange(1 << num, dtype=np.int32)
    np.testing.assert_array_equal(
        tbits.extend_sign_bit(_t(v), num).numpy(),
        np.asarray(jbits.extend_sign_bit(jnp.asarray(v), num)))


def test_words_and_bytes():
    data = np.random.default_rng(3).integers(0, 256, (300, 8), dtype=np.uint8)
    jhi, jlo = jetc.bytes_to_words(jnp.asarray(data))
    hi, lo = tetc.bytes_to_words(_t(data))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
    np.testing.assert_array_equal(tetc.words_to_bytes(hi, lo).numpy(), data)


# --- the block codec against texcomp.codecs.etc (700 blocks) -----------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_encode_etc1_blocks(rng, strategy):
    px = _etc_blocks(rng)
    want = jetc.encode_etc1_blocks(jnp.asarray(px), strategy)
    got = tetc.encode_etc1_blocks(_t(px), strategy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encode_in_chunks(rng, monkeypatch):
    """The chunked search gives the bytes of one pass."""
    px = _etc_blocks(rng, 300)
    whole = tetc.encode_etc1_blocks(_t(px), tetc.SMALLER_ERROR)
    monkeypatch.setattr(tetc, "ENCODE_CHUNK", 64)
    np.testing.assert_array_equal(
        tetc.encode_etc1_blocks(_t(px), tetc.SMALLER_ERROR).numpy(),
        whole.numpy())


def test_smaller_error_ties_keep_left_right(rng):
    px = _symmetric_blocks(rng, 64)
    got = tetc.encode_etc1_blocks(_t(px), tetc.SMALLER_ERROR).numpy()
    assert not (got[:, 3] & 1).any()  # flip bit 0: left/right
    np.testing.assert_array_equal(
        got, np.asarray(jetc.encode_etc1_blocks(jnp.asarray(px),
                                                jetc.SMALLER_ERROR)))


def test_decode_etc1_blocks_random_bytes(rng):
    """Random bytes include malformed differential blocks, whose base plus
    delta leaves 0..31."""
    data = rng.integers(0, 256, (700, 8), dtype=np.uint8)
    hi = data[:, :4].astype(np.int64)
    diff = (hi[:, 3] >> 1) & 1
    r5 = hi[:, 0] >> 3
    dr = hi[:, 0] & 7
    sum_r = r5 + np.where(dr >= 4, dr - 8, dr)
    assert ((diff == 1) & ((sum_r < 0) | (sum_r > 31))).any()
    want = jetc.decode_etc1_blocks(jnp.asarray(data))
    got = tetc.decode_etc1_blocks(_t(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("color", [(0, 0, 0), (255, 255, 255), (1, 2, 3),
                                   (200, 3, 77), (8, 127, 250)])
def test_create_solid_block_bytes(color):
    np.testing.assert_array_equal(tetc.create_solid_block_bytes(*color),
                                  jetc.create_solid_block_bytes(*color))


@pytest.mark.parametrize("strategy", [2, 3])
@pytest.mark.parametrize("kind", ["column", "row"])
def test_edge_pad_functors(rng, kind, strategy):
    data = rng.integers(0, 256, (37, 8), dtype=np.uint8)
    name = f"etc_{kind}_pad_blocks"
    np.testing.assert_array_equal(getattr(tetc, name)(data, strategy),
                                  getattr(jetc, name)(data, strategy))


def test_corner_pad_functor(rng):
    data = rng.integers(0, 256, (37, 8), dtype=np.uint8)
    np.testing.assert_array_equal(tetc.etc_corner_pad_blocks(data),
                                  jetc.etc_corner_pad_blocks(data))


# --- image ops (plain twins) against the Pallas kernels, interpret mode ----


def _image(rng, h, w, c=3):
    """Noise with solid and near-solid blocks."""
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[:4, :8] = img[0, 0]
    img[4:8, 8:16] = np.clip(img[4:8, 8:16] // 32 * 32 + 3, 0, 255)
    return img


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_etc1_encode_image(rng, strategy):
    img = _image(rng, H, W)
    want = ep.etc1_encode_image(jnp.asarray(img), strategy, interpret=True)
    got = etc_cuda.etc1_encode_image(_t(img), strategy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_etc1_encode_padded_image(rng):
    """The compress-and-pad route over a larger grid, from RGB and from
    RGBX input (the transcoder's)."""
    h, w, gh, gw = 10, 14, 16, 24
    img = _image(rng, h, w, 4)
    want = ep.etc1_encode_padded_image(jnp.asarray(img[:, :, :3]), gh, gw,
                                       interpret=True)
    for src in (img[:, :, :3], img):
        got = etc_cuda.etc1_encode_padded_image(_t(src), gh, gw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_etc1_decode_image(rng):
    data = rng.integers(0, 256, (H * W // 16, 8), dtype=np.uint8)
    want = ep.etc1_decode_image(jnp.asarray(data), height=H, width=W,
                                interpret=True)
    got = etc_cuda.etc1_decode_image(_t(data), height=H, width=W)
    assert got.shape == (H, W, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_etc1_downsample_encode(rng, strategy):
    data = etc_cuda.etc1_encode_image(_t(_image(rng, H, W)))
    want = ep.etc1_downsample_encode_words(
        dp.blocks_to_words(jnp.asarray(data.numpy()), 2), nby=H // 4,
        nbx=W // 4, strategy=strategy, interpret=True)
    got = etc_cuda.etc1_downsample_encode(data, nby=H // 4, nbx=W // 4,
                                          strategy=strategy)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(dp.words_to_blocks(want)))


def test_transcode_dxt1_to_etc1_blocks(rng):
    data = rng.integers(0, 256, (45, 8), dtype=np.uint8)
    data[:10, 2:4] = data[:10, 0:2]  # equal endpoints
    got = etc_cuda.transcode_dxt1_to_etc1_blocks(_t(data)).numpy()
    words = ep.transcode_dxt1_to_etc1_packed(
        dp.blocks_to_words(jnp.asarray(data), 2), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ep.etc1_words_to_blocks(words)))
    np.testing.assert_array_equal(got, np.asarray(jtranscode(jnp.asarray(data))))


@pytest.mark.parametrize("strategy", [2, 3])
@pytest.mark.parametrize("kind", ["column", "row", "corner"])
def test_pad_blocks_through_image_ops(rng, kind, strategy):
    """The API's pad blocks, made by the image ops, equal texcomp's."""
    data = rng.integers(0, 256, (21, 8), dtype=np.uint8)
    if kind == "corner":
        got = etc_cuda.etc1_corner_pad_blocks(_t(data))
        want = jetc.etc_corner_pad_blocks(data)
    else:
        got = etc_cuda.etc1_edge_pad_blocks(_t(data), kind, strategy)
        want = getattr(jetc, f"etc_{kind}_pad_blocks")(data, strategy)
    np.testing.assert_array_equal(got.numpy(), want)


# --- the kernel wrappers refuse what they cannot launch --------------------


@pytest.mark.parametrize("name", ["etc1_encode", "etc1_decode",
                                  "etc1_downsample"])
def test_kernel_wrapper_refuses_cpu_tensor(name):
    """A kernel wrapper launches on a CUDA tensor or raises; it never runs
    the plain version instead, and counts no launch."""
    before = dict(_launch.LAUNCHES)
    if name == "etc1_encode":
        args = (torch.zeros((8, 8, 3), dtype=torch.uint8), 8, 8)
    elif name == "etc1_decode":
        args = (torch.zeros((4, 8), dtype=torch.uint8), 8, 8)
    else:
        args = (torch.zeros((4, 8), dtype=torch.uint8), 2, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(etc_cuda, f"{name}_cuda")(*args)
    assert _launch.LAUNCHES == before


def test_unknown_strategy_raises(rng):
    px = rng.integers(0, 256, (4, 16, 3)).astype(np.int32)
    with pytest.raises(ValueError, match="strategy"):
        tetc.encode_etc1_blocks(_t(px), 7)
