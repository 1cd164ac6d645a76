"""Numpy models of csrc/dxt.cu's reference encode, held to the twin and to
the JAX package.

The encode kernel keeps each pixel as one packed word. It finds a block's
base colours by luminance keys: lum * 16 + i by an unsigned __dp4a for the
first minimum, lum * 16 + 15 - i for the first maximum. Its nearest
searches (the palette's and the alpha ramp's, which the fused levels
share) take the least key (x - v_k)^2 * 2^s + k less the common
x^2 * 2^s: one multiply-add a candidate, the code in the key's low s bits.
The models take each step as the kernel does, vectorised over blocks.
Tolerance is 0: every step is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import dxt_tie_blocks
from texcomp.ops import dxt_pallas as dp
from texcomp_torch.blocks import full_outside_mask
from texcomp_torch.codecs import dxt
from texcomp_torch.core import colors as cc
from texcomp_torch.ops import dxt_cuda

#: __dp4a weights of 16 * (4r + 8g + b) with r in byte 0, or in byte 2 (swap).
LUM_KEY = {False: 0x00108040, True: 0x00408010}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bytes4(w):
    return np.stack([(w >> (8 * k)) & 255 for k in range(4)], axis=-1)


def _dp4a(x, y, c=0):
    """__dp4a, unsigned: the dot product of the four bytes, plus c."""
    return (_bytes4(x) * _bytes4(y)).sum(axis=-1) + c


def _byte_perm(x, y, sel):
    """__byte_perm: result byte n is byte (sel >> 4n) & 7 of (x, y)."""
    src = np.concatenate([_bytes4(x), _bytes4(y)], axis=-1)
    return sum(src[..., (sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _alpha_codes(a, ramp):
    """encode_alpha's search: keys with s = 3 over the 8 ramp entries."""
    m = -16 * ramp
    k = 8 * ramp * ramp + np.arange(8, dtype=ramp.dtype)
    return (a[..., None] * m + k).min(axis=-1) & 7


def _color_codes(l, pal):
    """encode_color_bases' search: keys with s = 2 over 4 palette entries."""
    m = -8 * pal
    k = 4 * pal * pal + np.arange(4, dtype=pal.dtype)
    return (l[..., None] * m + k).min(axis=-1) & 3


# --- the keys against the twin's first-occurrence argmin --------------------


def test_alpha_key_matches_argmin_first_exhaustive():
    """Every (a0, a1, a) triple: 16,777,216 pixels, either ramp mode."""
    a0, a1 = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ramp = dxt._alpha_ramp(_t(a0.reshape(-1)).int(),
                           _t(a1.reshape(-1)).int()).numpy()
    m = -16 * ramp
    k = 8 * ramp * ramp + np.arange(8, dtype=np.int32)
    lo_key, hi_key = 0, 0
    for start in range(0, 256, 16):
        a = np.arange(start, start + 16, dtype=np.int32)[None, :, None]
        key = a * m[:, None, :] + k[:, None, :]
        lo_key, hi_key = min(lo_key, key.min()), max(hi_key, key.max())
        d = a - ramp[:, None, :]
        want = dxt._argmin_first(_t(d * d)).numpy()
        np.testing.assert_array_equal(key.min(axis=-1) & 7, want)
    assert (lo_key, hi_key) == (-520200, 520207)


@pytest.mark.parametrize("kind", ["random", "tied entries", "equidistant"])
def test_color_key_matches_argmin_first(rng, kind):
    """Luminances and palettes in 0..3315 (4r + 8g + b of 8-bit colours),
    with entries forced equal, or each pixel midway between two entries."""
    n = 200_000
    pal = rng.integers(0, 3316, (n, 4))
    l = rng.integers(0, 3316, n)
    rows = np.arange(n)
    if kind == "tied entries":
        i, j = rng.integers(0, 4, n), rng.integers(0, 4, n)
        pal[rows, j] = pal[rows, i]
        l = np.where(rows % 2 == 0, pal[rows, i], l)
    elif kind == "equidistant":
        i, j = rng.integers(0, 4, n), rng.integers(0, 4, n)
        pal[rows, j] += (pal[rows, j] + pal[rows, i]) % 2  # an even sum
        pal = np.minimum(pal, 3315)
        l = (pal[rows, i] + pal[rows, j]) // 2
    key = (l[:, None] * (-8 * pal) + 4 * pal * pal + np.arange(4)).min(axis=1)
    assert np.abs(key).max() < 44_000_000
    d = pal - l[:, None]
    want = dxt._argmin_first(_t(d * d)).numpy()
    if kind == "equidistant":  # the ties did happen
        assert (np.sort(d * d, axis=1)[:, 0] == np.sort(d * d, axis=1)[:, 1]).mean() > 0.2
    np.testing.assert_array_equal(_color_codes(l, pal), want)


def _tie_words(rng, pad, n=4096):
    """(K, 16, 4) int64 pixels, dxt_tie_blocks' and random ones, and their
    packed words; byte 3 is alpha, or ``pad`` as an RGBX pad byte."""
    blocks = np.concatenate([dxt_tie_blocks(m=512),
                             rng.integers(0, 256, (n, 16, 4))]).astype(np.int64)
    if pad is not None:
        blocks[..., 3] = pad
    words = (blocks[..., 0] | (blocks[..., 1] << 8) | (blocks[..., 2] << 16)
             | (blocks[..., 3] << 24))
    return blocks, words


def _lum_keys(words, swap):
    """The encode kernel's luminance keys: (index of the first minimum,
    index of the first maximum, each pixel's luminance)."""
    i = np.arange(16)
    key = _dp4a(words, LUM_KEY[swap], i)
    lo = key.min(axis=1) & 15
    hi = 15 - ((key + 15 - 2 * i).max(axis=1) & 15)
    return lo, hi, key >> 4


@pytest.mark.parametrize("pad", [None, 0, 255], ids=["rgba", "rgbx 0", "rgbx 255"])
@pytest.mark.parametrize("swap", [False, True])
def test_lum_keys_find_first_extremes(rng, swap, pad):
    blocks, words = _tie_words(rng, pad)
    rgb = _t(blocks[..., [2, 1, 0]] if swap else blocks[..., :3]).int()
    lum = cc.compute_luminance_fast(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    lo, hi, l = _lum_keys(words, swap)
    np.testing.assert_array_equal(l, lum.numpy())
    np.testing.assert_array_equal(lo, dxt._first_index(lum, lum.amin(dim=1)).numpy())
    np.testing.assert_array_equal(hi, dxt._first_index(lum, lum.amax(dim=1)).numpy())
    # The tie blocks' ends tie in luminance (the odd ones with swap too).
    rows = np.arange(1 if swap else 0, 512, 2 if swap else 1)
    assert (l[rows, lo[rows]] == np.sort(l[rows], axis=1)[:, 1]).all()
    assert (l[rows, hi[rows]] == np.sort(l[rows], axis=1)[:, -2]).all()


# --- the whole modelled encode ----------------------------------------------


def _block_words(img, gh, gw, vector, pad=255):
    """The encode kernel's (N, 16) pixel words over the (gh, gw) grid:
    byte loads at clamped coordinates (an RGB pad byte of ``pad``), or, with
    ``vector`` and a width that is a multiple of 4, each wholly-inside
    block's rows as the vector loads give them (RGB: three little-endian
    words regrouped by byte permutes, the pad byte a neighbour's)."""
    h, w, c = img.shape
    nby, nbx = -(-gh // 4), -(-gw // 4)
    ys = np.minimum(4 * np.arange(nby)[:, None] + np.arange(4), h - 1)
    xs = np.minimum(4 * np.arange(nbx)[:, None] + np.arange(4), w - 1)
    px = img.astype(np.int64)[ys[:, None, :, None], xs[None, :, None, :]]
    alpha = px[..., 3] if c == 4 else pad
    words = px[..., 0] | (px[..., 1] << 8) | (px[..., 2] << 16) | (alpha << 24)
    if vector and c == 3 and w % 4 == 0:
        for by in range(min(nby, h // 4)):
            for bx in range(min(nbx, w // 4)):
                row = img[4 * by:4 * by + 4, 4 * bx:4 * bx + 4].astype(np.int64)
                u = row.reshape(4, 3, 4)
                u = u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16) | (u[..., 3] << 24)
                words[by, bx] = np.stack(
                    [u[:, 0], _byte_perm(u[:, 0], u[:, 1], 0x6543),
                     _byte_perm(u[:, 1], u[:, 2], 0x5432), u[:, 2] >> 8], axis=1)
    return words.reshape(nby * nbx, 16)


def _q8(v, bits):
    i = v * ((1 << bits) - 1) + 128
    return (i + (i >> 8)) >> 8


def _lum(r, g, b):
    return 4 * r + 8 * g + b


def _model_color(words, swap, always4):
    """encode_kernel's colour half: luminance keys, the two base colours by
    index, encode_color_bases (the twin's const path). (N, 8) bytes."""
    lo, hi, l = _lum_keys(words, swap)
    rows_n = np.arange(len(words))
    plo, phi = words[rows_n, lo], words[rows_n, hi]

    def chans(p):
        c = [(p >> s) & 255 for s in (0, 8, 16)]
        return c[::-1] if swap else c

    blo, bhi = chans(plo), chans(phi)
    lo16, hi16 = [(_q8(r, 5) << 11) | (_q8(g, 6) << 5) | _q8(b, 5)
                  for r, g, b in (blo, bhi)]
    # best_const_colors gets the low base in source order (the double swap).
    which, k0, k1 = dxt._best_const_colors(
        tuple(_t((plo >> s) & 255).int() for s in (0, 8, 16)), always4)
    flip = lo16 < hi16
    b0 = [np.where(flip, h_, l_) for l_, h_ in zip(blo, bhi)]
    b1 = [np.where(flip, l_, h_) for l_, h_ in zip(blo, bhi)]
    pal = np.stack([_lum(*b0), _lum(*b1),
                    _lum(*[(2 * x + y) // 3 for x, y in zip(b0, b1)]),
                    _lum(*[(x + 2 * y) // 3 for x, y in zip(b0, b1)])], axis=-1)
    codes = _color_codes(l, pal[:, None, :])
    rows = (codes << (2 * np.arange(16))).sum(axis=1)
    const = lo16 == hi16
    c0 = np.where(const, k0.numpy(), np.maximum(lo16, hi16))
    c1 = np.where(const, k1.numpy(), np.minimum(lo16, hi16))
    rows = np.where(const, which.numpy() * 0x55555555, rows)
    return np.stack([c0 & 255, c0 >> 8, c1 & 255, c1 >> 8]
                    + [(rows >> (8 * y)) & 255 for y in range(4)], axis=1)


def _zero_bytes(v):
    """zero_bytes: bit 8n + 7 set where byte n of the word v is 0."""
    return ~(((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v | 0x7F7F7F7F) & 0xFFFFFFFF


def _popc(v):
    return sum((v >> b) & 1 for b in range(32))


def test_zero_bytes_marks_exactly_the_zero_bytes(rng):
    edge = np.array([0, 1, 2, 0x7F, 0x80, 0x81, 0xFE, 0xFF])
    b = np.concatenate([edge[rng.integers(0, 8, (100_000, 4))],
                        rng.integers(0, 256, (100_000, 4))])
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    want = sum(((b[:, n] == 0).astype(np.int64) << (8 * n + 7)) for n in range(4))
    np.testing.assert_array_equal(_zero_bytes(v), want)
    np.testing.assert_array_equal(_popc(_zero_bytes(~v & 0xFFFFFFFF)),
                                  (b == 255).sum(axis=1))


def _model_alpha(a, outside):
    """encode_alpha: base alphas (the 0s and 255s counted four to a word,
    the mid range as unsigned minima), the ramp, the keyed search. (N, 8)
    bytes."""
    q = a.reshape(len(a), 4, 4)
    words = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    num_t = _popc(_zero_bytes(words)).sum(axis=1)
    num_o = _popc(_zero_bytes(~words & 0xFFFFFFFF)).sum(axis=1)
    low1 = ((a - 1) & 0xFFFFFFFF).min(axis=1)
    high1 = ((254 - a) & 0xFFFFFFFF).min(axis=1)
    any_mid = low1 < 254
    low = np.where(any_mid, low1 + 1, 0)
    high = np.where(any_mid, 254 - high1, 255)
    explicit = (num_t > 1) | (num_o > 1)
    a0 = np.where(explicit, low, np.where(num_o > 0, 255, high))
    a1 = np.where(explicit, high, np.where(num_t > 0, 0, low))
    five = [a0, a1] + [((5 - j) * a0 + j * a1) // 5 for j in range(1, 5)] + [0 * a0, 0 * a0 + 255]
    seven = [a0, a1] + [((7 - j) * a0 + j * a1) // 7 for j in range(1, 7)]
    ramp = np.where((a0 <= a1)[:, None], np.stack(five, 1), np.stack(seven, 1))
    codes = np.where(outside[:, None], 0, _alpha_codes(a, ramp[:, None, :]))
    a0 = np.where(outside, a[:, 0], a0)
    a1 = np.where(outside, a[:, 0], a1)
    field = (codes << (3 * np.arange(16))).sum(axis=1)
    return np.stack([a0, a1] + [(field >> (8 * k)) & 255 for k in range(6)], axis=1)


def _model_encode(img, gh, gw, codec, swap, vector=True):
    """The modelled encode kernel of an (h, w, C) uint8 image on a grid."""
    words = _block_words(img, gh, gw, vector)
    color = _model_color(words, swap, codec != "dxt1")
    if codec != "dxt5":
        return color.astype(np.uint8)
    outside = full_outside_mask(img.shape[0], img.shape[1], gh, gw,
                                device="cpu").numpy()
    alpha = _model_alpha(words >> 24, outside)
    return np.concatenate([alpha, color], axis=1).astype(np.uint8)


def _twin(img, gh, gw, codec, swap):
    if codec == "dxt5":
        return dxt_cuda.dxt5_encode_plain(_t(img), gh, gw, swap).numpy()
    return dxt_cuda.dxt1_encode_plain(_t(img), gh, gw, swap,
                                      codec == "dxt1 always4").numpy()


def _texcomp(img, gh, gw, codec, swap):
    """texcomp's Pallas encode in interpret mode, edge-padded to the grid
    as its compress route pads (dxtc_encode_padded_image)."""
    h, w = img.shape[:2]
    padded = np.pad(img, ((0, gh - h), (0, gw - w), (0, 0)), mode="edge")
    if codec == "dxt5":
        words = np.asarray(dp.pack_rgba_image(jnp.asarray(padded), swap))
        flag = full_outside_mask(h, w, gh, gw, device="cpu").numpy().astype(np.uint32)
        w17 = np.concatenate([words, flag[None, :]])
        out = dp.encode_dxt5_packed(jnp.asarray(w17), swap=swap, interpret=True)
    else:
        words = dp.pack_rgb_image(jnp.asarray(padded[..., :3]), swap)
        out = dp.encode_dxt1_packed(words, always4=codec == "dxt1 always4",
                                    swap=swap, interpret=True)
    return np.asarray(out).T


def _tie_image(rng, nby, nbx, c, m):
    """An (4 nby, 4 nbx, c) image of dxt_tie_blocks(m=m)'s 6m blocks in
    random order, then noise."""
    blocks = dxt_tie_blocks(seed=int(rng.integers(1 << 30)), m=m)
    blocks = np.concatenate([rng.permutation(blocks),
                             rng.integers(0, 256, (nby * nbx, 16, 4), dtype=np.uint8)])
    img = blocks[:nby * nbx].reshape(nby, nbx, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(4 * nby, 4 * nbx, 4)[..., :c])


_CODECS = ["dxt1", "dxt1 always4", "dxt5"]


def _div_magic(d):
    """div_magic: (m, s) with n // d == (n * m) >> s for 0 <= n < 2^31."""
    l = 0
    while (1 << l) < d:
        l += 1
    return (1 << (31 + l)) // d + 1, 31 + l


@pytest.mark.parametrize("divisors", ["1..4096", "large"])
def test_block_row_division_by_magic(rng, divisors):
    """The encode kernel's block row of block n, on the grid's row widths
    d: exact for every n below 2^31, the edges n = kd - 1, kd included;
    the product stays below 2^63."""
    if divisors == "1..4096":
        ds = np.arange(1, 4097)
    else:
        ds = np.concatenate([rng.integers(4097, 1 << 31, 4000),
                             [(1 << 30) - 1, 1 << 30, (1 << 30) + 1,
                              (1 << 31) - 1]])
    for d in ds.tolist():
        m, sh = _div_magic(d)
        assert m <= 1 << 32
        k = rng.integers(0, ((1 << 31) - 1) // d + 1, 16, dtype=np.int64)
        n = np.concatenate([rng.integers(0, 1 << 31, 16, dtype=np.int64),
                            k * d, np.maximum(k * d - 1, 0), [(1 << 31) - 1]])
        n = n[n < (1 << 31)].astype(object)
        assert [(x * m) >> sh for x in n] == [x // d for x in n]


@pytest.mark.parametrize("c", [3, 4])
def test_vector_rows_give_the_byte_load_channels(rng, c):
    img = rng.integers(0, 256, (16, 24, c), dtype=np.uint8)
    vector = _block_words(img, 16, 24, True)
    scalar = _block_words(img, 16, 24, False)
    mask = 0xFFFFFFFF if c == 4 else 0xFFFFFF
    np.testing.assert_array_equal(vector & mask, scalar & mask)
    if c == 3:
        assert (vector != scalar).any()  # the pad bytes differ


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("codec", _CODECS)
def test_modelled_encode_matches_twin_on_ties(rng, codec, swap):
    """1,536 tie blocks and 512 of noise, through both load models."""
    c = 4 if codec == "dxt5" else 3
    img = _tie_image(rng, 32, 64, c, 256)
    want = _twin(img, 128, 256, codec, swap)
    for vector in (True, False):
        got = _model_encode(img, 128, 256, codec, swap, vector)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(16, 24, 16, 24), (10, 14, 16, 24)],
                         ids=["16x24", "10x14 on 16x24"])
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("codec", _CODECS)
def test_modelled_encode_matches_twin_and_texcomp(rng, codec, swap, size):
    """At 16x24 and at a ragged size (has_one_pixel blocks for DXT5), tie
    blocks included: the model equals the twin and texcomp's kernel in
    interpret mode."""
    h, w, gh, gw = size
    c = 4 if codec == "dxt5" else 3
    img = np.ascontiguousarray(_tie_image(rng, 4, 6, c, 3)[:h, :w])
    got = _model_encode(img, gh, gw, codec, swap)
    np.testing.assert_array_equal(got, _twin(img, gh, gw, codec, swap))
    np.testing.assert_array_equal(got, _texcomp(img, gh, gw, codec, swap))
