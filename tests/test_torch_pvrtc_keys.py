"""Numpy models of csrc/pvrtc.cu's morph and upscale + modulate, held to
the twins and to the JAX package.

The morph finds each axis's first-occurrence extremes by index-carrying
keys: the least v * 32 + s and the greatest v * 32 + (31 - s) of a value v
at scan position s. The channels go two to a word, (r, b) and (g, a) in
16-bit lanes, reduced by lane-wise min and max; the lightness (one
unsigned __dp4a and a shift) goes in one word as its min key and 8191 less
its max key, reduced by a lane-wise min. The upscale + modulate works in the same
lane pairs: a separable bilinear sum (vertical, then horizontal), blended
candidates in lanes, byte-SAD distances and a branch-free early exit. The
models take each step as the kernels do, vectorised over blocks, with
every packed word held in a 32-bit pattern, so a carry between lanes would
show. Tolerance is 0: every step is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (PVRTC_TIE_VALUES, pvrtc_block_image,
                        pvrtc_modulation_ties, pvrtc_tie_blocks)
from texcomp.ops import pvrtc_fast as pf
from texcomp_torch.codecs import pvrtc
from texcomp_torch.ops import pvrtc_cuda

LANES = 0x00FF00FF
#: __dp4a weights of 77 r + 150 g + 28 b, r in byte 0.
LIGHTNESS = 0x001C964D
_S = np.arange(32, dtype=np.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bytes4(w):
    return np.stack([(w >> (8 * k)) & 255 for k in range(4)], axis=-1)


def _dp4a(x, y, c=0):
    """__dp4a, unsigned: the dot product of the four bytes, plus c."""
    return (_bytes4(x) * _bytes4(y)).sum(axis=-1) + c


def _sad(a, b):
    """__vsadu4: the sum of the four bytes' absolute differences."""
    return np.abs(_bytes4(a) - _bytes4(b)).sum(axis=-1)


def _lanes(x, reduce):
    """A DPX 16x2 min or max over the last axis: lane by lane."""
    return reduce(x & 0xFFFF, axis=-1) | (reduce(x >> 16, axis=-1) << 16)


def _words(px):
    """(..., 4) channels -> (...) int64 packed words r | g << 8 | ..."""
    px = px.astype(np.int64)
    return px[..., 0] | (px[..., 1] << 8) | (px[..., 2] << 16) | (px[..., 3] << 24)


def _block_words(images):
    """(B, H, W, 4) uint8 -> (B * NB, 32) int64 words, blocks row-major in
    each image, pixels in scan order py * 8 + px."""
    b, h, w, _ = images.shape
    t = images.reshape(b, h // 4, 4, w // 8, 8, 4).transpose(0, 1, 3, 2, 4, 5)
    return _words(t.reshape(-1, 32, 4))


# --- the morph --------------------------------------------------------------


def _light_key(words, s):
    """light_key: L * 0xFFE00020 + s * 0x10001 + 0x1FE00000 modulo 2^32,
    the min key L * 32 + s low and 8191 - (L * 32 + 31 - s) high."""
    return ((_dp4a(words, LIGHTNESS) >> 8) * 0xFFE00020
            + s * 0x10001 + 0x1FE00000) & 0xFFFFFFFF


def _morph_keys(words):
    """morph_kernel's scan: (N, 5) min keys and (N, 5) max keys, axes
    lightness, r, g, b, a."""
    light = _lanes(_light_key(words, _S), np.min)
    rb, ga = words & LANES, (words >> 8) & LANES
    keys = [rb * 32 + _S * 0x10001, ga * 32 + _S * 0x10001,
            rb * 32 + (31 - _S) * 0x10001, ga * 32 + (31 - _S) * 0x10001]
    assert all((k < 1 << 32).all() for k in keys)
    rbmin, gamin = (_lanes(k, np.min) for k in keys[:2])
    rbmax, gamax = (_lanes(k, np.max) for k in keys[2:])
    kmin = np.stack([light & 0xFFFF, rbmin & 0xFFFF, gamin & 0xFFFF,
                     rbmin >> 16, gamin >> 16], axis=1)
    kmax = np.stack([8191 - (light >> 16), rbmax & 0xFFFF, gamax & 0xFFFF,
                     rbmax >> 16, gamax >> 16], axis=1)
    return kmin, kmax


def _model_extremes(words, origin):
    """morph_kernel's (lo, hi) words before the reduction: the extremes by
    index, the origin word where an axis's max value is 0, the first axis
    of largest SAD spread, the swap by channel sums."""
    kmin, kmax = _morph_keys(words)
    rows = np.arange(len(words))[:, None]
    wmin = words[rows, kmin & 31]
    wmax = np.where(kmax < 32, origin[:, None], words[rows, 31 - (kmax & 31)])
    diff = _sad(wmax, wmin)
    best = diff.argmax(axis=1)[:, None]  # first of the largest: strict '>'
    lo, hi = wmin[rows, best][:, 0], wmax[rows, best][:, 0]
    swap = _dp4a(hi, 0x01010101) < _dp4a(lo, 0x01010101)
    return np.where(swap, hi, lo), np.where(swap, lo, hi)


def _model_morph(words, origin):
    """The modelled kernel's ab, (N, 2) int32; reduce_color is unchanged
    from the twin's ApplyColorChannelReduction."""
    lo, hi = _model_extremes(words, origin)
    a = pvrtc._apply_color_channel_reduction(_t(_bytes4(lo)).int(), is_b=False)
    b = pvrtc._apply_color_channel_reduction(_t(_bytes4(hi)).int(), is_b=True)
    return torch.stack([pvrtc.pack_words(a), pvrtc.pack_words(b)], -1).numpy()


def _axes(blocks):
    """(N, 32, 5) axis values of (N, 32, 4) pixels: the twin's lightness,
    r, g, b, a."""
    px = _t(blocks).int()
    light = (77 * px[..., 0] + 150 * px[..., 1] + 28 * px[..., 2]) >> 8
    return torch.cat([light[..., None], px], dim=-1).numpy()


_TIES = pvrtc_tie_blocks(m=128)


def _tie_set(kind, rng):
    if kind == "random":
        return rng.integers(0, 256, (512, 32, 4), dtype=np.uint8)
    return _TIES[kind]


@pytest.mark.parametrize("which", ["min", "max"])
def test_morph_keys_order_exhaustive(which):
    """Every (v, s), v in 0..255 and s in 0..31: the least min key is the
    least value at its first index, the greatest max key the greatest value
    at its first index; in both lanes of a pair, whatever the other lane
    holds."""
    v, s = np.meshgrid(np.arange(256), np.arange(32), indexing="ij")
    v, s = v.reshape(-1), s.reshape(-1)
    key = v * 32 + (s if which == "min" else 31 - s)
    order = np.argsort(key if which == "min" else -key, kind="stable")
    want = np.lexsort((s, v if which == "min" else -v))
    np.testing.assert_array_equal(order, want)
    assert key.max() == 8191
    for other in (0, 255):
        for lane in (0, 1):
            pair = (v << 16 * lane) | (other << 16 * (1 - lane))
            step = (s if which == "min" else 31 - s) * 0x10001
            packed = pair * 32 + step
            assert (packed < 1 << 32).all()
            np.testing.assert_array_equal((packed >> 16 * lane) & 0xFFFF, key)


def test_lightness_dp4a_exhaustive(rng):
    """One unsigned __dp4a and a shift give (77 r + 150 g + 28 b) >> 8 for
    every (r, g, b), whatever the alpha byte; light_key's lanes are its min
    key and 8191 less its max key, at every scan position."""
    for start in range(0, 1 << 24, 1 << 20):
        rgb = np.arange(start, start + (1 << 20), dtype=np.int64)
        words = rgb | (rng.integers(0, 256, 1 << 20) << 24)
        r, g, b = rgb & 255, (rgb >> 8) & 255, rgb >> 16
        light = (77 * r + 150 * g + 28 * b) >> 8
        np.testing.assert_array_equal(_dp4a(words, LIGHTNESS) >> 8, light)
        s = rng.integers(0, 32, 1 << 20)
        key = _light_key(words, s)
        np.testing.assert_array_equal(key & 0xFFFF, light * 32 + s)
        np.testing.assert_array_equal(key >> 16, 8191 - (light * 32 + 31 - s))


@pytest.mark.parametrize("kind", ["random", "axis ties", "lightness ties",
                                  "equal spreads", "zero axes"])
def test_morph_keys_find_first_extremes(rng, kind):
    """The keys decode to each axis's first-occurrence min and max (value
    and index) and the max's value, on blocks whose extremes tie."""
    blocks = _tie_set(kind, rng)
    kmin, kmax = _morph_keys(_words(blocks))
    axes = torch.from_numpy(_axes(blocks))
    np.testing.assert_array_equal(kmin & 31, axes.argmin(dim=1).numpy())
    np.testing.assert_array_equal(31 - (kmax & 31), axes.argmax(dim=1).numpy())
    np.testing.assert_array_equal(kmin >> 5, axes.amin(dim=1).numpy())
    np.testing.assert_array_equal(kmax >> 5, axes.amax(dim=1).numpy())
    if kind == "axis ties":  # the extremes did tie, away from index 0
        a = axes.numpy()
        ties = (a == a.max(axis=1, keepdims=True)).sum(axis=1)
        assert (ties >= 2).all(axis=1).mean() > 0.9
        assert (31 - (kmax & 31) > 0).mean() > 0.5
    if kind == "lightness ties":  # one lightness, two colours, at the ends
        words = _words(blocks)
        light = axes.numpy()[..., 0]
        for ends in (kmin[:, :1], kmax[:, :1]):
            same = light == ends >> 5
            assert (np.where(same, words, -1).max(axis=1)
                    > np.where(same, words, 1 << 40).min(axis=1)).mean() > 0.9


@pytest.mark.parametrize("kind", ["random", "axis ties", "lightness ties",
                                  "equal spreads", "zero axes"])
def test_modelled_extremes_match_twin(rng, kind):
    """The modelled (lo, hi) against the twin's _morph_extremes, with an
    origin pixel that differs from every block."""
    blocks = _tie_set(kind, rng)
    origin = np.array([9, 200, 31, 77])
    lo, hi = _model_extremes(_words(blocks), np.full(len(blocks), _words(origin)))
    image = _t(blocks.reshape(-1, 4, 8, 4)).int()  # one block an image
    want_lo, want_hi = pvrtc._morph_extremes(
        image, origin=_t(np.tile(origin, (len(blocks), 1))).int())
    np.testing.assert_array_equal(lo, _words(want_lo.reshape(-1, 4).numpy()))
    np.testing.assert_array_equal(hi, _words(want_hi.reshape(-1, 4).numpy()))
    if kind == "zero axes":  # the fallback did happen
        assert (hi == _words(origin)).mean() > 0.3


def test_equal_spread_blocks_tie_with_different_pairs():
    """On every equal-spread block two axes reach the largest spread, and
    one of them with another pair than the first (which strict '>'
    keeps)."""
    words = _words(_TIES["equal spreads"])
    kmin, kmax = _morph_keys(words)
    rows = np.arange(len(words))[:, None]
    wmin, wmax = words[rows, kmin & 31], words[rows, 31 - (kmax & 31)]
    diff = _sad(wmax, wmin)
    top = diff == diff.max(axis=1, keepdims=True)
    first = top.argmax(axis=1)[:, None]
    other = (wmin != wmin[rows, first]) | (wmax != wmax[rows, first])
    assert (top & other).any(axis=1).all()


# --- the upscale + modulate -------------------------------------------------


def _block_coords(n, nby, nbx):
    """block_coords: (image, by, bx) of block n by shifts and masks."""
    lx, ly = nbx.bit_length() - 1, nby.bit_length() - 1
    return n >> (lx + ly), (n >> lx) & (nby - 1), n & (nbx - 1)


@pytest.mark.parametrize("nby,nbx", [(2, 1), (4, 2), (8, 4), (256, 128),
                                     (1024, 512)])
def test_block_coords_by_shifts(nby, nbx):
    n = np.arange(3 * nby * nbx, dtype=np.int64)
    image, by, bx = _block_coords(n, nby, nbx)
    np.testing.assert_array_equal(image, n // (nby * nbx))
    np.testing.assert_array_equal(by, n % (nby * nbx) // nbx)
    np.testing.assert_array_equal(bx, n % nbx)


def _upscaled(vs, left, xw):
    """One pixel's four upscaled lane pairs from a row's vertical sums."""
    return [(((8 - xw) * vs[left][j] + xw * vs[left + 1][j]) >> 5) & LANES
            for j in range(4)]


def _candidates(up):
    """The four candidate byte words A, (5A+3B)>>3, (3A+5B)>>3, B from the
    lane pairs (A rb, A ga, B rb, B ga)."""
    c1 = [((5 * up[j] + 3 * up[j + 2]) >> 3) & LANES for j in (0, 1)]
    c2 = [((3 * up[j] + 5 * up[j + 2]) >> 3) & LANES for j in (0, 1)]
    return [up[0] | (up[1] << 8), c1[0] | (c1[1] << 8),
            c2[0] | (c2[1] << 8), up[2] | (up[3] << 8)]


def _early_exit(d0, d1, d2, d3):
    t1 = d1 < d0
    t2 = t1 & (d2 < d1)
    t3 = t2 & (d3 < d2)
    return t1.astype(np.int64) + t2 + t3


def _lane_pairs(ab):
    """(N, 2) int32 ab -> the four lane pairs of each block, (4, N)."""
    a, b = (ab.view(np.uint32).astype(np.int64)[:, k] for k in (0, 1))
    return np.stack([a & LANES, (a >> 8) & LANES, b & LANES, (b >> 8) & LANES])


def _model_upscale_modulate(images, ab):
    """upscale_modulate_kernel on (B, H, W, 4) uint8 images and (B*NB, 2)
    int32 ab: (B*NB, 32) uint8 modulation."""
    b, h, w, _ = images.shape
    nby, nbx = h // 4, w // 8
    n = np.arange(b * nby * nbx, dtype=np.int64)
    image, by, bx = _block_coords(n, nby, nbx)
    pairs = _lane_pairs(ab)
    q = [[pairs[:, image * nby * nbx + ((by + r - 1) & (nby - 1)) * nbx
                + ((bx + c - 1) & (nbx - 1))] for c in range(3)]
         for r in range(3)]
    px = _block_words(images)
    out = np.zeros((len(n), 32), dtype=np.int64)
    for py in range(4):
        top, yw = (0 if py < 2 else 1), (py + 2) & 3
        vs = [(4 - yw) * q[top][c] + yw * q[top + 1][c] for c in range(3)]
        assert max(int(v.max()) for v in vs) < 1 << 32
        for x in range(8):
            up = _upscaled(vs, 0 if x < 4 else 1, (x + 4) & 7)
            d = [_sad(px[:, 8 * py + x], c) for c in _candidates(up)]
            out[:, 8 * py + x] = _early_exit(*d)
    return out.astype(np.uint8)


def test_separable_lane_upscale_matches_twin():
    """Every (yw, xw), with the four corners of each channel over
    {0, 1, 127, 128, 254, 255}^4 (1,296 combinations, a different one in
    each channel): the lane pairs' separable sum equals the twin's
    _interpolate_upscaled."""
    vals = np.array(PVRTC_TIE_VALUES)
    combo = np.stack(np.meshgrid(*[np.arange(6)] * 4, indexing="ij"),
                     -1).reshape(-1, 4)  # (1296, corner)
    chans = np.stack([combo, np.roll(combo, 1, 0), np.roll(combo, 7, 0),
                      combo[::-1]], -1)  # (1296, corner, channel)
    low = vals[chans].reshape(-1, 2, 2, 4)  # a 2x2 low-res image each
    want = pvrtc._interpolate_upscaled(_t(low).int(), 8, 16).numpy()
    lw = _words(low)  # (K, 2, 2)
    pairs = [lw & LANES, (lw >> 8) & LANES]
    got = np.zeros(want.shape, dtype=np.int64)
    for y in range(8):
        by, py = divmod(y, 4)
        top, yw = (by - 1 if py < 2 else by) & 1, (py + 2) & 3
        vs = [[(4 - yw) * pairs[j][:, top, c] + yw * pairs[j][:, (top + 1) & 1, c]
               for j in range(2)] for c in range(2)]
        for x in range(16):
            bx, px = divmod(x, 8)
            left, xw = (bx - 1 if px < 4 else bx) & 1, (px + 4) & 7
            for j in range(2):
                s = (8 - xw) * vs[left][j] + xw * vs[(left + 1) & 1][j]
                assert (s & 0xFFFF).max() <= 8160 and (s >> 16).max() <= 8160
                up = (s >> 5) & LANES
                got[:, y, x, j] = up & 255
                got[:, y, x, j + 2] = up >> 16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "extremes"])
def test_lane_candidates_and_sad_match_twin(rng, kind):
    """Candidates in lanes against _apply_modulation, their byte SADs
    against _color_diff."""
    n = 100_000
    if kind == "random":
        a, b, v = (rng.integers(0, 256, (n, 4)) for _ in range(3))
    else:
        vals = np.array(PVRTC_TIE_VALUES)
        a, b, v = (vals[rng.integers(0, 6, (n, 4))] for _ in range(3))
    up = [_words(a) & LANES, (_words(a) >> 8) & LANES,
          _words(b) & LANES, (_words(b) >> 8) & LANES]
    cands = _candidates(up)
    ta, tb, tv = (_t(x).int() for x in (a, b, v))
    for mod, word in enumerate(cands):
        want = pvrtc._apply_modulation(ta, tb, mod)
        np.testing.assert_array_equal(_bytes4(word), want.numpy())
        np.testing.assert_array_equal(_sad(_words(v), word),
                                      pvrtc._color_diff(tv, want).numpy())


def _modulation_input(rng, kind, n=200_000):
    """Pixels and upscaled colours: random, or few-valued with A == B in
    every fourth (the candidates' distances tie often)."""
    if kind == "random":
        return tuple(rng.integers(0, 256, (1, n, 1, 4)) for _ in range(3))
    v = 4 * rng.integers(0, 8, (1, n, 1, 4))
    a = 8 * rng.integers(0, 5, (1, n, 1, 4))
    b = 8 * rng.integers(0, 5, (1, n, 1, 4))
    b[:, ::4] = a[:, ::4]
    return v, a, b


@pytest.mark.parametrize("kind", ["ties", "random"])
def test_branch_free_early_exit_matches_modulate(rng, kind):
    """m = t1 + t2 + t3 against the twin's _modulate: on distances that tie
    (d1 == d0, and d2 == d1 after an improvement), and on random ones,
    where the candidates' rounding makes the early exit differ from the
    first argmin."""
    v, a, b = _modulation_input(rng, kind)
    up = [_words(a) & LANES, (_words(a) >> 8) & LANES,
          _words(b) & LANES, (_words(b) >> 8) & LANES]
    d = [_sad(_words(v), c) for c in _candidates(up)]
    got = _early_exit(*d)
    want = pvrtc._modulate(_t(v).int(), _t(a).int(), _t(b).int()).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "ties":
        assert (d[1] == d[0]).any() and ((d[1] < d[0]) & (d[2] == d[1])).any()
    else:
        assert (got != np.stack(d).argmin(axis=0)).sum() > 100


# --- the whole modelled kernels against the twins and texcomp ---------------


def _image_words(images):
    """(B, H, W, 4) uint8 -> JAX's (32, B*NB) uint32 words, image-major."""
    b, h, w, _ = images.shape
    px = np.ascontiguousarray(images).view(np.uint32).reshape(b * h, w)
    return np.asarray(pf._px_block_words(jnp.asarray(px)))


def _ab_jax(ab):
    """The twin's (N, 2) int32 ab -> JAX's (2, N) uint32."""
    return jnp.asarray(ab.view(np.uint32).T.copy())


def _tie_image(rng, side, batch=1):
    """(batch, side, side, 4) uint8 images of the tie blocks of every kind
    (block 0 of each random), then random blocks."""
    blocks = np.concatenate(list(_TIES.values()))
    return np.stack([pvrtc_block_image(rng.permutation(blocks), side,
                                       seed=int(rng.integers(1 << 30)))
                     for _ in range(batch)])


@pytest.mark.parametrize("origin", ["own", "other"])
@pytest.mark.parametrize("side", [8, 16, 32])
def test_modelled_morph_matches_twin_and_texcomp(rng, side, origin):
    images = _tie_image(rng, side)
    o = images[0, 0, 0] if origin == "own" else np.array([9, 200, 31, 77],
                                                         dtype=np.uint8)
    words = _block_words(images)
    got = _model_morph(words, np.full(len(words), _words(o)))
    want = pvrtc_cuda.pvrtc_morph_plain(_t(images[0]), _t(o)).numpy()
    np.testing.assert_array_equal(got, want)
    p00 = jnp.asarray(o.view(np.int32).reshape(1, 1))
    jax_ab = np.asarray(pf.morph_packed(jnp.asarray(_image_words(images)), p00,
                                        interpret=True))
    np.testing.assert_array_equal(got.view(np.uint32).T, jax_ab)


@pytest.mark.parametrize("side", [8, 16, 32])
def test_modelled_morph_batched_matches_twin_and_texcomp(rng, side):
    """Each image falls back to its own pixel (0, 0)."""
    images = _tie_image(rng, side, batch=3)
    images[1, :4, :8] = 0  # image 1's block 0 all zero: its origin is 0
    nb = (side // 4) * (side // 8)
    words = _block_words(images)
    origin = np.repeat(_words(images[:, 0, 0]), nb)
    got = _model_morph(words, origin)
    want = pvrtc_cuda.pvrtc_morph_batched_plain(_t(images)).numpy()
    np.testing.assert_array_equal(got, want)
    p00 = jnp.asarray(origin.astype(np.uint32).view(np.int32)[None])
    jax_ab = np.asarray(pf.morph_packed_batched(
        jnp.asarray(_image_words(images)), p00, interpret=True))
    np.testing.assert_array_equal(got.view(np.uint32).T, jax_ab)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("side", [8, 16, 32])
def test_modelled_upscale_modulate_matches_twin_and_texcomp(rng, side, batch):
    """Side 8 is one block wide: every horizontal neighbour is the block
    itself."""
    images = _tie_image(rng, side, batch)
    ab = pvrtc_cuda.pvrtc_morph_batched_plain(_t(images)).numpy()
    got = _model_upscale_modulate(images, ab)
    want = pvrtc_cuda.pvrtc_upscale_modulate_plain(_t(images), _t(ab)).numpy()
    np.testing.assert_array_equal(got, want)
    nby, nbx = side // 4, side // 8
    ab_j = _ab_jax(ab)
    va9 = pf._make_var_words_batched(ab_j[0:1], batch, nby, 1, nbx)
    vb9 = pf._make_var_words_batched(ab_j[1:2], batch, nby, 1, nbx)
    jax_mod = np.asarray(pf.upscale_modulate_packed(
        jnp.asarray(_image_words(images)), jnp.concatenate([va9, vb9], axis=0),
        interpret=True))
    np.testing.assert_array_equal(got.T, jax_mod)


def test_modelled_upscale_modulate_on_modulation_ties():
    """chip_smoke's "modulation ties" input: A == B in every fourth block,
    few-valued pixels and colours."""
    images, ab = pvrtc_modulation_ties(side=64)
    got = _model_upscale_modulate(images, ab)
    want = pvrtc_cuda.pvrtc_upscale_modulate_plain(_t(images), _t(ab)).numpy()
    np.testing.assert_array_equal(got, want)
    nby, nbx = 16, 8
    by = np.arange(nby * nbx) // nbx
    inside = (by % 8 == 1) | (by % 8 == 2)  # A == B in the 3x3 neighbourhood
    assert (got[inside] == 0).all()
    low = pvrtc.unpack_words(_t(ab).reshape(1, nby, nbx, 2))
    a_up, b_up = (pvrtc._interpolate_upscaled(low[..., k, :], 64, 64)
                  for k in (0, 1))
    img = _t(images).int()
    d = [pvrtc._color_diff(img, pvrtc._apply_modulation(a_up, b_up, m))
         for m in range(4)]
    differ = (a_up != b_up).any(dim=-1)
    assert ((d[1] == d[0]) & differ).any()  # equidistant from A and C1
    assert ((d[1] < d[0]) & (d[2] == d[1])).any()
    assert {0, 1, 2, 3} <= set(np.unique(got).tolist())
