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
from texcomp_torch.ops import _launch, dxt_cuda, etc_cuda

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


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_etc1_downsample_encode_random_payload(rng, strategy):
    """Random payloads, malformed differential blocks among them (a base
    plus delta outside 0..31 decodes to a base outside 0..255)."""
    data = _random_payload(rng, H * W // 16)
    assert _out_of_range_bases(data).sum() >= 4
    want = ep.etc1_downsample_encode_words(
        dp.blocks_to_words(jnp.asarray(data), 2), nby=H // 4, nbx=W // 4,
        strategy=strategy, interpret=True)
    got = etc_cuda.etc1_downsample_encode(_t(data), nby=H // 4, nbx=W // 4,
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


# --- csrc/etc.cu's packed arithmetic, as numpy models, against the twin -----
#
# The reference encode and the fused level run one thread per 4x4 block on
# packed pixels r | g << 8 | b << 16 and score a colour by |c|^2 - 2 c.p
# (one __dp4a, |p|^2 left out); colours are clamped per channel by DPX
# add-min / add-max on 16-bit halves and assembled by byte permutes. The
# models below take each step as the kernels do, vectorised over blocks.

_CB = tetc._codebook("cpu").numpy().astype(np.int64)  # (8, 4): a, b, -a, -b
_HEUR_THRESHOLDS = np.array([12, 23, 35, 51, 70, 93, 144])


def _bytes4(w):
    return np.stack([(w >> (8 * k)) & 255 for k in range(4)], axis=-1)


def _pack4(b):
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _pack_rgb(v):
    v = v.astype(np.int64)
    return v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16)


def _dot(x, y):
    """__dp4a: the dot product of the four bytes."""
    return (_bytes4(x) * _bytes4(y)).sum(axis=-1)


def _halves(w):
    """A word's two signed 16-bit halves."""
    return [((w >> s) & 0xFFFF) - (((w >> s) & 0x8000) << 1) for s in (0, 16)]


def _dpx(x, y, c, op):
    """__viaddmin_s16x2 (op np.minimum) / __viaddmax_s16x2 (np.maximum):
    per signed 16-bit half op(x + y, c)."""
    lo, hi = (op(a + b, d) & 0xFFFF for a, b, d in
              zip(_halves(x), _halves(y), _halves(np.int64(c) + 0 * x)))
    return lo | (hi << 16)


def _byte_perm(x, y, sel):
    """__byte_perm: result byte n is byte (sel >> 4n) & 7 of (x, y)."""
    src = np.concatenate([_bytes4(x), _bytes4(y)], axis=-1)
    return _pack4(np.stack([src[..., (sel >> (4 * n)) & 7] for n in range(4)],
                           axis=-1))


def _colors(base, a, b):
    """colors: (n,) packed bases and modifiers -> (n, 4) colours [a, b, -a,
    -b] and their |c|^2."""
    rb, gg = base & 0xFF00FF, ((base >> 8) & 255) * 0x10001
    pa, pb = a * 0x10001, b * 0x10001
    na, nb = (0x10000 - a) * 0x10001, (0x10000 - b) * 0x10001
    g_p = _dpx(gg, (pa & 0xFFFF) | (pb & 0xFFFF0000), 0xFF00FF, np.minimum)
    g_m = _dpx(gg, (na & 0xFFFF) | (nb & 0xFFFF0000), 0, np.maximum)
    c = np.stack([_byte_perm(_dpx(rb, pa, 0xFF00FF, np.minimum), g_p, 0x1240),
                  _byte_perm(_dpx(rb, pb, 0xFF00FF, np.minimum), g_p, 0x1260),
                  _byte_perm(_dpx(rb, na, 0, np.maximum), g_m, 0x1240),
                  _byte_perm(_dpx(rb, nb, 0, np.maximum), g_m, 0x1260)], axis=-1)
    return c, _dot(c, c)


def _partials(c, k, px):
    """|c|^2 - 2 c.p of (n, 8) pixels against (n, 4) colours: (n, 8, 4)."""
    return k[:, None, :] - 2 * _dot(c[:, None, :], px[:, :, None])


def _member(f, s, k):
    return 8 * s + k if f else 4 * (k >> 1) + (k & 1) + 2 * s


def _subblock(px16, f, s):
    """(n, 16) packed pixels -> subblock s's (n, 8) under the (n,) flips."""
    return np.where(f[:, None], px16[:, [_member(1, s, k) for k in range(8)]],
                    px16[:, [_member(0, s, k) for k in range(8)]])


def _mean_word(px):
    """mean_word: the truncated mean (r and b summed as 16-bit halves)
    quantized to 555 and 444, packed as codecs.etc.pack_q_word packs it."""
    rb = (px & 0xFF00FF).sum(axis=1)
    r, g, b = (rb & 0xFFFF) >> 3, ((px >> 8) & 255).sum(axis=1) >> 3, rb >> 19
    return ((r >> 3) | ((g >> 3) << 5) | ((b >> 3) << 10) | ((r >> 4) << 15)
            | ((g >> 4) << 19) | ((b >> 4) << 23))


def _ext5(v):
    return (v * 8) | ((v >> 2) & 7)


def _ext4(v):
    return (v << 4) | v


def _f5(w, ch):
    return (w >> (5 * ch)) & 31


def _f4(w, ch):
    return (w >> (15 + 4 * ch)) & 15


def _bases(w1, w2):
    """bases: use_diff and the two packed decoded bases."""
    diff = np.all([(_f5(w2, ch) - _f5(w1, ch) >= -4)
                   & (_f5(w2, ch) - _f5(w1, ch) <= 3) for ch in range(3)], axis=0)

    def pack(fn):
        return sum(fn(ch) << (8 * ch) for ch in range(3))

    b0 = np.where(diff, pack(lambda ch: _ext5(_f5(w1, ch))),
                  pack(lambda ch: _ext4(_f4(w1, ch))))
    b1 = np.where(diff, pack(lambda ch: _ext5(_f5(w2, ch))),
                  pack(lambda ch: _ext4(_f4(w2, ch))))
    return diff, b0, b1


def _hi_word(f, w1, w2, cw0, cw1):
    diff, _, _ = _bases(w1, w2)
    h = f.astype(np.int64) | (diff.astype(np.int64) << 1)
    for ch, (s1, s2, t1) in enumerate(((27, 24, 28), (19, 16, 20), (11, 8, 12))):
        a5, c5 = _f5(w1, ch), _f5(w2, ch)
        h = h | np.where(diff, (a5 << s1) | (((c5 - a5) & 7) << s2),
                         (_f4(w1, ch) << t1) | (_f4(w2, ch) << s2))
    return h | (cw0 << 5) | (cw1 << 2)


def _sub_search(px, base):
    """sub_search: the first codeword of least error and that error."""
    n = len(px)
    errs = np.stack([_partials(*_colors(base, np.full(n, a), np.full(n, b)),
                               px).min(axis=-1).sum(axis=-1)
                     for a, b in _CB[:, :2]], axis=1)
    return errs.argmin(axis=1), errs.min(axis=1)


def _heuristic_cw(px, base):
    """heuristic_codeword, the deviation by __vabsdiffu4."""
    d = np.abs(_bytes4(base)[:, None, :3] - _bytes4(px)[..., :3])
    dev = (d.sum(axis=1) >> 3).max(axis=-1)
    return (dev[:, None] > _HEUR_THRESHOLDS).sum(axis=1)


def _heuristic_flip(px16):
    """heuristic_flip: the quadrant sums, (2,2) twice and (3,3) not."""
    ch = _bytes4(px16)[..., :3]
    s1, s2, s3, s4 = (ch[:, q].sum(axis=1) for q in
                      ([0, 1, 4, 5], [8, 9, 12, 13], [2, 3, 6, 7], [10, 11, 14, 10]))
    lr = ((s1 + s2) >> 3) - ((s3 + s4) >> 3)
    tb = ((s1 + s3) >> 3) - ((s2 + s4) >> 3)
    return ~((lr * lr).sum(axis=1) > (tb * tb).sum(axis=1))


def _index_word(px16, f, bases, cws):
    """index_word: per pixel of the chosen flip the first modifier of least
    error, its bits at etc_order(p) and etc_order(p) + 16."""
    lo = 0
    for s in (0, 1):
        sub = _subblock(px16, f, s)
        m = _partials(*_colors(bases[s], _CB[cws[s], 0], _CB[cws[s], 1]),
                      sub).argmin(axis=-1)
        pos = np.where(f[:, None], *[np.array([
            (p & 3) * 4 + (p >> 2) for p in (_member(fl, s, k) for k in range(8))])
            for fl in (1, 0)])
        lo = lo | ((m & 1) << pos).sum(axis=1) | ((m >> 1) << (pos + 16)).sum(axis=1)
    return lo


def _encode_block(px16, strategy):
    """encode_block on (n, 16) packed pixels. Returns (N, 8) uint8 blocks
    and, for SMALLER_ERROR, both flips' errors less the |p|^2 sum."""
    n = len(px16)
    errors = None

    def flip(f):
        subs = [_subblock(px16, f, s) for s in (0, 1)]
        w = [_mean_word(sub) for sub in subs]
        _, b0, b1 = _bases(*w)
        return subs, w, (b0, b1)

    if strategy == tetc.SMALLER_ERROR:
        found = []
        for f in (np.zeros(n, bool), np.ones(n, bool)):
            subs, w, b = flip(f)
            (c0, e0), (c1, e1) = _sub_search(subs[0], b[0]), _sub_search(subs[1], b[1])
            found.append((w, b, (c0, c1), e0 + e1))
        errors = (found[0][3], found[1][3])
        f = ~(errors[0] <= errors[1])  # lr wins ties
        w, b, cws = ([np.where(f, t, l) for l, t in zip(found[0][i], found[1][i])]
                     for i in range(3))
    else:
        f = (_heuristic_flip(px16) if strategy == tetc.HEURISTIC
             else np.full(n, strategy == tetc.SPLIT_HORIZONTALLY))
        subs, w, b = flip(f)
        pick = (_heuristic_cw if strategy == tetc.HEURISTIC
                else lambda sub, base: _sub_search(sub, base)[0])
        cws = [pick(sub, base) for sub, base in zip(subs, b)]
    hi, lo = _hi_word(f, *w, *cws), _index_word(px16, f, b, cws)
    words = [(v >> s) & 255 for v in (hi, lo) for s in (24, 16, 8, 0)]
    return np.stack(words, axis=-1).astype(np.uint8), errors


def _tie_blocks(rng, n=64):
    """Solid, two-colour and mirror-symmetric blocks: flips, codewords and
    modifiers tie on them."""
    solid = np.broadcast_to(rng.integers(0, 256, (n, 1, 3)), (n, 16, 3))
    two = np.where(rng.integers(0, 2, (n, 16, 1)) == 1,
                   rng.integers(0, 256, (n, 1, 3)), rng.integers(0, 256, (n, 1, 3)))
    return np.concatenate([solid, two, _symmetric_blocks(rng, n)]).astype(np.int32)


@pytest.mark.parametrize("cw", range(8))
def test_dpx_colors_equal_clamp(cw):
    """The colours' DPX halves and byte permutes give clamp8(base + m) per
    channel in codebook order, on every base value, the edges included."""
    v = np.arange(256)
    base = _pack_rgb(np.stack([v, v[::-1], (v * 7) % 256], axis=-1))
    c, k = _colors(base, np.full(256, _CB[cw, 0]), np.full(256, _CB[cw, 1]))
    want = np.clip(_bytes4(base)[:, None, :3] + _CB[cw][None, :, None], 0, 255)
    np.testing.assert_array_equal(_bytes4(c), np.concatenate(
        [want, np.zeros((256, 4, 1), np.int64)], axis=-1))
    np.testing.assert_array_equal(k, (want * want).sum(axis=-1))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_packed_encode_model_matches_twin(rng, strategy):
    """The packed searches (first codeword and modifier by strict '<'),
    the flip choice and the index word of the chosen flip alone give the
    twin's bytes."""
    px = np.concatenate([_etc_blocks(rng, 400), _tie_blocks(rng)])
    got, _ = _encode_block(_pack_rgb(px), strategy)
    np.testing.assert_array_equal(got, tetc.encode_etc1_blocks(_t(px),
                                                               strategy).numpy())


def test_packed_flip_choice_keeps_left_right_on_ties(rng):
    """SMALLER_ERROR compares the two flips' partial errors, without the
    |p|^2 sum both share: each plus that sum is the twin's flip error, and
    equal errors keep left/right."""
    px = np.concatenate([_symmetric_blocks(rng, 200), _tie_blocks(rng),
                         _etc_blocks(rng, 200)])
    px16 = _pack_rgb(px)
    got, (e_lr, e_tb) = _encode_block(px16, tetc.SMALLER_ERROR)
    psum = _dot(px16, px16).sum(axis=1)
    for flip, e in ((False, e_lr), (True, e_tb)):
        _, _, want = tetc._encode_one_flip(_t(px), flip, tetc.SMALLER_ERROR)
        np.testing.assert_array_equal(e + psum, want.numpy())
    tied = e_lr == e_tb
    assert tied[:200].all() and tied[200:].sum() >= 64  # symmetric, solid
    assert not (got[tied, 3] & 1).any()  # flip bit 0: left/right


def _random_payload(rng, n):
    """(n, 8) random ETC1 bytes whose first four blocks are differential
    with r + dr = 34 (a base of 272) or -4 (a base of -25)."""
    data = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    data[:4, 0] = [0xFB, 0x04, 0xFB, 0x04]  # r5 31, dr +3; r5 0, dr -4
    data[:4, 3] |= 2
    return data


def _out_of_range_bases(data):
    """Blocks of (N, 8) ETC1 bytes whose differential base plus delta
    leaves 0..31 in some channel."""
    hi = data[:, :4].astype(np.int64)
    hi = (hi[:, 0] << 24) | (hi[:, 1] << 16) | (hi[:, 2] << 8) | hi[:, 3]
    v = np.stack([(hi >> s) & 31 for s in (27, 19, 11)], axis=1)
    d = np.stack([(hi >> s) & 7 for s in (24, 16, 8)], axis=1)
    v2 = v + np.where(d >= 4, d - 8, d)
    return (((hi >> 1) & 1) == 1) & ((v2 < 0) | (v2 > 31)).any(axis=1)


def _quadrants(data):
    """quadrant: (N, 8) ETC1 bytes -> (N, 4) packed destination pixels,
    each the truncating average of a 2x2 of the decoded block, decoded per
    channel in int as block_pixel does."""
    d = data.astype(np.int64)
    hi = (d[:, 0] << 24) | (d[:, 1] << 16) | (d[:, 2] << 8) | d[:, 3]
    lo = (d[:, 4] << 24) | (d[:, 5] << 16) | (d[:, 6] << 8) | d[:, 7]
    diff = ((hi >> 1) & 1) == 1
    c1, c2 = [], []
    for s1, s2, t1 in ((27, 24, 28), (19, 16, 20), (11, 8, 12)):
        v, dl = (hi >> s1) & 31, (hi >> s2) & 7
        c1.append(np.where(diff, _ext5(v), _ext4((hi >> t1) & 15)))
        c2.append(np.where(diff, _ext5(v + np.where(dl >= 4, dl - 8, dl)),
                           _ext4((hi >> s2) & 15)))
    flip = (hi & 1) == 1
    cw = [(hi >> 5) & 7, (hi >> 2) & 7]
    px = np.zeros((len(d), 16, 3), np.int64)
    for p in range(16):
        x, y = p & 3, p >> 2
        first = np.where(flip, y < 2, x < 2)
        e = x * 4 + y
        idx = ((lo >> e) & 1) | (((lo >> (e + 16)) & 1) << 1)
        mod = _CB[np.where(first, cw[0], cw[1]), idx]
        for ch in range(3):
            px[:, p, ch] = np.clip(np.where(first, c1[ch], c2[ch]) + mod, 0, 255)
    quads = [px[:, [4 * (2 * (j >> 1) + dy) + 2 * (j & 1) + dx
                    for dy in (0, 1) for dx in (0, 1)]].sum(axis=1) >> 2
             for j in range(4)]
    return _pack_rgb(np.stack(quads, axis=1))


def test_fused_quadrants_match_twin(rng):
    """The fused level's decode into destination quadrants equals the twin's
    decode + 2x2 average, on random payloads with differential bases
    outside 0..255."""
    nby, nbx = 8, 12
    data = _random_payload(rng, nby * nbx)
    assert _out_of_range_bases(data).sum() >= 4
    quads = _quadrants(data).reshape(nby // 2, 2, nbx // 2, 2, 4)
    want = dxt_cuda.average_2x2(etc_cuda.etc1_decode_plain(
        _t(data), 4 * nby, 4 * nbx)[:, :, :3]).numpy()
    # (block row, quadrant row, row in it, block column, ...)
    want = want.reshape(nby // 2, 2, 2, nbx // 2, 2, 2, 3)
    want = _pack_rgb(want.transpose(0, 1, 3, 4, 2, 5, 6))
    np.testing.assert_array_equal(quads, want.reshape(quads.shape))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_packed_downsample_model_matches_twin(rng, strategy):
    """The fused level: source block q = 2 qy + qx makes destination
    quadrant q, then the encode; on random (malformed) and encoded
    payloads."""
    nby, nbx = 8, 12
    data = np.concatenate([
        _random_payload(rng, nby * nbx - 24),
        etc_cuda.etc1_encode_image(_t(_image(rng, 16, 24))).numpy()])
    quads = _quadrants(data).reshape(nby // 2, 2, nbx // 2, 2, 2, 2)
    # (block row, qy, block column, qx, row in quadrant, column) -> 16 pixels
    px16 = quads.transpose(0, 2, 1, 4, 3, 5).reshape(-1, 16)
    got, _ = _encode_block(px16, strategy)
    want = etc_cuda.etc1_downsample_plain(_t(data), nby, nbx, strategy)
    np.testing.assert_array_equal(got, want.numpy())
