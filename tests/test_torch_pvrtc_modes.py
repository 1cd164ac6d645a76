"""Numpy models of csrc/pvrtc.cu's mode + pack, held to the twin and to the
JAX package.

The kernel gives thread t of an image the block in Z-order slot t: (by, bx)
are t's even and odd bits, compacted. It loads the right and lower
neighbours' bytes; its shuffle design finds their slots by dilated
increments of t's x and y bits and takes those in the same warp by shuffle
from the lane that holds them. The
modulation (values 0..3) goes four pixels a word: byte-SAD counters, one
popcount for the pixels of modulation 1 or 2, and the 1bpp and 2bpp words
each gathered by one multiply a row. The models take each step as the
kernel does, vectorised over threads, every word a 32-bit pattern, so a
carry or a wrong lane would show. The whole modelled kernel, in each of its
three designs (``PackDesign``), is held to ``pvrtc_modes_pack_plain`` and
to texcomp's ``modes_pack_colors_packed`` in interpret mode. Tolerance is
0: every step is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (PVRTC_MODE_THRESHOLDS, pvrtc_mode_counts,
                        pvrtc_mode_thresholds)
from texcomp.ops import pvrtc_fast as pf
from texcomp_torch.codecs import pvrtc
from texcomp_torch.ops import pvrtc_cuda

M32 = 0xFFFFFFFF
#: Widths of the (2 nbx, nbx) grids of square power-of-two images, 8^2 to
#: 512^2.
GRIDS = [1, 2, 4, 8, 16, 32, 64]
#: PackDesign: slot threads with shuffled neighbours, slot threads with
#: loaded neighbours, row-major threads.
DESIGNS = [0, 1, 2]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bytes4(w):
    return np.stack([(w >> (8 * k)) & 255 for k in range(4)], axis=-1)


def _sad(a, b):
    """__vsadu4: the sum of the four bytes' absolute differences."""
    return np.abs(_bytes4(a) - _bytes4(b)).sum(axis=-1)


def _byte_perm(x, y, s):
    """__byte_perm: byte k of the result is byte (s >> 4k) & 7 of y:x."""
    src = np.concatenate([_bytes4(x), _bytes4(y)], axis=-1)
    return sum(src[..., (s >> (4 * k)) & 7] << (8 * k) for k in range(4))


def _spread(v):
    """spread_bits: bit j of v at 2j."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def _compact(v):
    """compact_bits: the even bits of v, packed."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    return (v | (v >> 8)) & 0xFFFF


def _neighbour_slots(t, nbx):
    """The dilated increments: the slots of the right (bx + 1) and lower
    (by + 1) neighbours of slot t, each wrapped within the image."""
    last = (2 << (2 * (nbx.bit_length() - 1))) - 1
    xs, ys = 0xAAAAAAAA & last, 0x55555555 & last
    sr = ((((t | (~xs & M32)) + 2) & M32) & xs) | (t & ys)
    sb = ((((t | (~ys & M32)) + 1) & M32) & ys) | (t & xs)
    return sr, sb


def _column0(w0, w2, w4, w6):
    return _byte_perm(_byte_perm(w0, w2, 0x40), _byte_perm(w4, w6, 0x40),
                      0x5410)


def _top_bytes(p):
    return _byte_perm(_byte_perm(p[0], p[1], 0x73), _byte_perm(p[2], p[3], 0x73),
                      0x5410)


def _row_words(mod):
    """(N, 32) uint8 -> (N, 8) int64 words, row py in words 2 py, 2 py + 1."""
    return np.ascontiguousarray(mod).view("<u4").astype(np.int64)


def _one_row(a, b):
    """The 1bpp byte of a row: bit px = m >> 1, in byte 3 of the product."""
    return ((((a >> 1) | (b << 3)) & 0x11111111) * 0x01020408) & M32


def _two_row(a, b, py):
    """The 2bpp byte of row py: bits 2j = m at px = 2j + (py & 1)."""
    return (_byte_perm(a, b, 0x7531 if py & 1 else 0x6420) * 0x01041040) & M32


def _intermediate(w):
    """Pixels of modulation 1 or 2 of (N, 8) words: two popcounts."""
    count = 0
    for z in (w[:, 0] | (w[:, 1] << 2) | (w[:, 2] << 4) | (w[:, 3] << 6),
              w[:, 4] | (w[:, 5] << 2) | (w[:, 6] << 4) | (w[:, 7] << 6)):
        bits = (z ^ (z >> 1)) & 0x55555555
        count = count + np.array([bin(int(x)).count("1") for x in bits])
    return count


def _counters(w, right, below0, below1):
    """The crossed counters (vertical_count, horizontal_count) of (N, 8)
    words by byte SADs."""
    vertical = horizontal = 0
    for py in range(4):
        a, b = w[:, 2 * py], w[:, 2 * py + 1]
        vertical = vertical + _sad(a, _byte_perm(a, b, 0x4321))
        vertical = vertical + _sad(b, _byte_perm(b, right, 0x4321 + 0x1000 * py))
        horizontal = horizontal + _sad(a, w[:, 2 * py + 2] if py < 3 else below0)
        horizontal = horizontal + _sad(b, w[:, 2 * py + 3] if py < 3 else below1)
    return vertical, horizontal


def _mode_word(w, vertical, horizontal):
    """(mode, modulation word) of (N, 8) words."""
    inter = _intermediate(w)
    mode = np.where(inter <= 4, 0, np.where(
        (vertical > 10) & (vertical > 2 * horizontal), 2,
        np.where((horizontal > 10) & (horizontal > 2 * vertical), 3, 1)))
    rows = [(w[:, 2 * py], w[:, 2 * py + 1]) for py in range(4)]
    one = _top_bytes([_one_row(a, b) for a, b in rows])
    two = _top_bytes([_two_row(a, b, py) for py, (a, b) in enumerate(rows)])
    two = (two & ~0x00100001 & M32) | (mode != 1) | ((mode == 2) << 20)
    return mode, np.where(mode == 0, one, two)


def _color_word(ab, mode):
    """EncodeColors as the kernel computes it from the packed (A, B)."""
    c = ab.view(np.uint32).astype(np.int64)
    ar, ag, ab_, aa = (_bytes4(c[:, 0])[:, k] for k in range(4))
    br, bg, bb, ba = (_bytes4(c[:, 1])[:, k] for k in range(4))
    color = np.where(aa == 255,
                     (1 << 15) | ((ab_ >> 4) << 1) | ((ag >> 3) << 5)
                     | ((ar >> 3) << 10),
                     ((ab_ >> 5) << 1) | ((ag >> 4) << 4) | ((ar >> 4) << 8)
                     | ((aa >> 5) << 12))
    color |= np.where(ba == 255,
                      (1 << 31) | ((bb >> 3) << 16) | ((bg >> 3) << 21)
                      | ((br >> 3) << 26),
                      ((bb >> 4) << 16) | ((bg >> 4) << 20) | ((br >> 4) << 24)
                      | ((ba >> 5) << 28))
    return color | (mode != 0)


def _model_modes_pack(mod, ab, nby, nbx, design):
    """modes_pack_kernel<design> on (N, 32) uint8 modulation and (N, 2)
    int32 ab: (N, 8) uint8 records. The shuffle design runs whole warps,
    spare lanes included, and takes a neighbour's bytes from the lane that
    holds it."""
    words = _row_words(mod)
    total = len(words)
    lx = nbx.bit_length() - 1
    last = (2 << (2 * lx)) - 1
    threads = -(-total // 32) * 32 if design == 0 else total
    n = np.arange(threads, dtype=np.int64)
    live = n < total
    n = np.where(live, n, total - 1)
    first, t = n & ~last, n & last
    if design == 2:
        by, bx = t >> lx, t & (nbx - 1)
    else:
        by, bx = _compact(t), _compact(t >> 1)
    row = first + (by << lx)
    rx, ry = (bx + 1) & (nbx - 1), (by + 1) & (nby - 1)
    w = words[row + bx]
    right_words = words[row + rx]
    right = _column0(*(right_words[:, k] for k in (0, 2, 4, 6)))
    below0, below1 = (words[first + (ry << lx) + bx][:, k] for k in (0, 1))
    if design == 0:
        sr, sb = _neighbour_slots(t, nbx)
        warp = np.arange(threads) & ~31
        col0 = _column0(*(w[:, k] for k in (0, 2, 4, 6)))
        lane_r = warp + (((first & M32) + sr) & 31)
        lane_b = warp + (((first & M32) + sb) & 31)
        right = np.where((sr ^ t) >> 5, right, col0[lane_r])
        below0 = np.where((sb ^ t) >> 5, below0, w[lane_b, 0])
        below1 = np.where((sb ^ t) >> 5, below1, w[lane_b, 1])
    vertical, horizontal = _counters(w, right, below0, below1)
    mode, mod_word = _mode_word(w, vertical, horizontal)
    color = _color_word(ab[row + bx], mode)
    slot = first + (_spread(by) | (_spread(bx) << 1)) if design == 2 else n
    out = np.zeros((total, 2), np.uint32)
    out[slot[live]] = np.stack([mod_word, color], -1)[live]
    return out.view(np.uint8)


# --- the slot threads' indexing ---------------------------------------------


@pytest.mark.parametrize("nbx", GRIDS)
def test_slot_compaction_inverts_zorder(nbx):
    """Every slot of every grid: (compact(t), compact(t >> 1)) is the block
    that the Z-order permutation puts in slot t, and spreading it back
    gives t."""
    nby = 2 * nbx
    t = np.arange(nby * nbx, dtype=np.int64)
    by, bx = _compact(t), _compact(t >> 1)
    assert by.max() == nby - 1 and bx.max() == nbx - 1
    np.testing.assert_array_equal(by * nbx + bx,
                                  pvrtc._perm(nbx, nby, "cpu").numpy())
    np.testing.assert_array_equal(_spread(by) | (_spread(bx) << 1), t)


@pytest.mark.parametrize("nbx", GRIDS)
def test_dilated_increments_find_wrapped_neighbours(nbx):
    """The right and lower neighbours' slots, wrapped within the image: on
    a one-block-wide grid a block is its own right neighbour."""
    nby = 2 * nbx
    t = np.arange(nby * nbx, dtype=np.int64)
    by, bx = _compact(t), _compact(t >> 1)
    sr, sb = _neighbour_slots(t, nbx)
    np.testing.assert_array_equal(_compact(sr), by)
    np.testing.assert_array_equal(_compact(sr >> 1), (bx + 1) % nbx)
    np.testing.assert_array_equal(_compact(sb), (by + 1) % nby)
    np.testing.assert_array_equal(_compact(sb >> 1), bx)
    if nbx == 1:
        np.testing.assert_array_equal(sr, t)


@pytest.mark.parametrize("nbx,batch", [(1, 37), (2, 9), (4, 3), (8, 2),
                                       (64, 1)])
def test_shuffle_lanes_hold_the_neighbours(nbx, batch):
    """In a stack of images, a warp's lane for a neighbour in the warp holds
    that neighbour's block; the neighbours outside the warp are those at
    bx = 3 (mod 4) or by = 7 (mod 8), and only on grids of more than 32
    blocks (an image of 32 or fewer lies whole in a warp)."""
    nby = 2 * nbx
    nb = nby * nbx
    n = np.arange(batch * nb, dtype=np.int64)
    first, t = n - n % nb, n % nb
    by, bx = _compact(t), _compact(t >> 1)
    sr, sb = _neighbour_slots(t, nbx)
    for s, ny, nx in ((sr, by, (bx + 1) % nbx), (sb, (by + 1) % nby, bx)):
        inside = (s ^ t) >> 5 == 0
        lane = (n & ~31) + ((first + s) & 31)
        np.testing.assert_array_equal(lane[inside], (first + s)[inside])
        held = lane[inside] - first[inside]
        np.testing.assert_array_equal(_compact(held), ny[inside])
        np.testing.assert_array_equal(_compact(held >> 1), nx[inside])
        outside = ((bx % 4 == 3) if s is sr else (by % 8 == 7)) & (nb > 32)
        np.testing.assert_array_equal(~inside, outside)


# --- the arithmetic, four pixels a word --------------------------------------


def _rows_of(rng, n):
    return rng.integers(0, 4, (n, 4, 8))


def _pack(m):
    """(..., 4) values -> (...) int64 words, value k in byte k."""
    return sum(m[..., k].astype(np.int64) << (8 * k) for k in range(4))


@pytest.mark.parametrize("kind", ["random", "thresholds"])
def test_sad_counters_equal_scalar_deltas(rng, kind):
    """The crossed counters by __vsadu4 and __byte_perm against the scalar
    sums of the reference (CalculateBlockModulationMode) as
    chip_smoke.pvrtc_mode_counts takes them, the right neighbour's column 0
    and the lower neighbour's row 0 included."""
    if kind == "random":
        m = _rows_of(rng, 20_000)
        right, below = rng.integers(0, 4, (20_000, 4)), rng.integers(0, 4, (20_000, 8))
    else:
        mod, _ = pvrtc_mode_thresholds(64, 4)
        m = mod.reshape(4, 16, 8, 4, 8).astype(np.int64)
        right = np.roll(m, -1, axis=2)[..., :, 0].reshape(-1, 4)
        below = np.roll(m, -1, axis=1)[..., 0, :].reshape(-1, 8)
        m = m.reshape(-1, 4, 8)
    w = _pack(m.reshape(-1, 8, 4))
    got = _counters(w, _pack(right), _pack(below[:, :4]), _pack(below[:, 4:]))
    _, vertical, horizontal = pvrtc_mode_counts(m, right, below)
    np.testing.assert_array_equal(got[0], vertical)
    np.testing.assert_array_equal(got[1], horizontal)


@pytest.mark.parametrize("k", range(8))
def test_popcount_intermediate_exhaustive(rng, k):
    """Every word of four values 0..3 in word k of a block, the other words
    random: the two popcounts count the pixels of modulation 1 or 2."""
    words = np.arange(256)
    m = rng.integers(0, 4, (256, 8, 4))
    m[:, k] = (words[:, None] >> (2 * np.arange(4))) & 3
    got = _intermediate(_pack(m))
    np.testing.assert_array_equal(got, ((m == 1) | (m == 2)).sum((1, 2)))


def _all_row_pairs():
    """Every (a, b) pair of words of four values 0..3: 65,536 rows."""
    v = (np.arange(256)[:, None] >> (2 * np.arange(4))) & 3
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    return v[a.reshape(-1)], v[b.reshape(-1)]


def test_1bpp_gather_exhaustive():
    """Every row of eight values 0..3: byte 3 of one multiply is the row's
    1bpp bits (bit px = m >> 1), and no product term reaches another's
    bits."""
    ma, mb = _all_row_pairs()
    p = _one_row(_pack(ma), _pack(mb))
    row = np.concatenate([ma, mb], axis=1)
    np.testing.assert_array_equal(p >> 24, ((row >> 1) << np.arange(8)).sum(1))
    assert p.max() < 1 << 32


@pytest.mark.parametrize("py", range(4))
def test_2bpp_checkerboard_exhaustive(py):
    """Every row of eight values 0..3: byte 3 of one multiply holds the
    checkerboard pixels px = 2j + (py & 1) as 2-bit fields j."""
    ma, mb = _all_row_pairs()
    p = _two_row(_pack(ma), _pack(mb), py)
    row = np.concatenate([ma, mb], axis=1)
    kept = row[:, (py & 1)::2]
    np.testing.assert_array_equal(p >> 24, (kept << (2 * np.arange(4))).sum(1))


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_mode_words_equal_twin(rng, mode):
    """The 1bpp word and the 2bpp word with its flags at bits 0 and 20
    against the twin's _block_modulation_data, for each mode."""
    m = _rows_of(rng, 4096)
    w = _pack(m.reshape(-1, 8, 4))
    modes = np.full(len(m), mode)
    rows = [(w[:, 2 * py], w[:, 2 * py + 1]) for py in range(4)]
    one = _top_bytes([_one_row(a, b) for a, b in rows])
    two = _top_bytes([_two_row(a, b, py) for py, (a, b) in enumerate(rows)])
    two = (two & ~0x00100001 & M32) | (mode != 1) | ((mode == 2) << 20)
    got = one if mode == 0 else two
    want = pvrtc._block_modulation_data(
        _t(m.transpose(1, 0, 2).reshape(4, -1)).int(),
        _t(modes.reshape(1, -1)).int()).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want.reshape(-1))


# --- the whole modelled kernel against the twin and texcomp ------------------


def _records_jax(mod, ab, batch, nby, nbx):
    """texcomp's modes_pack_colors_packed (interpret mode) as (N, 8) uint8
    Z-order records."""
    m = jnp.asarray(mod.T.astype(np.int32))
    nh, nv = pf._mode_edges_batched(m, batch, nby, 1, nbx)
    words = np.asarray(pf.modes_pack_colors_packed(
        m, nh, nv, jnp.asarray(ab.view(np.uint32).T.copy()), interpret=True))
    perm = pvrtc.zorder_block_permutation(nbx, nby)
    w = words.reshape(2, batch, nby * nbx)[:, :, perm]
    return np.stack([w[0], w[1]], -1).astype("<u4").view(np.uint8).reshape(-1, 8)


def _case(rng, kind):
    """(modulation, ab, nby, nbx) of a case: random values, or blocks at
    the mode thresholds (chip_smoke.pvrtc_mode_thresholds) on a 256^2
    image, a stack of 8^2 images (one block wide), of 16^2 images (a warp
    spans four) and of 64^2 images (a CTA spans two), and one 8^2 image
    (30 spare lanes)."""
    side, batch = {"random 256^2": (256, 1), "random 3 x 64^2": (64, 3),
                   "thresholds 256^2": (256, 1), "thresholds 64 x 8^2": (8, 64),
                   "thresholds 32 x 16^2": (16, 32),
                   "thresholds 4 x 64^2": (64, 4),
                   "thresholds 8^2": (8, 1)}[kind]
    nby, nbx = side // 4, side // 8
    n = batch * nby * nbx
    if kind.startswith("random"):
        mod = rng.integers(0, 4, (n, 32), dtype=np.uint8)
    else:
        mod, _ = pvrtc_mode_thresholds(side, batch)
    ab = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    ab[::3] |= 0xFF000000  # opaque A and B in every third block
    return mod, ab.view(np.int32), nby, nbx


CASES = ["random 256^2", "random 3 x 64^2", "thresholds 256^2",
         "thresholds 64 x 8^2", "thresholds 32 x 16^2", "thresholds 4 x 64^2",
         "thresholds 8^2"]


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("kind", CASES)
def test_modelled_kernel_matches_twin(rng, kind, design):
    mod, ab, nby, nbx = _case(rng, kind)
    got = _model_modes_pack(mod, ab, nby, nbx, design)
    want = pvrtc_cuda.pvrtc_modes_pack_plain(_t(mod), _t(ab), nby, nbx).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", CASES)
def test_modelled_kernel_matches_texcomp(rng, kind):
    mod, ab, nby, nbx = _case(rng, kind)
    got = _model_modes_pack(mod, ab, nby, nbx, 0)
    batch = len(mod) // (nby * nbx)
    np.testing.assert_array_equal(got, _records_jax(mod, ab, batch, nby, nbx))


def test_threshold_blocks_take_their_modes():
    """Every threshold is reached on the 256^2 grid, and each block at one
    takes the threshold's mode in the twin; every mode occurs."""
    mod, label = pvrtc_mode_thresholds(256)
    modes = pvrtc._block_modulation_modes(_t(mod).int().reshape(
        1, 64, 32, 4, 8).transpose(2, 3).reshape(1, 256, 256)).reshape(-1)
    want = np.array([mode for _, mode in PVRTC_MODE_THRESHOLDS.values()])
    at = label >= 0
    np.testing.assert_array_equal(modes.numpy()[at], want[label[at]])
    counts = np.bincount(label[at], minlength=len(want))
    assert (counts >= 10).all(), counts
    assert set(modes.numpy().tolist()) == {0, 1, 2, 3}
