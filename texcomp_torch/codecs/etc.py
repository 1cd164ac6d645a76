"""ETC1 block codec in plain PyTorch: reference quality, and the HQ search.

The reference's per-block ETC1 codec (image_compression/internal/
etc_compressor.cc) over (N, 16, 3) int32 pixel tensors on any device. A
block is the reference's 64-bit word, carried as two 32-bit words hi and
lo. torch has no uint32 arithmetic on the CPU, so a word is an int32
tensor holding the bit pattern (``texcomp_torch.core.bits``); every right
shift is masked to the field it reads. The bytes are the hardware order:
big-endian hi, then big-endian lo (EtcHelper::BuildBlock,
etc_compressor.cc:158-194).

The search (2 flips x 2 subblocks x 8 codewords x 4 modifiers x 8 pixels,
etc_compressor.cc:350-409) is an (N, 16, 8, 4) error tensor per flip.
Every argmin takes the first occurrence, as the reference's strictly-less
update scans do. ``encode_etc1_blocks`` runs it over chunks of
:data:`ENCODE_CHUNK` blocks, so that a 4096x4096 image (1,048,576 blocks)
needs a few hundred MiB of scratch, not several GiB. This module is the
ground truth for the CUDA kernels in ``texcomp_torch/csrc/etc.cu``.

The high-quality search (``quality="high"``) scores 40 candidate base
pairs per flip (:func:`hq_candidate_words`) through the same exhaustive
search, refits twice by least squares and probes +-1 around the refit
(:func:`hq_search`); :func:`hq_pick_flip` chooses between the flips. This
module holds that arithmetic, the twin of the fused search kernel; the
driver, ``ops/etc_cuda.etc1_hq_encode_blocks``, runs it on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from texcomp_torch.core import bits
from texcomp_torch.core import colors as cc
from texcomp_torch.core.constants import ETC1_CODEBOOK, ETC1_HEURISTIC_THRESHOLDS

# Strategy codes (etc_compressor.h:57-66).
SPLIT_HORIZONTALLY = 0
SPLIT_VERTICALLY = 1
SMALLER_ERROR = 2
HEURISTIC = 3

#: Blocks per step of the encode search: the (n, 16, 8, 4) int32 error
#: tensor of one step is 128 MiB at 65,536 blocks.
ENCODE_CHUNK = 1 << 16

# Row-major pixel p = 4y + x -> ETC pixel-index order x*4 + y
# (etc_compressor.cc:131-137), and the pixel coordinates.
_P_ETC = [(p % 4) * 4 + p // 4 for p in range(16)]
_PX = np.array([p % 4 for p in range(16)])
_PY = np.array([p // 4 for p in range(16)])


def _codebook(device) -> torch.Tensor:
    return torch.from_numpy(ETC1_CODEBOOK).to(device)  # (8, 4) int32


def words_to_bytes(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(N,) int32 word pairs -> (N, 8) uint8 in ETC1 hardware byte order
    (big-endian hi, then big-endian lo; etc_compressor.cc:172-194)."""
    parts = [(w >> s) & 0xFF for w in (hi, lo) for s in (24, 16, 8, 0)]
    return torch.stack(parts, dim=-1).to(torch.uint8)


def bytes_to_words(data: torch.Tensor):
    """(N, 8) uint8 -> (hi, lo) int32 word pairs (bit patterns)."""
    d = data.to(torch.int32)
    hi = (d[:, 0] << 24) | (d[:, 1] << 16) | (d[:, 2] << 8) | d[:, 3]
    lo = (d[:, 4] << 24) | (d[:, 5] << 16) | (d[:, 6] << 8) | d[:, 7]
    return hi, lo


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_base_colors(hi: torch.Tensor):
    """Base colors per subblock from the hi word (Etc1BlockDecoder,
    etc_compressor.cc:227-265). Returns (c1, c2), each an (r, g, b) tuple.

    In differential mode the second base is Extend5Bit(v + d), where the
    sum can leave 0..31 in a malformed block; Extend5Bit masks the bits it
    replicates (color_util.h:200-202), and the bytes depend on that."""
    diff = bits.get_bits(hi, 1, 1) == 1
    b5 = [bits.get_bits(hi, s, 5) for s in (27, 19, 11)]
    d3 = [bits.extend_sign_bit(bits.get_bits(hi, s, 3), 3) for s in (24, 16, 8)]
    c1_diff = [cc.extend_5bit(v) for v in b5]
    c2_diff = [cc.extend_5bit(v + d) for v, d in zip(b5, d3)]
    c1_ind = [cc.extend_4bit(bits.get_bits(hi, s, 4)) for s in (28, 20, 12)]
    c2_ind = [cc.extend_4bit(bits.get_bits(hi, s, 4)) for s in (24, 16, 8)]
    c1 = tuple(torch.where(diff, a, b) for a, b in zip(c1_diff, c1_ind))
    c2 = tuple(torch.where(diff, a, b) for a, b in zip(c2_diff, c2_ind))
    return c1, c2


def decode_etc1_blocks(data: torch.Tensor) -> torch.Tensor:
    """Decode (N, 8) uint8 ETC1 blocks to (N, 16, 3) int32 pixels
    (DecodeBlock, etc_compressor.cc:282-289)."""
    hi, lo = bytes_to_words(data)
    device = data.device
    flip = bits.get_bits(hi, 0, 1) == 1
    cw0 = bits.get_bits(hi, 5, 3)  # first subblock's codeword (:235)
    cw1 = bits.get_bits(hi, 2, 3)
    c1, c2 = _decode_base_colors(hi)

    # Pixel modifier index: bit p (low) and bit p + 16 (high) of lo, in the
    # ETC column-major order p = x*4 + y (etc_compressor.cc:142-146).
    p = torch.tensor(_P_ETC, dtype=torch.int32, device=device)
    idx = ((lo[:, None] >> p) & 1) | (((lo[:, None] >> (p + 16)) & 1) << 1)

    # flip: the top 4x2 is the first subblock; else the left 2x4 (:206).
    top = torch.from_numpy(_PY < 2).to(device)
    left = torch.from_numpy(_PX < 2).to(device)
    is_first = torch.where(flip[:, None], top, left)  # (N, 16)
    cw = torch.where(is_first, cw0[:, None], cw1[:, None])
    modifier = _codebook(device)[cw.long(), idx.long()]  # (N, 16)

    out = [cc.clamp8(torch.where(is_first, a[:, None], b[:, None]) + modifier)
           for a, b in zip(c1, c2)]
    return torch.stack(out, dim=-1)  # (N, 16, 3)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _subblock_mask(flip: bool, device) -> torch.Tensor:
    """(16,) bool: True for the first subblock's pixels (row-major)."""
    return torch.from_numpy((_PY < 2) if flip else (_PX < 2)).to(device)


def _argmin_first(values: torch.Tensor, dim: int) -> torch.Tensor:
    """First index of the minimum along ``dim`` (strict-less scan order)."""
    best = values.amin(dim=dim, keepdim=True)
    n = values.shape[dim]
    shape = [1] * values.dim()
    shape[dim] = n
    idx = torch.arange(n, device=values.device).reshape(shape)
    return torch.where(values == best, idx, n).amin(dim=dim)


def _encode_one_flip(rgb: torch.Tensor, flip: bool, strategy: int):
    """FindBestSubblockEncoding for a fixed flip (etc_compressor.cc:460-542)
    with the reference's truncating quantization (QuantizeRgbFast,
    :474-516). Returns (hi, lo, error): (N,) int32 words and the (N,) int32
    block error of the chosen encoding."""
    mask0 = _subblock_mask(flip, rgb.device).to(torch.int32)[None, :]
    # Subblock truncating averages (ComputeAverageColor, :299-312).
    avg1 = [(rgb[:, :, ch] * mask0).sum(dim=1, dtype=torch.int32) >> 3
            for ch in range(3)]
    avg2 = [(rgb[:, :, ch] * (1 - mask0)).sum(dim=1, dtype=torch.int32) >> 3
            for ch in range(3)]
    return _finish_flip(rgb, flip, strategy,
                        [a >> 3 for a in avg1], [a >> 3 for a in avg2],
                        [a >> 4 for a in avg1], [a >> 4 for a in avg2])


def _finish_flip(rgb: torch.Tensor, flip: bool, strategy: int,
                 q1_555, q2_555, q1_444, q2_444):
    """Mode decision, codeword and pixel-index search, and word packing for
    given quantized subblock bases (the tail of FindBestSubblockEncoding,
    etc_compressor.cc:480-542)."""
    device = rgb.device
    mask0 = _subblock_mask(flip, device)
    mask0i = mask0.to(torch.int32)[None, :]
    d555 = [b - a for a, b in zip(q1_555, q2_555)]
    use_diff = torch.ones_like(d555[0], dtype=torch.bool)
    for d in d555:
        use_diff &= (d >= -4) & (d <= 3)

    # Decoded base colors for the search (:496-516).
    dec1 = [torch.where(use_diff, cc.extend_5bit(q5), cc.extend_4bit(q4))
            for q5, q4 in zip(q1_555, q1_444)]
    dec2 = [torch.where(use_diff, cc.extend_5bit(q5), cc.extend_4bit(q4))
            for q5, q4 in zip(q2_555, q2_444)]

    # Per-(pixel, codeword, modifier) squared error, summed channel by
    # channel so that no (N, 16, 8, 4, 3) tensor is made.
    cb = _codebook(device)[None, None]  # (1, 1, 8, 4)
    err = None
    for ch in range(3):
        base = torch.where(mask0[None, :], dec1[ch][:, None], dec2[ch][:, None])
        cand = cc.clamp8(base[:, :, None, None] + cb)  # (N, 16, 8, 4)
        d = cand - rgb[:, :, ch, None, None]
        err = d * d if err is None else err + d * d
    best_mod = _argmin_first(err, 3)  # (N, 16, 8)
    best_err = err.amin(dim=3)
    del err
    err_sb1 = (best_err * mask0i[:, :, None]).sum(dim=1, dtype=torch.int32)
    err_sb2 = (best_err * (1 - mask0i)[:, :, None]).sum(dim=1,
                                                        dtype=torch.int32)

    if strategy == HEURISTIC:
        # FindCodewordHeuristic (:415-455): the codeword from the largest
        # per-channel mean absolute deviation from the *decoded* base color
        # (:524-527), counted against the thresholds.
        th = torch.from_numpy(ETC1_HEURISTIC_THRESHOLDS).to(device)

        def heuristic_cw(decoded, mask):
            dev = None
            for ch in range(3):
                ad = ((decoded[ch][:, None] - rgb[:, :, ch]).abs() * mask)
                ad = ad.sum(dim=1) >> 3
                dev = ad if dev is None else torch.maximum(dev, ad)
            return (dev[:, None] > th[None, :]).sum(dim=1)

        cw1 = heuristic_cw(dec1, mask0i)
        cw2 = heuristic_cw(dec2, 1 - mask0i)
        e1 = torch.gather(err_sb1, 1, cw1[:, None])[:, 0]
        e2 = torch.gather(err_sb2, 1, cw2[:, None])[:, 0]
    else:
        # FindBestCodeword (:391-409): exhaustive, first-occurrence argmin.
        cw1 = _argmin_first(err_sb1, 1)
        cw2 = _argmin_first(err_sb2, 1)
        e1 = err_sb1.amin(dim=1)
        e2 = err_sb2.amin(dim=1)

    # Each pixel's modifier index under its subblock's codeword.
    cw_px = torch.where(mask0[None, :], cw1[:, None], cw2[:, None])  # (N, 16)
    mod = torch.gather(best_mod, 2, cw_px[:, :, None])[:, :, 0].to(torch.int32)

    # lo: bit p = mod & 1, bit p + 16 = mod >> 1, p in ETC order
    # (StorePixelIndex, :150-156). The 16 fields are disjoint, so a sum
    # is their OR.
    p = torch.tensor(_P_ETC, dtype=torch.int32, device=device)
    lo = (((mod & 1) << p) | ((mod >> 1) << (p + 16))).sum(dim=1,
                                                          dtype=torch.int32)

    # hi (:485-541). Differential: base 555 at 27/19/11 and delta 333 at
    # 24/16/8 (StoreDiffModeColors, :328-337); individual: 444 + 444 at
    # 28/20/12 and 24/16/8 (StoreNormalModeColors, :316-324).
    hi = torch.full_like(lo, 1 if flip else 0)
    hi = hi | (use_diff.to(torch.int32) << 1)
    for ch, (s1, s2, t1) in enumerate(((27, 24, 28), (19, 16, 20),
                                       (11, 8, 12))):
        diff_bits = bits.set_bits(torch.zeros_like(hi), s1, 5, q1_555[ch])
        diff_bits = bits.set_bits(diff_bits, s2, 3, d555[ch])
        ind_bits = bits.set_bits(torch.zeros_like(hi), t1, 4, q1_444[ch])
        ind_bits = bits.set_bits(ind_bits, s2, 4, q2_444[ch])
        hi = hi | torch.where(use_diff, diff_bits, ind_bits)
    hi = bits.set_bits(hi, 5, 3, cw1)
    hi = bits.set_bits(hi, 2, 3, cw2)
    return hi, lo, e1 + e2


def _heuristic_flip(rgb: torch.Tensor) -> torch.Tensor:
    """Per-block flip choice for kHeuristic (etc_compressor.cc:553-574).

    sum4 counts pixel (2,2) twice and omits (3,3), as the reference does
    (:563-564). The sums are non-negative, so ``>> 3`` is the reference's
    truncating /8. Returns (N,) bool: True -> flipped (top/bottom)."""
    def quad(ps):
        return [sum(rgb[:, 4 * y + x, ch] for y, x in ps) for ch in range(3)]

    sum1 = quad([(0, 0), (0, 1), (1, 0), (1, 1)])
    sum2 = quad([(2, 0), (2, 1), (3, 0), (3, 1)])
    sum3 = quad([(0, 2), (0, 3), (1, 2), (1, 3)])
    sum4 = quad([(2, 2), (2, 3), (3, 2), (2, 2)])  # (2,2) twice

    def avg(a, b):
        return [(x + y) >> 3 for x, y in zip(a, b)]

    def err3(a, b):
        return sum((x - y) * (x - y) for x, y in zip(a, b))

    # lr (not flipped) iff err(left, right) > err(top, bottom).
    return ~(err3(avg(sum1, sum2), avg(sum3, sum4))
             > err3(avg(sum1, sum3), avg(sum2, sum4)))


def _encode_chunk(rgb: torch.Tensor, strategy: int) -> torch.Tensor:
    if strategy == SPLIT_HORIZONTALLY:
        hi, lo, _ = _encode_one_flip(rgb, True, strategy)
    elif strategy == SPLIT_VERTICALLY:
        hi, lo, _ = _encode_one_flip(rgb, False, strategy)
    elif strategy == HEURISTIC:
        hi_f, lo_f, _ = _encode_one_flip(rgb, False, strategy)
        hi_t, lo_t, _ = _encode_one_flip(rgb, True, strategy)
        flip = _heuristic_flip(rgb)
        hi = torch.where(flip, hi_t, hi_f)
        lo = torch.where(flip, lo_t, lo_f)
    elif strategy == SMALLER_ERROR:
        # lr wins ties (etc_compressor.cc:583).
        hi_f, lo_f, err_f = _encode_one_flip(rgb, False, strategy)
        hi_t, lo_t, err_t = _encode_one_flip(rgb, True, strategy)
        take_lr = err_f <= err_t
        hi = torch.where(take_lr, hi_f, hi_t)
        lo = torch.where(take_lr, lo_f, lo_t)
    else:
        raise ValueError(f"unknown ETC1 strategy {strategy!r}")
    return words_to_bytes(hi, lo)


def encode_etc1_blocks(rgb: torch.Tensor,
                       strategy: int = SMALLER_ERROR) -> torch.Tensor:
    """Encode (N, 16, 3) int32 pixel blocks to (N, 8) uint8 ETC1 blocks
    (EncodeEtc1Block, etc_compressor.cc:545-586), :data:`ENCODE_CHUNK`
    blocks at a time."""
    rgb = rgb.to(torch.int32)
    if rgb.shape[0] == 0:
        return torch.empty((0, 8), dtype=torch.uint8, device=rgb.device)
    return torch.cat([_encode_chunk(c, strategy)
                      for c in rgb.split(ENCODE_CHUNK)])


# ---------------------------------------------------------------------------
# High quality (quality="high")
# ---------------------------------------------------------------------------
#
# A candidate is a pair of quantized subblock bases (q1_555, q2_555,
# q1_444, q2_444), each a 3-list of (N,) int32. Per flip the search scores
# every candidate with _finish_flip in order, keeping the first of least
# error; then refits twice by least squares (refit 0 from the winner so
# far, refit 1 from refit 0's own words) and probes +-1 around refit 1's
# bases. The two flips' winners compete, ties to the left/right split. The
# candidates travel packed, one 32-bit word per subblock: q555 r, g, b at
# bits 0, 5, 10 and q444 r, g, b at bits 15, 19, 23.

#: 2 subblocks x 3 channels x (-1, +1) x (555, 444).
HQ_PROBES = 24
HQ_REFITS = 2


def pack_q_word(q555, q444) -> torch.Tensor:
    """One subblock's quantized bases -> its packed candidate word."""
    return (q555[0] | (q555[1] << 5) | (q555[2] << 10)
            | (q444[0] << 15) | (q444[1] << 19) | (q444[2] << 23))


def unpack_q_words(w1: torch.Tensor, w2: torch.Tensor):
    """Two packed subblock words -> (q1_555, q2_555, q1_444, q2_444)."""
    def f(w, s, n):
        return (w >> s) & ((1 << n) - 1)

    return ([f(w1, 0, 5), f(w1, 5, 5), f(w1, 10, 5)],
            [f(w2, 0, 5), f(w2, 5, 5), f(w2, 10, 5)],
            [f(w1, 15, 4), f(w1, 19, 4), f(w1, 23, 4)],
            [f(w2, 15, 4), f(w2, 19, 4), f(w2, 23, 4)])


def _modifiers(flip: bool, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(N, 16) int32: each pixel's codebook modifier in the block (hi, lo)."""
    device = hi.device
    cw1 = bits.get_bits(hi, 5, 3)
    cw2 = bits.get_bits(hi, 2, 3)
    p = torch.tensor(_P_ETC, dtype=torch.int32, device=device)
    idx = ((lo[:, None] >> p) & 1) | (((lo[:, None] >> (p + 16)) & 1) << 1)
    cw_px = torch.where(_subblock_mask(flip, device)[None, :], cw1[:, None],
                        cw2[:, None])
    return _codebook(device)[cw_px.long(), idx.long()]


def _refit_bases(rgb: torch.Tensor, flip: bool, hi: torch.Tensor,
                 lo: torch.Tensor):
    """Least-squares subblock bases for the modifiers of the block (hi, lo):
    per subblock and channel the mean of pixel - modifier, rounded (half
    to even), clamped and re-quantized. Returns a candidate."""
    m = _modifiers(flip, hi, lo)
    mask0 = _subblock_mask(flip, rgb.device).to(torch.int32)[None, :]
    q1_555, q2_555, q1_444, q2_444 = [], [], [], []
    for ch in range(3):
        resid = rgb[:, :, ch] - m
        b1, b2 = (torch.round((resid * mk).sum(dim=1, dtype=torch.int32)
                              .to(torch.float32) / 8.0)
                  .clamp(0, 255).to(torch.int32)
                  for mk in (mask0, 1 - mask0))
        q1_555.append(cc.quantize8(b1, 5))
        q2_555.append(cc.quantize8(b2, 5))
        q1_444.append(cc.quantize8(b1, 4))
        q2_444.append(cc.quantize8(b2, 4))
    return q1_555, q2_555, q1_444, q2_444


def _sum16_lanes(x: torch.Tensor) -> torch.Tensor:
    """Sum over a last dim of 16 as eight lanes x[k] + x[k + 8] folded in
    halves: the order in which texcomp's f32 reduction (XLA on the CPU, a
    fused row of 16) adds, which fixes the last bit when the sum passes
    2^24 in units of its least significant fraction."""
    v = x[..., :8] + x[..., 8:]
    v = v[..., :4] + v[..., 4:]
    v = v[..., :2] + v[..., 2:]
    return v[..., 0] + v[..., 1]


def _quantize_pair(b1: torch.Tensor, b2: torch.Tensor):
    """Real-valued (N, 3) bases -> a candidate (round half to even)."""
    r1 = [torch.round(b1[:, ch]).to(torch.int32) for ch in range(3)]
    r2 = [torch.round(b2[:, ch]).to(torch.int32) for ch in range(3)]
    return ([cc.quantize8(v, 5) for v in r1], [cc.quantize8(v, 5) for v in r2],
            [cc.quantize8(v, 4) for v in r1], [cc.quantize8(v, 4) for v in r2])


def _cluster_fit_bases(rgb: torch.Tensor, flip: bool, iters: int = 2,
                       extra_seeds=()):
    """Joint-assignment candidates: for each codeword, alternate the exact
    per-pixel modifier choice against real-valued bases (clamped squared
    error) and the least-squares refit mean(pixel - modifier), from each
    seed: the subblock means, a 2-means luminance split (midpoint of the
    two clusters' centroids, exact eighths) and ``extra_seeds``. Per seed
    the best and runner-up codeword pairs become candidates."""
    device = rgb.device
    mask0 = _subblock_mask(flip, device)
    m0 = mask0.to(torch.float32)[None, :, None]
    m1 = 1.0 - m0
    rgbf = rgb.to(torch.float32)
    cb = _codebook(device).to(torch.float32)
    mean1 = (rgbf * m0).sum(dim=1) / 8.0
    mean2 = (rgbf * m1).sum(dim=1) / 8.0
    lum3 = rgb.sum(dim=2, dtype=torch.int32)  # 3x luminance
    mask0i = mask0.to(torch.int32)[None, :]

    def split_seed(maski):
        slum = (lum3 * maski).sum(dim=1, keepdim=True, dtype=torch.int32)
        hi_m = ((8 * lum3 >= slum) & (maski == 1)).to(torch.int32)
        lo_m = maski - hi_m
        hi_n = hi_m.sum(dim=1, dtype=torch.int32).clamp(min=1)
        lo_n = lo_m.sum(dim=1, dtype=torch.int32).clamp(min=1)
        s_hi = (rgb * hi_m[:, :, None]).sum(dim=1, dtype=torch.int32)
        s_lo = (rgb * lo_m[:, :, None]).sum(dim=1, dtype=torch.int32)
        # (s_hi / hi_n + s_lo / lo_n) / 2 rounded half up to eighths.
        a = 8 * (s_hi * lo_n[:, None] + s_lo * hi_n[:, None])
        b = 2 * (hi_n * lo_n)[:, None]
        return torch.div(2 * a + b, 2 * b, rounding_mode="floor").to(
            torch.float32) / 8.0

    seeds = [(mean1, mean2), (split_seed(mask0i), split_seed(1 - mask0i)),
             *extra_seeds]

    def assign(b1, b2, mods):
        base = torch.where(m0 != 0, b1[:, None, :], b2[:, None, :])
        cand = (base[:, :, None, :] + mods[None, None, :, None]).clamp(0.0, 255.0)
        d = cand - rgbf[:, :, None, :]
        e = (d * d).sum(dim=-1)  # (N, 16, 4)
        return mods[_argmin_first(e, 2)], _sum16_lanes(e.amin(dim=2))

    def sel(cond, x, y):
        return torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - 1)), x, y)

    out = []
    for b1_0, b2_0 in seeds:
        best = second = None
        for cw in range(8):
            mods = cb[cw]
            b1, b2 = b1_0, b2_0
            for _ in range(iters):
                m, _ = assign(b1, b2, mods)
                resid = rgbf - m[:, :, None]
                b1 = ((resid * m0).sum(dim=1) / 8.0).clamp(0.0, 255.0)
                b2 = ((resid * m1).sum(dim=1) / 8.0).clamp(0.0, 255.0)
            _, e = assign(b1, b2, mods)
            if best is None:
                # The runner-up starts at +inf, so that it never copies the
                # winner.
                best = (e, b1, b2)
                second = (torch.full_like(e, float("inf")), b1, b2)
            else:
                better = e < best[0]
                mid = e < second[0]
                second = tuple(sel(better, bv, sel(mid, nv, sv))
                               for bv, nv, sv in zip(best, (e, b1, b2), second))
                best = tuple(sel(better, nv, bv)
                             for nv, bv in zip((e, b1, b2), best))
        out += [_quantize_pair(b1, b2) for _, b1, b2 in (best, second)]
    return out


@functools.lru_cache(maxsize=None)
def _enum_tables():
    """The exhaustive cluster fit's static tables: the 165 cuts
    0 <= p1 <= p2 <= p3 <= 8 of a subblock's 8 luminance-sorted pixels over
    the ascending modifiers [-b, -a, a, b], and per (cut, codeword) the
    modifier mean ``mu`` and the error constant (float32, numpy, as
    texcomp computes them)."""
    cb = np.asarray(ETC1_CODEBOOK)
    a_cw = cb[:, 0].astype(np.float32)
    b_cw = cb[:, 1].astype(np.float32)
    parts = np.array([(p1, p2, p3)
                      for p1 in range(9)
                      for p2 in range(p1, 9)
                      for p3 in range(p2, 9)], dtype=np.int64)
    n0 = parts[:, 0].astype(np.float32)
    n1 = (parts[:, 1] - parts[:, 0]).astype(np.float32)
    n2 = (parts[:, 2] - parts[:, 1]).astype(np.float32)
    n3 = 8.0 - parts[:, 2].astype(np.float32)
    sum_m = (-b_cw[None, :] * n0[:, None] - a_cw[None, :] * n1[:, None]
             + a_cw[None, :] * n2[:, None] + b_cw[None, :] * n3[:, None])
    sum_m2 = (a_cw[None, :] ** 2 * (n1 + n2)[:, None]
              + b_cw[None, :] ** 2 * (n0 + n3)[:, None])
    mu = sum_m / 8.0
    const = 3.0 * sum_m2 - 24.0 * mu * mu
    return (parts, mu.reshape(-1), const.reshape(-1), a_cw - b_cw,
            -2.0 * a_cw)


def _cluster_fit_enum_bases(rgb: torch.Tensor, flip: bool, top: int = 2):
    """Exhaustive cluster fit: for a fixed codeword the unclamped optimal
    assignment of a subblock's pixels to sorted modifiers is monotone in
    luminance, so the candidates are the 165 contiguous cuts of the
    luminance-sorted pixels x 8 codewords, each scored in closed form from
    prefix sums T of the sorted centred luminance. Per subblock the ``top``
    best give candidates; two more re-solve each subblock with the other's
    winner fixed and a quadratic penalty outside the 555 differential
    window. Returns (candidates, the real-valued winners)."""
    device = rgb.device
    parts, mu_np, const_np, coef13_np, coef2_np = _enum_tables()
    mu = torch.from_numpy(mu_np).to(device)
    const = torch.from_numpy(const_np).to(device)[None, :]
    coef13 = torch.from_numpy(coef13_np).to(device)
    coef2 = torch.from_numpy(coef2_np).to(device)
    p1, p2, p3 = (torch.from_numpy(parts[:, j]).to(device) for j in range(3))
    first = (_PY < 2) if flip else (_PX < 2)
    rgbf = rgb.to(torch.float32)

    def subblock(members):
        px = rgbf[:, torch.from_numpy(np.where(members)[0]).to(device), :]
        mean_ch = px.sum(dim=1) / 8.0
        t = (px - mean_ch[:, None, :]).sum(dim=2)  # centred luminance
        ts = torch.sort(t, dim=1).values
        cum = torch.cat([torch.zeros_like(ts[:, :1]), ts.cumsum(dim=1)], dim=1)
        g13 = cum[:, p1] + cum[:, p3]
        g2 = cum[:, p2]
        tm = g13[:, :, None] * coef13 + g2[:, :, None] * coef2  # (N, 165, 8)
        e0 = const - 2.0 * tm.reshape(tm.shape[0], -1)
        e = e0
        bases = []
        for _ in range(top):
            k = _argmin_first(e, 1)
            bases.append((mean_ch - mu[k][:, None]).clamp(0.0, 255.0))
            e = e.scatter(1, k[:, None], float("inf"))
        return bases, e0, mean_ch

    bases1, e1, mean1 = subblock(first)
    bases2, e2, mean2 = subblock(~first)
    out = [_quantize_pair(s1, s2) for s1, s2 in zip(bases1, bases2)]
    real = list(zip(bases1, bases2))

    # For a fixed assignment error(b) = error(b_opt) + 8 sum_ch (b - b_opt)^2,
    # so the penalised argmin is the optimum over contiguous cuts with the
    # base inside the window the other subblock's winner allows.
    def constrained(e, mean_ch, other_codes, lo_off, hi_off):
        pen = None
        windows = []
        for ch in range(3):
            lo_c = (other_codes[ch] + lo_off).clamp(0, 31)
            hi_c = (other_codes[ch] + hi_off).clamp(0, 31)
            lo_v = (lo_c * 8).to(torch.float32)[:, None]
            hi_v = (hi_c * 8 + 7).to(torch.float32)[:, None]
            b_opt = mean_ch[:, ch:ch + 1] - mu[None, :]
            d = (lo_v - b_opt).clamp(min=0.0) + (b_opt - hi_v).clamp(min=0.0)
            pen = d * d if pen is None else pen + d * d
            windows.append((lo_c, hi_c, lo_v[:, 0], hi_v[:, 0]))
        k = _argmin_first(e + 8.0 * pen, 1)
        q555, q444 = [], []
        for ch, (lo_c, hi_c, lo_v, hi_v) in enumerate(windows):
            b = torch.clamp(mean_ch[:, ch] - mu[k], lo_v, hi_v)
            r = torch.round(b).to(torch.int32)
            # Clamped after quantizing too, so the pair stays differential.
            q555.append(torch.clamp(cc.quantize8(r, 5), lo_c, hi_c))
            q444.append(cc.quantize8(r, 4))
        return q555, q444

    q1w_555, q2w_555, q1w_444, q2w_444 = out[0]
    q2c_555, q2c_444 = constrained(e2, mean2, q1w_555, -4, 3)
    out.append((q1w_555, q2c_555, q1w_444, q2c_444))
    q1c_555, q1c_444 = constrained(e1, mean1, q2w_555, -3, 4)
    out.append((q1c_555, q2w_555, q1c_444, q2w_444))
    return out, real


def _neighborhood_qs(q):
    """The +-1 probes of candidate ``q`` per (subblock, channel), in 555 and
    then 444, clamped: HQ_PROBES candidates in the order the search and
    the kernel walk them."""
    out = []
    for sb in (0, 1):
        for ch in range(3):
            for d in (-1, 1):
                p1, p2 = list(q[0]), list(q[1])
                (p1, p2)[sb][ch] = ((p1, p2)[sb][ch] + d).clamp(0, 31)
                out.append((p1, p2, q[2], q[3]))
                f1, f2 = list(q[2]), list(q[3])
                (f1, f2)[sb][ch] = ((f1, f2)[sb][ch] + d).clamp(0, 15)
                out.append((q[0], q[1], f1, f2))
    return out


def _diff_clamped(q1, q2):
    """The two 555-preserving moves: q2 clamped into q1's differential
    window, and q1 into q2's."""
    q2c = [torch.clamp(b, a - 4, a + 3) for a, b in zip(q1, q2)]
    q1c = [torch.clamp(a, b - 3, b + 4) for a, b in zip(q1, q2)]
    return q2c, q1c


def _hq_base_candidates(rgb: torch.Tensor, flip: bool):
    """The ordered candidates of one flip (order is the tie-break order):
    truncated and Blinn-rounded subblock averages, their clamped-delta
    variants and +-1 neighbourhood, the alternating cluster fit (seeds:
    means, luminance split, the exhaustive fit's winner), the exhaustive
    cluster fit and its clamped-delta variants."""
    mask0 = _subblock_mask(flip, rgb.device).to(torch.int32)[None, :]
    avg1 = [(rgb[:, :, ch] * mask0).sum(dim=1, dtype=torch.int32) >> 3
            for ch in range(3)]
    avg2 = [(rgb[:, :, ch] * (1 - mask0)).sum(dim=1, dtype=torch.int32) >> 3
            for ch in range(3)]
    q1r = ([cc.quantize8(a, 5) for a in avg1], [cc.quantize8(a, 4) for a in avg1])
    q2r = ([cc.quantize8(a, 5) for a in avg2], [cc.quantize8(a, 4) for a in avg2])
    qs = [([a >> 3 for a in avg1], [a >> 3 for a in avg2],
           [a >> 4 for a in avg1], [a >> 4 for a in avg2]),
          (q1r[0], q2r[0], q1r[1], q2r[1])]
    q2c, q1c = _diff_clamped(q1r[0], q2r[0])
    qs.append((q1r[0], q2c, q1r[1], q2r[1]))
    qs.append((q1c, q2r[0], q1r[1], q2r[1]))
    qs += _neighborhood_qs((q1r[0], q2r[0], q1r[1], q2r[1]))

    q_enum, real_enum = _cluster_fit_enum_bases(rgb, flip)
    qs += _cluster_fit_bases(rgb, flip, extra_seeds=real_enum[:1])
    qs += q_enum
    eq1, eq2, eq1_444, eq2_444 = q_enum[0]
    e2c, e1c = _diff_clamped(eq1, eq2)
    qs.append((eq1, e2c, eq1_444, eq2_444))
    qs.append((e1c, eq2, eq1_444, eq2_444))
    return qs


def hq_candidate_words(rgb: torch.Tensor, flip: bool) -> torch.Tensor:
    """(K, 2, N) int32: the flip's candidates packed, one word per
    subblock."""
    return torch.stack([torch.stack([pack_q_word(q[0], q[2]),
                                     pack_q_word(q[1], q[3])])
                        for q in _hq_base_candidates(rgb, flip)])


def hq_search(rgb: torch.Tensor, cands: torch.Tensor, flip: bool):
    """The HQ search of one flip over packed candidates ``cands`` (K, 2, N):
    returns (hi, lo, err) of the first candidate of least error among the
    K, the two chained refits and the HQ_PROBES probes around refit 1."""
    n = rgb.shape[0]
    state = (torch.zeros(n, dtype=torch.int32, device=rgb.device),
             torch.zeros(n, dtype=torch.int32, device=rgb.device),
             torch.full((n,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                        device=rgb.device))

    def consider(q, state):
        cand = _finish_flip(rgb, flip, SMALLER_ERROR, *q)
        better = cand[2] < state[2]
        return cand, tuple(torch.where(better, c, s) for c, s in zip(cand, state))

    for k in range(cands.shape[0]):
        _, state = consider(unpack_q_words(cands[k, 0], cands[k, 1]), state)
    cur = state
    for _ in range(HQ_REFITS):
        q = _refit_bases(rgb, flip, cur[0], cur[1])
        cur, state = consider(q, state)
    for probe in _neighborhood_qs(q):
        _, state = consider(probe, state)
    return state


def hq_pick_flip(lr, tb) -> torch.Tensor:
    """The two flips' winners (hi, lo, err) -> (N, 8) uint8: the top/bottom
    block where its error is less, else the left/right one (which wins
    ties)."""
    take_t = tb[2] < lr[2]
    return words_to_bytes(torch.where(take_t, tb[0], lr[0]),
                          torch.where(take_t, tb[1], lr[1]))


# ---------------------------------------------------------------------------
# Solid blocks
# ---------------------------------------------------------------------------


def solid_block_words(r, g, b):
    """CreateSolidBlock (etc_compressor.cc:595-617) as (hi, lo) words for
    int32 tensors of 8-bit channels: differential mode, the 555 color by
    truncation, zero delta, codeword 0, every pixel index 0. The
    reference's adjusted_color (:601-603) is unused: quantization reads the
    raw color at :608."""
    hi = 2 | ((r >> 3) << 27) | ((g >> 3) << 19) | ((b >> 3) << 11)
    return hi, torch.zeros_like(hi)


def create_solid_block_bytes(r: int, g: int, b: int) -> np.ndarray:
    """The 8 bytes of the solid ETC1 block of color (r, g, b)."""
    hi, lo = solid_block_words(*(torch.tensor([v], dtype=torch.int32)
                                 for v in (r, g, b)))
    return words_to_bytes(hi, lo)[0].numpy()
