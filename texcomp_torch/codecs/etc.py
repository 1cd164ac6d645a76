"""ETC1 block codec in plain PyTorch, reference quality.

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
"""

from __future__ import annotations

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
# Solid blocks and pad functors
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


def replicate_edge(pixels: torch.Tensor, take: str) -> torch.Tensor:
    """(M, 16, C) blocks with the last column (``take="column"``) or the
    last row (``"row"``) copied across the block (etc_compressor.cc:
    645-691)."""
    grid = pixels.reshape(-1, 4, 4, pixels.shape[-1])
    if take == "column":
        grid = grid[:, :, 3:4].expand(-1, 4, 4, -1)
    else:
        grid = grid[:, 3:4].expand(-1, 4, 4, -1)
    return grid.reshape(-1, 16, pixels.shape[-1])


def _replicate_and_encode(data: np.ndarray, take: str,
                          strategy: int) -> np.ndarray:
    """Shared body of the column and row pad functors: decode, replicate
    the last column or row across the block, re-encode."""
    pixels = decode_etc1_blocks(torch.from_numpy(np.ascontiguousarray(data)))
    return encode_etc1_blocks(replicate_edge(pixels, take), strategy).numpy()


def etc_column_pad_blocks(data: np.ndarray, strategy: int) -> np.ndarray:
    """EtcGetColumnPadBlock over (M, 8) uint8 blocks."""
    return _replicate_and_encode(data, "column", strategy)


def etc_row_pad_blocks(data: np.ndarray, strategy: int) -> np.ndarray:
    """EtcGetRowPadBlock over (M, 8) uint8 blocks."""
    return _replicate_and_encode(data, "row", strategy)


def etc_corner_pad_blocks(data: np.ndarray) -> np.ndarray:
    """EtcGetCornerPadBlock (etc_compressor.cc:693-698): the solid block of
    each block's decoded corner pixel (3, 3)."""
    pixels = decode_etc1_blocks(torch.from_numpy(np.ascontiguousarray(data)))
    corner = pixels[:, 15]
    return words_to_bytes(*solid_block_words(
        corner[:, 0], corner[:, 1], corner[:, 2])).numpy()
