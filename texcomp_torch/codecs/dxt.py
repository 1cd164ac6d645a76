"""DXT1 (BC1) / DXT5 (BC3) block codecs in plain PyTorch.

The reference's per-block DXT codec (image_compression/internal/
dxtc_compressor.cc) over (N, 16, C) int32 tensors on any device. Every
argmin takes the first occurrence, as the reference's strictly-less update
scans do (dxtc_compressor.cc:293-307, :338-345, :467-474). This module is
the ground truth for the CUDA kernels in ``texcomp_torch/csrc/dxt.cu``.

Byte layouts (little-endian), per dxtc_compressor.cc:36-97:
  DXT1 (8 bytes):  c0_lo c0_hi c1_lo c1_hi bits[0..3]
  DXT5 (16 bytes): alpha0 alpha1 alpha_bits[0..5] + DXT1 block
"""

from __future__ import annotations

import numpy as np
import torch

from texcomp_torch.core import colors as cc
from texcomp_torch.core.constants import DXTC_CONST_COLOR_TABLE


def _pack565(r, g, b):
    return cc.to_uint16_565(r, g, b)


def _extend565(r5, g6, b5):
    return cc.extend565_r(r5), cc.extend565_g(g6), cc.extend565_b(b5)


def _quantize565(r, g, b):
    return cc.quantize8(r, 5), cc.quantize8(g, 6), cc.quantize8(b, 5)


def _combine3(s0, s1, c0, c1):
    """CombineRgbIntFast over channel tuples (color_util.h:315-321)."""
    return tuple(cc.combine_int_fast(s0, s1, a, b) for a, b in zip(c0, c1))


def _diff_luminance_err(c0, c1):
    return cc.compute_difference_luminance_fast(*c0, *c1)


def _first_index(values: torch.Tensor, extreme: torch.Tensor) -> torch.Tensor:
    """Index of the first entry along dim 1 equal to ``extreme`` (N,)."""
    idx = torch.arange(values.shape[1], device=values.device)
    hit = values == extreme[:, None]
    return torch.where(hit, idx, values.shape[1]).amin(dim=1)


def _argmin_first(dist: torch.Tensor) -> torch.Tensor:
    """Strict-less scan over the last dim: first index of the minimum."""
    best = dist[..., 0]
    which = torch.zeros_like(best)
    for i in range(1, dist.shape[-1]):
        better = dist[..., i] < best
        which = torch.where(better, i, which)
        best = torch.where(better, dist[..., i], best)
    return which


def _best_const_colors(target, always_4_color: bool):
    """GetBestDxtcConstColors (dxtc_const_color_table.cc:322-392).

    Args:
      target: tuple of (N,) int32 channels (r, g, b), values 0-255.
    Returns:
      (which (N,), c0_16 (N,), c1_16 (N,)): the 2-bit palette index to
      replicate and the packed 565 endpoints.
    """
    tr, tg, tb = target
    table = torch.from_numpy(DXTC_CONST_COLOR_TABLE.astype(np.int32)).to(tr.device)

    def lut(ch, col):
        return table[ch.long(), col]

    sr, sg, sb = _quantize565(tr, tg, tb)
    single_16 = _pack565(sr, sg, sb)
    min_error = _diff_luminance_err(target, _extend565(sr, sg, sb))
    which = torch.zeros_like(tr)
    c0_16 = single_16
    c1_16 = single_16

    if not always_4_color:
        # Halves (1/2-interpolation) candidate; preferred over thirds for
        # hardware consistency (dxtc_const_color_table.cc:345-347).
        h0 = (lut(tr, 2), lut(tg, 6), lut(tb, 2))
        h1 = (lut(tr, 3), lut(tg, 7), lut(tb, 3))
        mid = _combine3(1, 1, _extend565(*h0), _extend565(*h1))
        err = _diff_luminance_err(target, mid)
        upd = err < min_error
        h0_16 = _pack565(*h0)
        h1_16 = _pack565(*h1)
        # Halves mode requires c0 < c1 (3-color decode rule).
        which = torch.where(upd, 2, which)
        c0_16 = torch.where(upd, torch.minimum(h0_16, h1_16), c0_16)
        c1_16 = torch.where(upd, torch.maximum(h0_16, h1_16), c1_16)
        min_error = torch.where(upd, err, min_error)

    # Thirds (1/3-interpolation) candidate.
    t0 = (lut(tr, 0), lut(tg, 4), lut(tb, 0))
    t1 = (lut(tr, 1), lut(tg, 5), lut(tb, 1))
    third = _combine3(2, 1, _extend565(*t0), _extend565(*t1))
    err = _diff_luminance_err(target, third)
    upd = err < min_error
    t0_16 = _pack565(*t0)
    t1_16 = _pack565(*t1)
    # Thirds mode requires c0 > c1; if not, flip endpoints and use code 3
    # (the 2/3 point) instead of 2 (dxtc_const_color_table.cc:377-389).
    gt = t0_16 > t1_16
    which = torch.where(upd, torch.where(gt, 2, 3), which)
    c0_16 = torch.where(upd, torch.where(gt, t0_16, t1_16), c0_16)
    c1_16 = torch.where(upd, torch.where(gt, t1_16, t0_16), c1_16)
    return which, c0_16, c1_16


def _encode_dxt1_words(rgb: torch.Tensor, always_4_color: bool,
                       swap_red_and_blue: bool):
    """Core DXT1 encode: (N, 16, 3) int32 -> (c0_16, c1_16, rows).

    EncodeDxt1Block (dxtc_compressor.cc:482-513): min/max-luminance base
    colors -> 565 quantization -> constant-color table shortcut or
    4-palette nearest-index search.

    ``rgb`` must already be channel-swapped for BGR formats.
    ``swap_red_and_blue`` is still needed: ComputeConstantColorBits
    re-applies the swap to the already-swapped base color
    (dxtc_compressor.cc:360), so for swapped formats the constant-color
    search runs on the unswapped color. This replicates that double swap.

    Returns c0_16, c1_16 as (N,) int32 and rows as (N, 4) int32 bytes.
    """
    r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]

    # ComputeBaseColors (dxtc_compressor.cc:284-311): the pixels of min and
    # max luminance, first occurrence in scan order on ties.
    lum = cc.compute_luminance_fast(r, g, b)
    lo_i = _first_index(lum, lum.amin(dim=1))[:, None]
    hi_i = _first_index(lum, lum.amax(dim=1))[:, None]
    base_lo = tuple(torch.gather(ch, 1, lo_i)[:, 0] for ch in (r, g, b))
    base_hi = tuple(torch.gather(ch, 1, hi_i)[:, 0] for ch in (r, g, b))

    q_lo_16 = _pack565(*_quantize565(*base_lo))
    q_hi_16 = _pack565(*_quantize565(*base_hi))
    is_const = q_lo_16 == q_hi_16

    # Constant-color path (dxtc_compressor.cc:353-369) on base_colors[0],
    # double-swapped back to source order for swapped formats.
    const_target = base_lo[::-1] if swap_red_and_blue else base_lo
    const_which, const_c0, const_c1 = _best_const_colors(const_target,
                                                         always_4_color)
    const_row = const_which * 0x55  # the 2-bit code in all 4 columns

    # General path: order endpoints so c0_16 > c1_16
    # (dxtc_compressor.cc:503-507), then nearest of 4 by squared luminance
    # distance (ComputeColorBits, :315-349), with the unquantized base
    # colors as the palette.
    swap = q_lo_16 < q_hi_16
    b0 = tuple(torch.where(swap, hc, lc) for lc, hc in zip(base_lo, base_hi))
    b1 = tuple(torch.where(swap, lc, hc) for lc, hc in zip(base_lo, base_hi))
    gen_c0 = torch.maximum(q_lo_16, q_hi_16)
    gen_c1 = torch.minimum(q_lo_16, q_hi_16)
    t2 = _combine3(2, 1, b0, b1)
    t3 = _combine3(1, 2, b0, b1)
    pal_lum = torch.stack(
        [cc.compute_luminance_fast(*c) for c in (b0, b1, t2, t3)], dim=-1)
    d = pal_lum[:, None, :] - lum[:, :, None]  # (N, 16, 4)
    gen_rows = _pack_rows(_argmin_first(d * d))

    c0_16 = torch.where(is_const, const_c0, gen_c0)
    c1_16 = torch.where(is_const, const_c1, gen_c1)
    rows = torch.where(is_const[:, None], const_row[:, None], gen_rows)
    return c0_16, c1_16, rows


def _pack_rows(codes: torch.Tensor) -> torch.Tensor:
    """(N, 16) 2-bit pixel codes -> (N, 4) row bytes: bits for pixel
    (y, x) at bit 2x of byte y (dxtc_compressor.cc:330-347)."""
    shifts = torch.arange(4, device=codes.device, dtype=codes.dtype) * 2
    return (codes.reshape(-1, 4, 4) << shifts).sum(dim=-1, dtype=torch.int32)


def _dxt1_bytes(c0_16, c1_16, rows) -> torch.Tensor:
    """Assemble the (N, 8) uint8 little-endian DXT1 payload."""
    parts = [c0_16 & 0xFF, c0_16 >> 8, c1_16 & 0xFF, c1_16 >> 8]
    parts += [rows[:, i] for i in range(4)]
    return torch.stack(parts, dim=-1).to(torch.uint8)


def encode_dxt1_blocks(rgb: torch.Tensor, always_4_color: bool = False,
                       swap_red_and_blue: bool = False) -> torch.Tensor:
    """Encode (N, 16, 3) int32 pixel blocks to (N, 8) uint8 DXT1 blocks.

    ``rgb`` must be pre-swapped for BGR input; see _encode_dxt1_words.
    """
    return _dxt1_bytes(*_encode_dxt1_words(rgb, always_4_color,
                                           swap_red_and_blue))


def _decode_dxt1_channels(d: torch.Tensor, always_4_color: bool):
    """(N, >=8) int32 byte view -> palette-decoded (N, 16, 3) int32.

    DecodeColors + DecodeDxt1Block (dxtc_compressor.cc:167-237).
    """
    c0_16 = d[:, 0] + d[:, 1] * 256
    c1_16 = d[:, 2] + d[:, 3] * 256
    p0 = _extend565(*cc.from_uint16_565(c0_16))
    p1 = _extend565(*cc.from_uint16_565(c1_16))

    equal = (c0_16 == c1_16)[:, None]
    four = torch.ones_like(equal) if always_4_color else (c0_16 > c1_16)[:, None]

    # Pixel (y, x) code = bits (2x, 2x+1) of byte 4+y
    # (dxtc_compressor.cc:230-236).
    shifts = torch.arange(4, device=d.device, dtype=d.dtype) * 2
    codes = ((d[:, 4:8, None] >> shifts) & 3).reshape(-1, 16).long()

    out = []
    for ch0, ch1 in zip(p0, p1):
        # CombineUint8Fast on 0-255 values (color_util.h:290-301).
        ch0, ch1 = ch0[:, None], ch1[:, None]
        p2 = torch.where(equal, ch1, torch.where(
            four, cc.combine_int_fast(2, 1, ch0, ch1),
            cc.combine_int_fast(1, 1, ch0, ch1)))
        p3 = torch.where(equal, ch1, torch.where(
            four, cc.combine_int_fast(1, 2, ch0, ch1), torch.zeros_like(ch0)))
        palette = torch.cat([ch0, ch1, p2, p3], dim=1)  # (N, 4)
        out.append(torch.gather(palette, 1, codes))
    return torch.stack(out, dim=-1)  # (N, 16, 3)


def decode_dxt1_blocks(data: torch.Tensor,
                       always_4_color: bool = False) -> torch.Tensor:
    """Decode (N, 8) uint8 DXT1 blocks to (N, 16, 3) int32 pixels."""
    return _decode_dxt1_channels(data.to(torch.int32), always_4_color)


# ---------------------------------------------------------------------------
# DXT5
# ---------------------------------------------------------------------------


def _compute_base_alphas(a: torch.Tensor, full_outside: torch.Tensor):
    """ComputeBaseAlphas (dxtc_compressor.cc:374-424).

    Args:
      a: (N, 16) int32 alpha values.
      full_outside: (N,) bool has_one_pixel flags.
    Returns:
      (base0, base1) each (N,) int32.
    """
    num_transparent = (a == 0).sum(dim=1)
    num_opaque = (a == 255).sum(dim=1)
    mid = (a > 0) & (a < 255)
    low = torch.where(mid, a, 255).amin(dim=1)
    high = torch.where(mid, a, 0).amax(dim=1)
    degenerate = low > high  # all values were 0 or 255
    low = torch.where(degenerate, 0, low)
    high = torch.where(degenerate, 255, high)

    explicit = (num_transparent > 1) | (num_opaque > 1)
    low_adj = torch.where(num_transparent > 0, 0, low)
    high_adj = torch.where(num_opaque > 0, 255, high)
    base0 = torch.where(explicit, low, high_adj)
    base1 = torch.where(explicit, high, low_adj)

    a00 = a[:, 0]
    base0 = torch.where(full_outside, a00, base0)
    base1 = torch.where(full_outside, a00, base1)
    return base0, base1


def _alpha_ramp(base0, base1):
    """The 8 alphas of the ramp (dxtc_compressor.cc:436-456, :195-217):
    the explicit-0/255 scheme where base0 <= base1, else the 6-interpolant
    scheme (the same rule for encode and decode). Returns (N, 8) int32."""
    def comb(s0, s1):
        return cc.combine_int_fast(s0, s1, base0, base1)

    explicit = torch.stack(
        [base0, base1, comb(4, 1), comb(3, 2), comb(2, 3), comb(1, 4),
         torch.zeros_like(base0), torch.full_like(base0, 255)], dim=-1)
    interp = torch.stack(
        [base0, base1, comb(6, 1), comb(5, 2), comb(4, 3), comb(3, 4),
         comb(2, 5), comb(1, 6)], dim=-1)
    return torch.where((base0 <= base1)[:, None], explicit, interp)


def _pack_alpha_codes(codes: torch.Tensor) -> torch.Tensor:
    """(N, 16) 3-bit codes -> (N, 6) int32 bytes; pixel n at bits
    [3n, 3n+3) of the little-endian 48-bit field
    (dxtc_compressor.cc:103-158)."""
    shifts = torch.arange(8, device=codes.device, dtype=codes.dtype) * 3
    half0 = (codes[:, :8] << shifts).sum(dim=1, dtype=torch.int32)  # 24 bits
    half1 = (codes[:, 8:] << shifts).sum(dim=1, dtype=torch.int32)
    return torch.stack(
        [half0 & 0xFF, (half0 >> 8) & 0xFF, (half0 >> 16) & 0xFF,
         half1 & 0xFF, (half1 >> 8) & 0xFF, (half1 >> 16) & 0xFF], dim=-1)


def _unpack_alpha_codes(b: torch.Tensor) -> torch.Tensor:
    """(N, 6) int32 bytes -> (N, 16) 3-bit codes."""
    half0 = b[:, 0] + (b[:, 1] << 8) + (b[:, 2] << 16)
    half1 = b[:, 3] + (b[:, 4] << 8) + (b[:, 5] << 16)
    shifts = torch.arange(8, device=b.device, dtype=b.dtype) * 3
    return torch.cat([(half0[:, None] >> shifts) & 7,
                      (half1[:, None] >> shifts) & 7], dim=1)


def encode_dxt5_blocks(rgba: torch.Tensor, full_outside: torch.Tensor,
                       swap_red_and_blue: bool = False) -> torch.Tensor:
    """Encode (N, 16, 4) int32 pixel blocks to (N, 16) uint8 DXT5 blocks.

    EncodeDxt5Block (dxtc_compressor.cc:516-528): base alphas, nearest of
    8 alpha codes, and a DXT1 color block with the always-4-color rule.

    Args:
      rgba: pixel blocks (channels already swapped for BGRA input).
      full_outside: (N,) bool has_one_pixel flags (pixel4x4.cc:56-58); they
        force the trivial alpha encoding (dxtc_compressor.cc:376-379,
        :430-434).
    """
    a = rgba[:, :, 3]
    base0, base1 = _compute_base_alphas(a, full_outside)
    ramp = _alpha_ramp(base0, base1)  # (N, 8)
    d = a[:, :, None] - ramp[:, None, :]
    which = torch.where(full_outside[:, None], 0, _argmin_first(d * d))
    alpha_bytes = _pack_alpha_codes(which)

    c0_16, c1_16, rows = _encode_dxt1_words(
        rgba[:, :, :3], always_4_color=True,
        swap_red_and_blue=swap_red_and_blue)
    dxt1 = _dxt1_bytes(c0_16, c1_16, rows).to(torch.int32)
    head = torch.stack([base0, base1], dim=-1)
    return torch.cat([head, alpha_bytes, dxt1], dim=-1).to(torch.uint8)


def decode_dxt5_blocks(data: torch.Tensor) -> torch.Tensor:
    """Decode (N, 16) uint8 DXT5 blocks to (N, 16, 4) int32 pixels.

    DecodeDxt5Block (dxtc_compressor.cc:240-267): colors decode with the
    always-4-color rule; alphas per DecodeAlphaValues (:195-217), where
    alpha0 > alpha1 selects the 6-interpolant scheme.
    """
    d = data.to(torch.int32)
    a0, a1 = d[:, 0], d[:, 1]
    ramp = _alpha_ramp(a0, a1)
    codes = _unpack_alpha_codes(d[:, 2:8]).long()
    alpha = torch.gather(ramp, 1, codes)  # (N, 16)
    rgb = _decode_dxt1_channels(d[:, 8:16], always_4_color=True)
    return torch.cat([rgb, alpha[:, :, None]], dim=-1)


# ---------------------------------------------------------------------------
# Pad functors on packed blocks (host-side numpy; they are byte shuffles).
# ---------------------------------------------------------------------------


def _copy_column3_color_bits(row_bits: np.ndarray) -> np.ndarray:
    """Replicate the column-3 2-bit code across a row byte
    (dxtc_compressor.cc:548-554)."""
    return ((row_bits >> 6) & 3) * 0x55


def dxt1_column_pad_blocks(blocks: np.ndarray) -> np.ndarray:
    """DxtcGetColumnPadBlock (dxtc_compressor.cc:598-608) over (M, 8) uint8."""
    out = blocks.copy()
    out[:, 4:8] = _copy_column3_color_bits(blocks[:, 4:8])
    return out


def dxt1_row_pad_blocks(blocks: np.ndarray) -> np.ndarray:
    """DxtcGetRowPadBlock (dxtc_compressor.cc:634-644)."""
    out = blocks.copy()
    out[:, 4:8] = blocks[:, 7:8]
    return out


def dxt1_corner_pad_blocks(blocks: np.ndarray) -> np.ndarray:
    """DxtcGetCornerPadBlock (dxtc_compressor.cc:669-679)."""
    out = blocks.copy()
    out[:, 4:8] = _copy_column3_color_bits(blocks[:, 7:8])
    return out


def _alpha_codes_np(alpha_bytes: np.ndarray) -> np.ndarray:
    """(M, 6) uint8 -> (M, 16) int codes."""
    b = alpha_bytes.astype(np.int64)
    half0 = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    half1 = b[:, 3] | (b[:, 4] << 8) | (b[:, 5] << 16)
    shifts = np.arange(8) * 3
    return np.concatenate(
        [(half0[:, None] >> shifts) & 7, (half1[:, None] >> shifts) & 7], axis=1)


def _alpha_bytes_np(codes: np.ndarray) -> np.ndarray:
    shifts = np.arange(8) * 3
    half0 = np.sum(codes[:, :8].astype(np.int64) << shifts, axis=1)
    half1 = np.sum(codes[:, 8:].astype(np.int64) << shifts, axis=1)
    return np.stack(
        [half0 & 0xFF, (half0 >> 8) & 0xFF, (half0 >> 16) & 0xFF,
         half1 & 0xFF, (half1 >> 8) & 0xFF, (half1 >> 16) & 0xFF],
        axis=-1,
    ).astype(np.uint8)


def dxt5_column_pad_blocks(blocks: np.ndarray) -> np.ndarray:
    """DxtcGetColumnPadBlock<Dxt5Block> (dxtc_compressor.cc:610-628)."""
    out = blocks.copy()
    codes = _alpha_codes_np(blocks[:, 2:8]).reshape(-1, 4, 4)
    codes[:, :, 0:3] = codes[:, :, 3:4]
    out[:, 2:8] = _alpha_bytes_np(codes.reshape(-1, 16))
    out[:, 8:16] = dxt1_column_pad_blocks(blocks[:, 8:16])
    return out


def dxt5_row_pad_blocks(blocks: np.ndarray) -> np.ndarray:
    """DxtcGetRowPadBlock<Dxt5Block> (dxtc_compressor.cc:646-663)."""
    out = blocks.copy()
    codes = _alpha_codes_np(blocks[:, 2:8]).reshape(-1, 4, 4)
    codes[:, 0:3, :] = codes[:, 3:4, :]
    out[:, 2:8] = _alpha_bytes_np(codes.reshape(-1, 16))
    out[:, 8:16] = dxt1_row_pad_blocks(blocks[:, 8:16])
    return out


def dxt5_corner_pad_blocks(blocks: np.ndarray) -> np.ndarray:
    """DxtcGetCornerPadBlock<Dxt5Block> (dxtc_compressor.cc:681-696)."""
    out = blocks.copy()
    codes = _alpha_codes_np(blocks[:, 2:8])
    codes[:, :] = codes[:, 15:16]
    out[:, 2:8] = _alpha_bytes_np(codes)
    out[:, 8:16] = dxt1_corner_pad_blocks(blocks[:, 8:16])
    return out
