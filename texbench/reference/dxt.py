"""DXT1 (BC1) and DXT5 (BC3) blocks (copied from
``texcomp_torch/codecs/dxt.py``; dxtc_compressor.cc). Blocks are whole
4x4 windows of the image (no padding, no swapped formats), every argmin
takes the first occurrence.

  DXT1 (8 bytes):  c0_lo c0_hi c1_lo c1_hi rows[0..3]
  DXT5 (16 bytes): alpha0 alpha1 alpha_codes[0..5] + the DXT1 block
"""

from __future__ import annotations

import numpy as np
import torch

from texbench.reference import util


def _quantize565(r, g, b):
    return util.quantize8(r, 5), util.quantize8(g, 6), util.quantize8(b, 5)


def _combine3(s0, s1, c0, c1):
    return tuple(util.combine_int(s0, s1, a, b) for a, b in zip(c0, c1))


def _first_index(values: torch.Tensor, extreme: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(values.shape[1], device=values.device)
    hit = values == extreme[:, None]
    return torch.where(hit, idx, values.shape[1]).amin(dim=1)


def _argmin_first(dist: torch.Tensor) -> torch.Tensor:
    """Strict-less scan over the last dim."""
    best = dist[..., 0]
    which = torch.zeros_like(best)
    for i in range(1, dist.shape[-1]):
        better = dist[..., i] < best
        which = torch.where(better, i, which)
        best = torch.where(better, dist[..., i], best)
    return which


def _best_const_colors(target, always_4_color: bool):
    """GetBestDxtcConstColors (dxtc_const_color_table.cc:322-392):
    (which, c0_16, c1_16) of a constant block of color ``target``."""
    tr, tg, tb = target
    table = torch.from_numpy(util.dxtc_const_color_table().astype(np.int32)
                             ).to(tr.device)

    def lut(ch, col):
        return table[ch.long(), col]

    single = _quantize565(tr, tg, tb)
    single_16 = util.pack565(*single)
    min_error = util.difference_luminance(target, util.extend565(*single))
    which = torch.zeros_like(tr)
    c0_16 = single_16
    c1_16 = single_16

    if not always_4_color:
        h0 = (lut(tr, 2), lut(tg, 6), lut(tb, 2))
        h1 = (lut(tr, 3), lut(tg, 7), lut(tb, 3))
        mid = _combine3(1, 1, util.extend565(*h0), util.extend565(*h1))
        err = util.difference_luminance(target, mid)
        upd = err < min_error
        h0_16, h1_16 = util.pack565(*h0), util.pack565(*h1)
        which = torch.where(upd, 2, which)
        c0_16 = torch.where(upd, torch.minimum(h0_16, h1_16), c0_16)
        c1_16 = torch.where(upd, torch.maximum(h0_16, h1_16), c1_16)
        min_error = torch.where(upd, err, min_error)

    t0 = (lut(tr, 0), lut(tg, 4), lut(tb, 0))
    t1 = (lut(tr, 1), lut(tg, 5), lut(tb, 1))
    third = _combine3(2, 1, util.extend565(*t0), util.extend565(*t1))
    err = util.difference_luminance(target, third)
    upd = err < min_error
    t0_16, t1_16 = util.pack565(*t0), util.pack565(*t1)
    gt = t0_16 > t1_16
    which = torch.where(upd, torch.where(gt, 2, 3), which)
    c0_16 = torch.where(upd, torch.where(gt, t0_16, t1_16), c0_16)
    c1_16 = torch.where(upd, torch.where(gt, t1_16, t0_16), c1_16)
    return which, c0_16, c1_16


def _pack_rows(codes: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(4, device=codes.device, dtype=codes.dtype) * 2
    return (codes.reshape(-1, 4, 4) << shifts).sum(dim=-1, dtype=torch.int32)


def _dxt1_words(rgb: torch.Tensor, always_4_color: bool):
    """EncodeDxt1Block (dxtc_compressor.cc:482-513): (N, 16, 3) int32 ->
    (c0_16, c1_16, rows)."""
    r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]
    lum = util.luminance(r, g, b)
    lo_i = _first_index(lum, lum.amin(dim=1))[:, None]
    hi_i = _first_index(lum, lum.amax(dim=1))[:, None]
    base_lo = tuple(torch.gather(ch, 1, lo_i)[:, 0] for ch in (r, g, b))
    base_hi = tuple(torch.gather(ch, 1, hi_i)[:, 0] for ch in (r, g, b))

    q_lo_16 = util.pack565(*_quantize565(*base_lo))
    q_hi_16 = util.pack565(*_quantize565(*base_hi))
    is_const = q_lo_16 == q_hi_16
    const_which, const_c0, const_c1 = _best_const_colors(base_lo,
                                                         always_4_color)
    const_row = const_which * 0x55

    swap = q_lo_16 < q_hi_16
    b0 = tuple(torch.where(swap, hc, lc) for lc, hc in zip(base_lo, base_hi))
    b1 = tuple(torch.where(swap, lc, hc) for lc, hc in zip(base_lo, base_hi))
    gen_c0 = torch.maximum(q_lo_16, q_hi_16)
    gen_c1 = torch.minimum(q_lo_16, q_hi_16)
    t2 = _combine3(2, 1, b0, b1)
    t3 = _combine3(1, 2, b0, b1)
    pal = torch.stack([util.luminance(*c) for c in (b0, b1, t2, t3)], dim=-1)
    d = pal[:, None, :] - lum[:, :, None]
    gen_rows = _pack_rows(_argmin_first(d * d))

    c0_16 = torch.where(is_const, const_c0, gen_c0)
    c1_16 = torch.where(is_const, const_c1, gen_c1)
    rows = torch.where(is_const[:, None], const_row[:, None], gen_rows)
    return c0_16, c1_16, rows


def _dxt1_bytes(c0_16, c1_16, rows) -> torch.Tensor:
    parts = [c0_16 & 0xFF, c0_16 >> 8, c1_16 & 0xFF, c1_16 >> 8]
    parts += [rows[:, i] for i in range(4)]
    return torch.stack(parts, dim=-1).to(torch.uint8)


def encode_dxt1_blocks(rgb: torch.Tensor) -> torch.Tensor:
    """(N, 16, 3) int32 -> (N, 8) uint8."""
    return _dxt1_bytes(*_dxt1_words(rgb, always_4_color=False))


def _decode_dxt1_channels(d: torch.Tensor, always_4_color: bool):
    c0_16 = d[:, 0] + d[:, 1] * 256
    c1_16 = d[:, 2] + d[:, 3] * 256
    p0 = util.extend565(*util.unpack565(c0_16))
    p1 = util.extend565(*util.unpack565(c1_16))
    equal = (c0_16 == c1_16)[:, None]
    four = torch.ones_like(equal) if always_4_color else (c0_16 > c1_16)[:, None]
    shifts = torch.arange(4, device=d.device, dtype=d.dtype) * 2
    codes = ((d[:, 4:8, None] >> shifts) & 3).reshape(-1, 16).long()
    out = []
    for ch0, ch1 in zip(p0, p1):
        ch0, ch1 = ch0[:, None], ch1[:, None]
        p2 = torch.where(equal, ch1, torch.where(
            four, util.combine_int(2, 1, ch0, ch1),
            util.combine_int(1, 1, ch0, ch1)))
        p3 = torch.where(equal, ch1, torch.where(
            four, util.combine_int(1, 2, ch0, ch1), torch.zeros_like(ch0)))
        out.append(torch.gather(torch.cat([ch0, ch1, p2, p3], dim=1), 1, codes))
    return torch.stack(out, dim=-1)


def decode_dxt1_blocks(data: torch.Tensor) -> torch.Tensor:
    """(N, 8) uint8 -> (N, 16, 3) int32."""
    return _decode_dxt1_channels(data.to(torch.int32), always_4_color=False)


def _base_alphas(a: torch.Tensor):
    """ComputeBaseAlphas (dxtc_compressor.cc:374-424) of whole blocks."""
    num_transparent = (a == 0).sum(dim=1)
    num_opaque = (a == 255).sum(dim=1)
    mid = (a > 0) & (a < 255)
    low = torch.where(mid, a, 255).amin(dim=1)
    high = torch.where(mid, a, 0).amax(dim=1)
    degenerate = low > high
    low = torch.where(degenerate, 0, low)
    high = torch.where(degenerate, 255, high)
    explicit = (num_transparent > 1) | (num_opaque > 1)
    low_adj = torch.where(num_transparent > 0, 0, low)
    high_adj = torch.where(num_opaque > 0, 255, high)
    return (torch.where(explicit, low, high_adj),
            torch.where(explicit, high, low_adj))


def _alpha_ramp(base0, base1):
    def comb(s0, s1):
        return util.combine_int(s0, s1, base0, base1)

    explicit = torch.stack(
        [base0, base1, comb(4, 1), comb(3, 2), comb(2, 3), comb(1, 4),
         torch.zeros_like(base0), torch.full_like(base0, 255)], dim=-1)
    interp = torch.stack(
        [base0, base1, comb(6, 1), comb(5, 2), comb(4, 3), comb(3, 4),
         comb(2, 5), comb(1, 6)], dim=-1)
    return torch.where((base0 <= base1)[:, None], explicit, interp)


def _pack_alpha_codes(codes: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(8, device=codes.device, dtype=codes.dtype) * 3
    half0 = (codes[:, :8] << shifts).sum(dim=1, dtype=torch.int32)
    half1 = (codes[:, 8:] << shifts).sum(dim=1, dtype=torch.int32)
    return torch.stack(
        [half0 & 0xFF, (half0 >> 8) & 0xFF, (half0 >> 16) & 0xFF,
         half1 & 0xFF, (half1 >> 8) & 0xFF, (half1 >> 16) & 0xFF], dim=-1)


def _unpack_alpha_codes(b: torch.Tensor) -> torch.Tensor:
    half0 = b[:, 0] + (b[:, 1] << 8) + (b[:, 2] << 16)
    half1 = b[:, 3] + (b[:, 4] << 8) + (b[:, 5] << 16)
    shifts = torch.arange(8, device=b.device, dtype=b.dtype) * 3
    return torch.cat([(half0[:, None] >> shifts) & 7,
                      (half1[:, None] >> shifts) & 7], dim=1)


def encode_dxt5_blocks(rgba: torch.Tensor) -> torch.Tensor:
    """(N, 16, 4) int32 -> (N, 16) uint8 (EncodeDxt5Block,
    dxtc_compressor.cc:516-528)."""
    a = rgba[:, :, 3]
    base0, base1 = _base_alphas(a)
    d = a[:, :, None] - _alpha_ramp(base0, base1)[:, None, :]
    alpha_bytes = _pack_alpha_codes(_argmin_first(d * d))
    color = _dxt1_bytes(*_dxt1_words(rgba[:, :, :3], always_4_color=True))
    head = torch.stack([base0, base1], dim=-1)
    return torch.cat([head, alpha_bytes, color.to(torch.int32)],
                     dim=-1).to(torch.uint8)


def decode_dxt5_blocks(data: torch.Tensor) -> torch.Tensor:
    """(N, 16) uint8 -> (N, 16, 4) int32."""
    d = data.to(torch.int32)
    ramp = _alpha_ramp(d[:, 0], d[:, 1])
    alpha = torch.gather(ramp, 1, _unpack_alpha_codes(d[:, 2:8]).long())
    rgb = _decode_dxt1_channels(d[:, 8:16], always_4_color=True)
    return torch.cat([rgb, alpha[:, :, None]], dim=-1)
