"""ETC1 blocks: decode, the reference encode in its four strategies and
the HQ encode (copied from ``texcomp_torch/codecs/etc.py``;
etc_compressor.cc). A block is two int32 words (hi, lo) holding the 64-bit
pattern; bytes are big-endian hi then big-endian lo.

The HQ encoder's candidate fit is float32 in the port. ``fdt`` sets the
float type of that fit here, so that the benchmark's control can run the
same encoder one precision lower (bfloat16).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from texbench.reference import util

SPLIT_HORIZONTALLY, SPLIT_VERTICALLY, SMALLER_ERROR, HEURISTIC = 0, 1, 2, 3

#: Blocks a step of the encode search holds.
ENCODE_CHUNK = 1 << 16

_P_ETC = [(p % 4) * 4 + p // 4 for p in range(16)]
_PX = np.array([p % 4 for p in range(16)])
_PY = np.array([p // 4 for p in range(16)])

#: 2 subblocks x 3 channels x (-1, +1) x (555, 444).
HQ_PROBES = 24
HQ_REFITS = 2


def _codebook(device) -> torch.Tensor:
    return torch.from_numpy(util.ETC1_CODEBOOK).to(device)


def words_to_bytes(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    parts = [(w >> s) & 0xFF for w in (hi, lo) for s in (24, 16, 8, 0)]
    return torch.stack(parts, dim=-1).to(torch.uint8)


def bytes_to_words(data: torch.Tensor):
    d = data.to(torch.int32)
    hi = (d[:, 0] << 24) | (d[:, 1] << 16) | (d[:, 2] << 8) | d[:, 3]
    lo = (d[:, 4] << 24) | (d[:, 5] << 16) | (d[:, 6] << 8) | d[:, 7]
    return hi, lo


def _subblock_mask(flip: bool, device) -> torch.Tensor:
    return torch.from_numpy((_PY < 2) if flip else (_PX < 2)).to(device)


def decode_etc1_blocks(data: torch.Tensor) -> torch.Tensor:
    """(N, 8) uint8 -> (N, 16, 3) int32 (etc_compressor.cc:227-289)."""
    hi, lo = bytes_to_words(data)
    device = data.device
    flip = util.get_bits(hi, 0, 1) == 1
    cw0 = util.get_bits(hi, 5, 3)
    cw1 = util.get_bits(hi, 2, 3)
    diff = util.get_bits(hi, 1, 1) == 1
    b5 = [util.get_bits(hi, s, 5) for s in (27, 19, 11)]
    d3 = [util.extend_sign_bit(util.get_bits(hi, s, 3), 3) for s in (24, 16, 8)]
    c1_ind = [util.extend_4bit(util.get_bits(hi, s, 4)) for s in (28, 20, 12)]
    c2_ind = [util.extend_4bit(util.get_bits(hi, s, 4)) for s in (24, 16, 8)]
    c1 = [torch.where(diff, util.extend_5bit(v), i) for v, i in zip(b5, c1_ind)]
    c2 = [torch.where(diff, util.extend_5bit(v + d), i)
          for v, d, i in zip(b5, d3, c2_ind)]
    p = torch.tensor(_P_ETC, dtype=torch.int32, device=device)
    idx = ((lo[:, None] >> p) & 1) | (((lo[:, None] >> (p + 16)) & 1) << 1)
    top = torch.from_numpy(_PY < 2).to(device)
    left = torch.from_numpy(_PX < 2).to(device)
    is_first = torch.where(flip[:, None], top, left)
    cw = torch.where(is_first, cw0[:, None], cw1[:, None])
    modifier = _codebook(device)[cw.long(), idx.long()]
    out = [util.clamp8(torch.where(is_first, a[:, None], b[:, None]) + modifier)
           for a, b in zip(c1, c2)]
    return torch.stack(out, dim=-1)


def _argmin_first(values: torch.Tensor, dim: int) -> torch.Tensor:
    best = values.amin(dim=dim, keepdim=True)
    n = values.shape[dim]
    shape = [1] * values.dim()
    shape[dim] = n
    idx = torch.arange(n, device=values.device).reshape(shape)
    return torch.where(values == best, idx, n).amin(dim=dim)


def _finish_flip(rgb: torch.Tensor, flip: bool, strategy: int,
                 q1_555, q2_555, q1_444, q2_444):
    """Mode decision, codeword and pixel-index search and packing for the
    given quantized bases (etc_compressor.cc:480-542): (hi, lo, error)."""
    device = rgb.device
    mask0 = _subblock_mask(flip, device)
    mask0i = mask0.to(torch.int32)[None, :]
    d555 = [b - a for a, b in zip(q1_555, q2_555)]
    use_diff = torch.ones_like(d555[0], dtype=torch.bool)
    for d in d555:
        use_diff &= (d >= -4) & (d <= 3)
    dec1 = [torch.where(use_diff, util.extend_5bit(q5), util.extend_4bit(q4))
            for q5, q4 in zip(q1_555, q1_444)]
    dec2 = [torch.where(use_diff, util.extend_5bit(q5), util.extend_4bit(q4))
            for q5, q4 in zip(q2_555, q2_444)]

    cb = _codebook(device)[None, None]
    err = None
    for ch in range(3):
        base = torch.where(mask0[None, :], dec1[ch][:, None], dec2[ch][:, None])
        cand = util.clamp8(base[:, :, None, None] + cb)
        d = cand - rgb[:, :, ch, None, None]
        err = d * d if err is None else err + d * d
    best_mod = _argmin_first(err, 3)
    best_err = err.amin(dim=3)
    del err
    err_sb1 = (best_err * mask0i[:, :, None]).sum(dim=1, dtype=torch.int32)
    err_sb2 = (best_err * (1 - mask0i)[:, :, None]).sum(dim=1,
                                                        dtype=torch.int32)
    if strategy == HEURISTIC:
        th = torch.from_numpy(util.ETC1_HEURISTIC_THRESHOLDS).to(device)

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
        cw1 = _argmin_first(err_sb1, 1)
        cw2 = _argmin_first(err_sb2, 1)
        e1 = err_sb1.amin(dim=1)
        e2 = err_sb2.amin(dim=1)

    cw_px = torch.where(mask0[None, :], cw1[:, None], cw2[:, None])
    mod = torch.gather(best_mod, 2, cw_px[:, :, None])[:, :, 0].to(torch.int32)
    p = torch.tensor(_P_ETC, dtype=torch.int32, device=device)
    lo = (((mod & 1) << p) | ((mod >> 1) << (p + 16))).sum(dim=1,
                                                          dtype=torch.int32)
    hi = torch.full_like(lo, 1 if flip else 0)
    hi = hi | (use_diff.to(torch.int32) << 1)
    for ch, (s1, s2, t1) in enumerate(((27, 24, 28), (19, 16, 20),
                                       (11, 8, 12))):
        diff_bits = util.set_bits(torch.zeros_like(hi), s1, 5, q1_555[ch])
        diff_bits = util.set_bits(diff_bits, s2, 3, d555[ch])
        ind_bits = util.set_bits(torch.zeros_like(hi), t1, 4, q1_444[ch])
        ind_bits = util.set_bits(ind_bits, s2, 4, q2_444[ch])
        hi = hi | torch.where(use_diff, diff_bits, ind_bits)
    hi = util.set_bits(hi, 5, 3, cw1)
    hi = util.set_bits(hi, 2, 3, cw2)
    return hi, lo, e1 + e2


def _averages(rgb: torch.Tensor, flip: bool):
    mask0 = _subblock_mask(flip, rgb.device).to(torch.int32)[None, :]
    avg1 = [(rgb[:, :, ch] * mask0).sum(dim=1, dtype=torch.int32) >> 3
            for ch in range(3)]
    avg2 = [(rgb[:, :, ch] * (1 - mask0)).sum(dim=1, dtype=torch.int32) >> 3
            for ch in range(3)]
    return avg1, avg2


def _encode_one_flip(rgb: torch.Tensor, flip: bool, strategy: int):
    avg1, avg2 = _averages(rgb, flip)
    return _finish_flip(rgb, flip, strategy,
                        [a >> 3 for a in avg1], [a >> 3 for a in avg2],
                        [a >> 4 for a in avg1], [a >> 4 for a in avg2])


def _heuristic_flip(rgb: torch.Tensor) -> torch.Tensor:
    """kHeuristic's flip (etc_compressor.cc:553-574); sum4 counts (2, 2)
    twice and omits (3, 3), as the reference does."""
    def quad(ps):
        return [sum(rgb[:, 4 * y + x, ch] for y, x in ps) for ch in range(3)]

    sum1 = quad([(0, 0), (0, 1), (1, 0), (1, 1)])
    sum2 = quad([(2, 0), (2, 1), (3, 0), (3, 1)])
    sum3 = quad([(0, 2), (0, 3), (1, 2), (1, 3)])
    sum4 = quad([(2, 2), (2, 3), (3, 2), (2, 2)])

    def avg(a, b):
        return [(x + y) >> 3 for x, y in zip(a, b)]

    def err3(a, b):
        return sum((x - y) * (x - y) for x, y in zip(a, b))

    return ~(err3(avg(sum1, sum2), avg(sum3, sum4))
             > err3(avg(sum1, sum3), avg(sum2, sum4)))


def _encode_chunk(rgb: torch.Tensor, strategy: int) -> torch.Tensor:
    if strategy in (SPLIT_HORIZONTALLY, SPLIT_VERTICALLY):
        hi, lo, _ = _encode_one_flip(rgb, strategy == SPLIT_HORIZONTALLY,
                                     strategy)
    elif strategy == HEURISTIC:
        hi_f, lo_f, _ = _encode_one_flip(rgb, False, strategy)
        hi_t, lo_t, _ = _encode_one_flip(rgb, True, strategy)
        flip = _heuristic_flip(rgb)
        hi = torch.where(flip, hi_t, hi_f)
        lo = torch.where(flip, lo_t, lo_f)
    elif strategy == SMALLER_ERROR:
        hi_f, lo_f, err_f = _encode_one_flip(rgb, False, strategy)
        hi_t, lo_t, err_t = _encode_one_flip(rgb, True, strategy)
        take_lr = err_f <= err_t  # left/right wins ties (:583)
        hi = torch.where(take_lr, hi_f, hi_t)
        lo = torch.where(take_lr, lo_f, lo_t)
    else:
        raise ValueError(f"unknown ETC1 strategy {strategy!r}")
    return words_to_bytes(hi, lo)


def encode_etc1_blocks(rgb: torch.Tensor,
                       strategy: int = SMALLER_ERROR) -> torch.Tensor:
    """(N, 16, 3) int -> (N, 8) uint8 (EncodeEtc1Block,
    etc_compressor.cc:545-586)."""
    rgb = rgb.to(torch.int32)
    return torch.cat([_encode_chunk(c, strategy)
                      for c in rgb.split(ENCODE_CHUNK)])


# ---------------------------------------------------------------------------
# quality="high": some 40 candidate base pairs per flip, scored in order by
# the exhaustive codeword search (first of least error), two chained
# least-squares refits and HQ_PROBES +-1 probes around the second; the two
# flips' winners compete, ties to the left/right split.
# ---------------------------------------------------------------------------


def _pack_q_word(q555, q444) -> torch.Tensor:
    return (q555[0] | (q555[1] << 5) | (q555[2] << 10)
            | (q444[0] << 15) | (q444[1] << 19) | (q444[2] << 23))


def _unpack_q_words(w1: torch.Tensor, w2: torch.Tensor):
    def f(w, s, n):
        return (w >> s) & ((1 << n) - 1)

    return ([f(w1, 0, 5), f(w1, 5, 5), f(w1, 10, 5)],
            [f(w2, 0, 5), f(w2, 5, 5), f(w2, 10, 5)],
            [f(w1, 15, 4), f(w1, 19, 4), f(w1, 23, 4)],
            [f(w2, 15, 4), f(w2, 19, 4), f(w2, 23, 4)])


def _modifiers(flip: bool, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    device = hi.device
    cw1 = util.get_bits(hi, 5, 3)
    cw2 = util.get_bits(hi, 2, 3)
    p = torch.tensor(_P_ETC, dtype=torch.int32, device=device)
    idx = ((lo[:, None] >> p) & 1) | (((lo[:, None] >> (p + 16)) & 1) << 1)
    cw_px = torch.where(_subblock_mask(flip, device)[None, :], cw1[:, None],
                        cw2[:, None])
    return _codebook(device)[cw_px.long(), idx.long()]


def _refit_bases(rgb, flip, hi, lo, fdt):
    """Least-squares bases for the block's modifiers: per subblock and
    channel the mean of pixel - modifier, rounded half to even."""
    m = _modifiers(flip, hi, lo)
    mask0 = _subblock_mask(flip, rgb.device).to(torch.int32)[None, :]
    q1_555, q2_555, q1_444, q2_444 = [], [], [], []
    for ch in range(3):
        resid = rgb[:, :, ch] - m
        b1, b2 = (torch.round((resid * mk).sum(dim=1, dtype=torch.int32)
                              .to(fdt) / 8.0).clamp(0, 255).to(torch.int32)
                  for mk in (mask0, 1 - mask0))
        q1_555.append(util.quantize8(b1, 5))
        q2_555.append(util.quantize8(b2, 5))
        q1_444.append(util.quantize8(b1, 4))
        q2_444.append(util.quantize8(b2, 4))
    return q1_555, q2_555, q1_444, q2_444


def _sum16_lanes(x: torch.Tensor) -> torch.Tensor:
    """Sum over a last dim of 16, folded in halves (texcomp's f32 order)."""
    v = x[..., :8] + x[..., 8:]
    v = v[..., :4] + v[..., 4:]
    v = v[..., :2] + v[..., 2:]
    return v[..., 0] + v[..., 1]


def _quantize_pair(b1: torch.Tensor, b2: torch.Tensor):
    r1 = [torch.round(b1[:, ch]).to(torch.int32) for ch in range(3)]
    r2 = [torch.round(b2[:, ch]).to(torch.int32) for ch in range(3)]
    return ([util.quantize8(v, 5) for v in r1], [util.quantize8(v, 5) for v in r2],
            [util.quantize8(v, 4) for v in r1], [util.quantize8(v, 4) for v in r2])


def _cluster_fit_bases(rgb, flip, fdt, extra_seeds=(), iters: int = 2):
    """Alternating cluster fit per codeword from each seed (subblock means,
    a 2-means luminance split, ``extra_seeds``): the best and runner-up
    codeword pairs of each seed."""
    device = rgb.device
    mask0 = _subblock_mask(flip, device)
    m0 = mask0.to(fdt)[None, :, None]
    m1 = 1.0 - m0
    rgbf = rgb.to(fdt)
    cb = _codebook(device).to(fdt)
    mean1 = (rgbf * m0).sum(dim=1) / 8.0
    mean2 = (rgbf * m1).sum(dim=1) / 8.0
    lum3 = rgb.sum(dim=2, dtype=torch.int32)
    mask0i = mask0.to(torch.int32)[None, :]

    def split_seed(maski):
        slum = (lum3 * maski).sum(dim=1, keepdim=True, dtype=torch.int32)
        hi_m = ((8 * lum3 >= slum) & (maski == 1)).to(torch.int32)
        lo_m = maski - hi_m
        hi_n = hi_m.sum(dim=1, dtype=torch.int32).clamp(min=1)
        lo_n = lo_m.sum(dim=1, dtype=torch.int32).clamp(min=1)
        s_hi = (rgb * hi_m[:, :, None]).sum(dim=1, dtype=torch.int32)
        s_lo = (rgb * lo_m[:, :, None]).sum(dim=1, dtype=torch.int32)
        a = 8 * (s_hi * lo_n[:, None] + s_lo * hi_n[:, None])
        b = 2 * (hi_n * lo_n)[:, None]
        return torch.div(2 * a + b, 2 * b, rounding_mode="floor").to(fdt) / 8.0

    seeds = [(mean1, mean2), (split_seed(mask0i), split_seed(1 - mask0i)),
             *extra_seeds]

    def assign(b1, b2, mods):
        base = torch.where(m0 != 0, b1[:, None, :], b2[:, None, :])
        cand = (base[:, :, None, :] + mods[None, None, :, None]).clamp(0.0, 255.0)
        d = cand - rgbf[:, :, None, :]
        e = (d * d).sum(dim=-1)
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
    """The 165 cuts 0 <= p1 <= p2 <= p3 <= 8 of 8 luminance-sorted pixels
    over the modifiers [-b, -a, a, b], and per (cut, codeword) the modifier
    mean and the error constant (float32, numpy)."""
    cb = np.asarray(util.ETC1_CODEBOOK)
    a_cw = cb[:, 0].astype(np.float32)
    b_cw = cb[:, 1].astype(np.float32)
    parts = np.array([(p1, p2, p3) for p1 in range(9) for p2 in range(p1, 9)
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


def _cluster_fit_enum_bases(rgb, flip, fdt, top: int = 2):
    """Exhaustive cluster fit over the contiguous cuts of the
    luminance-sorted pixels x 8 codewords, scored in closed form; the
    ``top`` best per subblock, and two constrained re-solves inside the 555
    differential window of the other subblock's winner. Returns
    (candidates, the real-valued winners)."""
    device = rgb.device
    parts, mu_np, const_np, coef13_np, coef2_np = _enum_tables()
    mu = torch.from_numpy(mu_np).to(device=device, dtype=fdt)
    const = torch.from_numpy(const_np).to(device=device, dtype=fdt)[None, :]
    coef13 = torch.from_numpy(coef13_np).to(device=device, dtype=fdt)
    coef2 = torch.from_numpy(coef2_np).to(device=device, dtype=fdt)
    p1, p2, p3 = (torch.from_numpy(parts[:, j]).to(device) for j in range(3))
    first = (_PY < 2) if flip else (_PX < 2)
    rgbf = rgb.to(fdt)

    def subblock(members):
        px = rgbf[:, torch.from_numpy(np.where(members)[0]).to(device), :]
        mean_ch = px.sum(dim=1) / 8.0
        t = (px - mean_ch[:, None, :]).sum(dim=2)
        ts = torch.sort(t, dim=1).values
        cum = torch.cat([torch.zeros_like(ts[:, :1]), ts.cumsum(dim=1)], dim=1)
        g13 = cum[:, p1] + cum[:, p3]
        g2 = cum[:, p2]
        tm = g13[:, :, None] * coef13 + g2[:, :, None] * coef2
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

    def constrained(e, mean_ch, other_codes, lo_off, hi_off):
        pen = None
        windows = []
        for ch in range(3):
            lo_c = (other_codes[ch] + lo_off).clamp(0, 31)
            hi_c = (other_codes[ch] + hi_off).clamp(0, 31)
            lo_v = (lo_c * 8).to(fdt)[:, None]
            hi_v = (hi_c * 8 + 7).to(fdt)[:, None]
            b_opt = mean_ch[:, ch:ch + 1] - mu[None, :]
            d = (lo_v - b_opt).clamp(min=0.0) + (b_opt - hi_v).clamp(min=0.0)
            pen = d * d if pen is None else pen + d * d
            windows.append((lo_c, hi_c, lo_v[:, 0], hi_v[:, 0]))
        k = _argmin_first(e + 8.0 * pen, 1)
        q555, q444 = [], []
        for ch, (lo_c, hi_c, lo_v, hi_v) in enumerate(windows):
            b = torch.clamp(mean_ch[:, ch] - mu[k], lo_v, hi_v)
            r = torch.round(b).to(torch.int32)
            q555.append(torch.clamp(util.quantize8(r, 5), lo_c, hi_c))
            q444.append(util.quantize8(r, 4))
        return q555, q444

    q1w_555, q2w_555, q1w_444, q2w_444 = out[0]
    q2c_555, q2c_444 = constrained(e2, mean2, q1w_555, -4, 3)
    out.append((q1w_555, q2c_555, q1w_444, q2c_444))
    q1c_555, q1c_444 = constrained(e1, mean1, q2w_555, -3, 4)
    out.append((q1c_555, q2w_555, q1c_444, q2w_444))
    return out, real


def _neighborhood_qs(q):
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
    q2c = [torch.clamp(b, a - 4, a + 3) for a, b in zip(q1, q2)]
    q1c = [torch.clamp(a, b - 3, b + 4) for a, b in zip(q1, q2)]
    return q2c, q1c


def _hq_candidates(rgb: torch.Tensor, flip: bool, fdt):
    """The flip's candidates in tie-break order: truncated and rounded
    averages, their clamped-delta variants and +-1 neighbourhood, the
    alternating cluster fit, the exhaustive fit and its clamped variants."""
    avg1, avg2 = _averages(rgb, flip)
    q1r = ([util.quantize8(a, 5) for a in avg1], [util.quantize8(a, 4) for a in avg1])
    q2r = ([util.quantize8(a, 5) for a in avg2], [util.quantize8(a, 4) for a in avg2])
    qs = [([a >> 3 for a in avg1], [a >> 3 for a in avg2],
           [a >> 4 for a in avg1], [a >> 4 for a in avg2]),
          (q1r[0], q2r[0], q1r[1], q2r[1])]
    q2c, q1c = _diff_clamped(q1r[0], q2r[0])
    qs.append((q1r[0], q2c, q1r[1], q2r[1]))
    qs.append((q1c, q2r[0], q1r[1], q2r[1]))
    qs += _neighborhood_qs((q1r[0], q2r[0], q1r[1], q2r[1]))
    q_enum, real_enum = _cluster_fit_enum_bases(rgb, flip, fdt)
    qs += _cluster_fit_bases(rgb, flip, fdt, extra_seeds=real_enum[:1])
    qs += q_enum
    eq1, eq2, eq1_444, eq2_444 = q_enum[0]
    e2c, e1c = _diff_clamped(eq1, eq2)
    qs.append((eq1, e2c, eq1_444, eq2_444))
    qs.append((e1c, eq2, eq1_444, eq2_444))
    return qs


def _hq_search(rgb, flip, fdt):
    """One flip: (hi, lo, err) of the first candidate of least error among
    the candidates, the two chained refits and the probes."""
    n = rgb.shape[0]
    state = (torch.zeros(n, dtype=torch.int32, device=rgb.device),
             torch.zeros(n, dtype=torch.int32, device=rgb.device),
             torch.full((n,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                        device=rgb.device))

    def consider(q, state):
        cand = _finish_flip(rgb, flip, SMALLER_ERROR, *q)
        better = cand[2] < state[2]
        return cand, tuple(torch.where(better, c, s) for c, s in zip(cand, state))

    # The candidates travel packed, one word per subblock, as in the port.
    for q in _hq_candidates(rgb, flip, fdt):
        words = (_pack_q_word(q[0], q[2]), _pack_q_word(q[1], q[3]))
        _, state = consider(_unpack_q_words(*words), state)
    cur = state
    for _ in range(HQ_REFITS):
        q = _refit_bases(rgb, flip, cur[0], cur[1], fdt)
        cur, state = consider(q, state)
    for probe in _neighborhood_qs(q):
        _, state = consider(probe, state)
    return state


def encode_etc1_hq_blocks(rgb: torch.Tensor,
                          fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, 16, 3) int -> (N, 8) uint8 HQ ETC1 blocks."""
    rgb = rgb.to(torch.int32)
    out = []
    for chunk in rgb.split(ENCODE_CHUNK):
        hi, lo, err = _hq_search(chunk, False, fdt)
        hi_t, lo_t, err_t = _hq_search(chunk, True, fdt)
        take_t = err_t < err
        out.append(words_to_bytes(torch.where(take_t, hi_t, hi),
                                  torch.where(take_t, lo_t, lo)))
    return torch.cat(out)
