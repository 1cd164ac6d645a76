"""HQ DXT1 (RGB) and DXT5 (RGBA) blocks, ``quality="high"`` (copied from
``texcomp_torch/codecs/dxt_hq.py`` and the plain twin of
``texcomp_torch/ops/dxt_hq_cuda.cluster_topk4``): PCA endpoints, three
least-squares rounds against the hardware palette, a +-1 code-point
neighbourhood and the cluster fit's top 4 of the 965 ordered cuts; a
3-colour candidate and the reference encoder's block compete on exact
decoded error. DXT5 adds the alpha search. Whole 4x4 windows of the
image, no swapped formats.

The endpoint fit is float32 in the port; ``fdt`` sets the float type of
the fit (PCA, least-squares solves, cluster-fit endpoints) here, so that
the benchmark's control can run the same encoder one precision lower
(bfloat16). Errors are scored exactly in float32 whatever ``fdt`` is.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from texbench.reference import dxt, util
from texbench.reference.etc import _argmin_first

_REFINE_ITERS = 3
# Palette weights (w0, w1) of codes 0-3, scaled by 3; the 3-colour mode
# scaled by 2 (black is free).
_CODE_U0 = (3, 0, 2, 1)
_CODE_U1 = (0, 3, 1, 2)
_CODE3_U0 = (2, 0, 1, 0)
_CODE3_U1 = (0, 2, 1, 0)
# Alpha ramp weights, scaled by 7 (interpolated) and 5 (explicit; its 0 and
# 255 entries are free).
_ALPHA_U0_INTERP = (7, 0, 6, 5, 4, 3, 2, 1)
_ALPHA_U1_INTERP = (0, 7, 1, 2, 3, 4, 5, 6)
_ALPHA_U0_EXPL = (5, 0, 4, 3, 2, 1, 0, 0)
_ALPHA_U1_EXPL = (0, 5, 1, 2, 3, 4, 0, 0)
_ALPHA_FREE_EXPL = (1, 1, 1, 1, 1, 1, 0, 0)
_ALPHA_GRID = [(d0, d1) for d0 in range(-3, 4) for d1 in range(-3, 4)
               if (d0, d1) != (0, 0)]

#: Blocks per cluster-fit step: bounds the (chunk, 965) score planes.
_CLUSTER_CHUNK = 1 << 16
_CLUSTER_TOPK = 4


def _f32(x: float) -> float:
    return float(np.float32(x))


def _table(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# The cluster-fit table and its top 4.
# ---------------------------------------------------------------------------


def _round_bf16(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.float32).view(np.uint32)
    u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def _split_bf16(x: np.ndarray):
    xf = x.astype(np.float32)
    hi = _round_bf16(xf)
    return hi, _round_bf16((xf - hi).astype(np.float32))


@functools.lru_cache(maxsize=None)
def cluster_tables():
    """(cuts (965, 3) int32, qtab (965, 9) float32): the ordered cuts
    c1 <= c2 <= c3 of 16 axis-sorted pixels into the clusters of weights
    1, 2/3, 1/3, 0 whose normal equations are not singular (float64), and
    per cut [quu_h, quu_l, qut_h, qut_l, qtt_h, qtt_l, alpha, beta, delta]:
    the score constants bf16 hi/lo-split, the endpoint constants (+0.0 for
    a -0.0 beta)."""
    parts = np.array([(c1, c2, c3) for c1 in range(17)
                      for c2 in range(c1, 17) for c3 in range(c2, 17)],
                     np.int64)
    n0 = parts[:, 0].astype(np.float64)
    n1 = (parts[:, 1] - parts[:, 0]).astype(np.float64)
    n2 = (parts[:, 2] - parts[:, 1]).astype(np.float64)
    n3 = 16.0 - parts[:, 2].astype(np.float64)
    a00 = n0 + 4.0 * n1 / 9.0 + n2 / 9.0
    a01 = 2.0 * (n1 + n2) / 9.0
    a11 = n3 + 4.0 * n2 / 9.0 + n1 / 9.0
    det = a00 * a11 - a01 * a01
    keep = np.abs(det) > 1e-9
    parts, a00, a01, a11, det = (x[keep] for x in (parts, a00, a01, a11, det))
    alpha, beta, delta = a11 / det, -a01 / det, a00 / det
    quu = (alpha - 2.0 * beta + delta) / 9.0
    qut = 2.0 * (beta - delta) / 3.0
    qtt = delta
    qtab = np.zeros((parts.shape[0], 9), np.float32)
    for col, const in ((0, quu), (2, qut), (4, qtt)):
        qtab[:, col], qtab[:, col + 1] = _split_bf16(const.astype(np.float32))
    qtab[:, 6:9] = np.stack([alpha, beta, delta], axis=1).astype(
        np.float32) + 0.0
    return parts.astype(np.int32), qtab


def _cf_score(a_i, b_i, ptt_i, quu_h, quu_l, qut_h, qut_l, qtt_h, qtt_l):
    def split(v):
        vf = v.to(torch.float32)
        vh = vf.to(torch.bfloat16).to(torch.float32)
        return vh, (vf - vh).to(torch.bfloat16).to(torch.float32)

    def term(qh, ql, v):
        vh, vl = split(v)
        return (qh * vh + qh * vl) + ql * vh

    return ((term(quu_h, quu_l, a_i) + term(qut_h, qut_l, b_i))
            + term(qtt_h, qtt_l, ptt_i))


def _argmax_first(score: torch.Tensor) -> torch.Tensor:
    top = score.amax(dim=1, keepdim=True)
    idx = torch.arange(score.shape[1], device=score.device)
    return torch.where(score == top, idx, score.shape[1]).amin(dim=1)


def cluster_topk4(prefix: torch.Tensor, cuts: torch.Tensor,
                  qtab: torch.Tensor) -> torch.Tensor:
    """(N, 17, 3) int32 descending prefix sums -> (N, 4, 6) float32
    payloads (u0, u1, u2, alpha, beta, delta) of the 4 best cuts, in
    descending score order, ties to the lower cut."""
    p = prefix.to(torch.int32)
    pt = p[:, 16, :]
    uc = [p[:, cuts[:, 0], c] + p[:, cuts[:, 1], c] + p[:, cuts[:, 2], c]
          for c in range(3)]
    a_i = uc[0] * uc[0] + uc[1] * uc[1] + uc[2] * uc[2]
    b_i = pt[:, 0:1] * uc[0] + pt[:, 1:2] * uc[1] + pt[:, 2:3] * uc[2]
    ptt_i = (pt[:, 0] * pt[:, 0] + pt[:, 1] * pt[:, 1]
             + pt[:, 2] * pt[:, 2])[:, None]
    q = [qtab[None, :, j] for j in range(6)]
    score = _cf_score(a_i, b_i, ptt_i, *q)
    picks = []
    for _ in range(_CLUSTER_TOPK):
        k = _argmax_first(score)
        score = score.scatter(1, k[:, None], float("-inf"))
        u = [torch.gather(c, 1, k[:, None]).to(torch.float32) for c in uc]
        picks.append(torch.cat(u + [qtab[k, 6:9]], dim=1))
    return torch.stack(picks, dim=1)


@functools.lru_cache(maxsize=None)
def _cf_device_tables(device: torch.device):
    cuts, qtab = cluster_tables()
    return torch.from_numpy(cuts).to(device), torch.from_numpy(qtab).to(device)


# ---------------------------------------------------------------------------
# Exact arithmetic, palette, least squares, PCA.
# ---------------------------------------------------------------------------


def _det_recip(b: torch.Tensor) -> torch.Tensor:
    """1 / b in float32: four Newton steps from a bit-hack seed."""
    b = b.to(torch.float32)
    r = (0x7EF311C3 - b.view(torch.int32)).view(torch.float32)
    for _ in range(4):
        r = r * (2.0 - b * r)
    return r


def _det_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) in float32: four Newton steps from 0x5F3759DF."""
    x = x.to(torch.float32)
    y = (0x5F3759DF - (x.view(torch.int32) >> 1)).view(torch.float32)
    for _ in range(4):
        y = y * (1.5 - 0.5 * (x * (y * y)))
    return y


def _endpoint_channels(c16: torch.Tensor):
    """Packed 565 -> the decoded 8-bit (r, g, b), NVIDIA expansion."""
    return list(util.extend565(c16 >> 11, (c16 >> 5) & 63, c16 & 31))


def _hardware_palette(c0, c1):
    pal = []
    for a, b in zip(_endpoint_channels(c0), _endpoint_channels(c1)):
        pal.append(torch.stack([a, b, util.combine_int(2, 1, a, b),
                                util.combine_int(1, 2, a, b)], dim=-1))
    return pal


def _nearest(rgb_f, pal):
    d = None
    for ch in range(3):
        diff = pal[ch].to(torch.float32)[:, None, :] - rgb_f[:, :, ch, None]
        d = diff * diff if d is None else d + diff * diff
    return _argmin_first(d, 2), d.amin(dim=2).sum(dim=1)


def _assign_codes(rgb_f, c0, c1):
    return _nearest(rgb_f, _hardware_palette(c0, c1))


def _least_squares_endpoints(rgb, codes, fdt, u0=_CODE_U0, u1=_CODE_U1,
                             scale: int = 3):
    """Least-squares endpoints for fixed codes per channel: integer-scaled
    normal equations (exact int32), a singular system keeps the block
    mean. Returns (e0, e1), 3-lists of (N,) ``fdt`` in [0, 255]."""
    w0 = _table(u0, rgb)[codes]
    w1 = _table(u1, rgb)[codes]
    a00 = (w0 * w0).sum(dim=1, dtype=torch.int32)
    a01 = (w0 * w1).sum(dim=1, dtype=torch.int32)
    a11 = (w1 * w1).sum(dim=1, dtype=torch.int32)
    det = a00 * a11 - a01 * a01
    safe = det != 0
    rdet = _det_recip(torch.where(safe, det, 1).to(torch.float32)).to(fdt)
    s = float(scale)
    e0, e1 = [], []
    for ch in range(3):
        px = rgb[:, :, ch]
        b0 = (w0 * px).sum(dim=1, dtype=torch.int32)
        b1 = (w1 * px).sum(dim=1, dtype=torch.int32)
        x0 = (s * (a11 * b0 - a01 * b1).to(fdt)) * rdet
        x1 = (s * (a00 * b1 - a01 * b0).to(fdt)) * rdet
        fallback = px.sum(dim=1, dtype=torch.int32).to(fdt) / 16.0
        e0.append(torch.where(safe, x0, fallback).clamp(0.0, 255.0))
        e1.append(torch.where(safe, x1, fallback).clamp(0.0, 255.0))
    return e0, e1


def _quantize_endpoints(e0, e1):
    """Float endpoints -> packed 565 (round half to even)."""
    def q(v, bits):
        m = (1 << bits) - 1
        return torch.round(v * _f32(m / 255.0)).clamp(0, m).to(torch.int32)

    c0 = (q(e0[0], 5) << 11) | (q(e0[1], 6) << 5) | q(e0[2], 5)
    c1 = (q(e1[0], 5) << 11) | (q(e1[1], 6) << 5) | q(e1[2], 5)
    return c0, c1


def _pca_project(rgb, fdt):
    """Principal-axis projections: 3 power iterations on the int32
    covariance of 16x-scaled centred pixels, normalised by the Newton
    rsqrt. Returns (mean (N, 1, 3), axis (N, 3), t (N, 16))."""
    n = rgb.shape[0]
    s = rgb.sum(dim=1, dtype=torch.int32)
    d16 = 16 * rgb - s[:, None, :]
    cov = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            cij = (d16[:, :, i] * d16[:, :, j]).sum(dim=1, dtype=torch.int32)
            cov[i][j] = cov[j][i] = cij.to(fdt)
    mean = (s.to(fdt) / 16.0)[:, None, :]
    v = [torch.ones(n, dtype=fdt, device=rgb.device)] * 3
    for _ in range(3):
        w = [cov[i][0] * v[0] + cov[i][1] * v[1] + cov[i][2] * v[2]
             for i in range(3)]
        inv = _det_rsqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
                         + 1e-12).to(fdt)
        v = [wi * inv for wi in w]
    d = rgb.to(fdt) - mean
    t = (d[:, :, 0] * v[0][:, None] + d[:, :, 1] * v[1][:, None]
         + d[:, :, 2] * v[2][:, None])
    return mean, torch.stack(v, dim=-1), t


def _pca_endpoints(proj):
    mean, v, t = proj
    e0 = (mean[:, 0, :] + t.amin(dim=1, keepdim=True) * v).clamp(0.0, 255.0)
    e1 = (mean[:, 0, :] + t.amax(dim=1, keepdim=True) * v).clamp(0.0, 255.0)
    return list(e0.unbind(1)), list(e1.unbind(1))


# ---------------------------------------------------------------------------
# Cluster fit.
# ---------------------------------------------------------------------------


def _prefix_sums(rgb, t):
    """(N, 17, 3) int32: row r sums the r pixels of largest ``t``, ties to
    the lower pixel index."""
    idx = torch.arange(16, device=rgb.device)
    earlier = idx[None, :] < idx[:, None]
    ti, tj = t[:, :, None], t[:, None, :]
    rank = ((tj > ti) | ((tj == ti) & earlier)).sum(dim=2)
    ordered = torch.empty_like(rgb).scatter_(
        1, rank[:, :, None].expand(-1, -1, 3), rgb)
    zero = torch.zeros_like(rgb[:, :1])
    return torch.cat([zero, ordered.cumsum(dim=1, dtype=torch.int32)], dim=1)


def _cluster_fit_chunk(rgb, t, fdt):
    p = _prefix_sums(rgb, t)
    cuts, qtab = _cf_device_tables(rgb.device)
    payload = cluster_topk4(p, cuts, qtab).to(fdt)
    pt = p[:, 16, :].to(fdt)
    out = []
    for k in range(_CLUSTER_TOPK):
        uk = payload[:, k, 0:3]
        al, be, de = (payload[:, k, j:j + 1] for j in (3, 4, 5))
        b0 = uk * _f32(1.0 / 3.0)
        b1 = pt - b0
        e0 = (al * b0 + be * b1).clamp(0.0, 255.0)
        e1 = (be * b0 + de * b1).clamp(0.0, 255.0)
        out.append(_quantize_endpoints(list(e0.unbind(1)), list(e1.unbind(1))))
    return out


def _cluster_fit_candidates(rgb, t, fdt):
    chunks = [_cluster_fit_chunk(r, tc, fdt) for r, tc in
              zip(rgb.split(_CLUSTER_CHUNK), t.split(_CLUSTER_CHUNK))]
    return [(torch.cat([c[k][0] for c in chunks]),
             torch.cat([c[k][1] for c in chunks]))
            for k in range(_CLUSTER_TOPK)]


# ---------------------------------------------------------------------------
# DXT1 colour search.
# ---------------------------------------------------------------------------


def _perturb_565(c, ch: int, d: int):
    shift = (11, 5, 0)[ch]
    m = (1 << (5, 6, 5)[ch]) - 1
    f = ((c >> shift) & m) + d
    return (c & ~(m << shift)) | (f.clamp(0, m) << shift)


def _hq_color_words(rgb, fdt):
    """The HQ 4-colour search: (c0, c1, rows (N, 4), exact error)."""
    rgb_f = rgb.to(torch.float32)
    proj = _pca_project(rgb, fdt)
    c0, c1 = _quantize_endpoints(*_pca_endpoints(proj))
    codes, best_err = _assign_codes(rgb_f, c0, c1)
    best = (c0, c1, codes)

    def take(c0, c1, best, best_err):
        codes, err = _assign_codes(rgb_f, c0, c1)
        better = err < best_err
        best = (torch.where(better, c0, best[0]),
                torch.where(better, c1, best[1]),
                torch.where(better[:, None], codes, best[2]))
        return codes, best, torch.minimum(err, best_err)

    for _ in range(_REFINE_ITERS):
        e0, e1 = _least_squares_endpoints(rgb, codes, fdt)
        codes, best, best_err = take(*_quantize_endpoints(e0, e1), best,
                                     best_err)

    bc0, bc1 = best[0], best[1]
    for ch in range(3):
        for d in (-1, 1):
            _, best, best_err = take(_perturb_565(bc0, ch, d), bc1, best,
                                     best_err)
            _, best, best_err = take(bc0, _perturb_565(bc1, ch, d), best,
                                     best_err)

    for c0_k, c1_k in _cluster_fit_candidates(rgb, proj[2], fdt):
        codes_k, best, best_err = take(c0_k, c1_k, best, best_err)
        e0, e1 = _least_squares_endpoints(rgb, codes_k, fdt)
        _, best, best_err = take(*_quantize_endpoints(e0, e1), best, best_err)

    # 4-colour mode needs c0 > c1; equal endpoints take all codes 0.
    c0, c1, codes = best
    swap = c0 < c1
    c0_f = torch.where(swap, c1, c0)
    c1_f = torch.where(swap, c0, c1)
    codes = torch.where(swap[:, None], codes ^ 1, codes)
    codes = torch.where((c0_f == c1_f)[:, None], 0, codes)
    return c0_f, c1_f, dxt._pack_rows(codes), best_err


def _assign_codes3(rgb_f, c0, c1):
    pal = []
    for a, b in zip(_endpoint_channels(c0), _endpoint_channels(c1)):
        pal.append(torch.stack([a, b, util.combine_int(1, 1, a, b),
                                torch.zeros_like(a)], dim=-1))
    return _nearest(rgb_f, pal)


def _hq3_color_words(rgb, init_c0, init_c1, fdt):
    """The 3-colour candidate (c0 <= c1) from the 4-colour result: two
    least-squares rounds. Returns ((N, 8) uint8, exact error)."""
    rgb_f = rgb.to(torch.float32)
    codes, best_err = _assign_codes3(rgb_f, init_c0, init_c1)
    best = (init_c0, init_c1, codes)
    for _ in range(2):
        e0, e1 = _least_squares_endpoints(rgb, codes, fdt, _CODE3_U0,
                                          _CODE3_U1, scale=2)
        c0, c1 = _quantize_endpoints(e0, e1)
        codes, err = _assign_codes3(rgb_f, c0, c1)
        better = err < best_err
        best = (torch.where(better, c0, best[0]),
                torch.where(better, c1, best[1]),
                torch.where(better[:, None], codes, best[2]))
        best_err = torch.minimum(err, best_err)

    c0, c1, codes = best
    swap = c0 > c1
    c0_f = torch.where(swap, c1, c0)
    c1_f = torch.where(swap, c0, c1)
    codes = torch.where(swap[:, None] & (codes < 2), codes ^ 1, codes)
    e0 = torch.stack(_endpoint_channels(c0_f), dim=-1).to(torch.float32)
    d = e0[:, None, :] - rgb_f
    err_equal = (d * d).sum(dim=(1, 2))
    best_err = torch.where(c0_f == c1_f, err_equal, best_err)
    return dxt._dxt1_bytes(c0_f, c1_f, dxt._pack_rows(codes)), best_err


def _block_error_from_words(rgb_f, c0, c1, codes, always4: bool):
    """Exact decoded error of DXT1 fields under DecodeColors' rules."""
    equal = c0 == c1
    four = torch.ones_like(equal) if always4 else c0 > c1
    err = None
    for a, b, ch in zip(_endpoint_channels(c0), _endpoint_channels(c1),
                        range(3)):
        p2 = torch.where(equal, b, torch.where(
            four, util.combine_int(2, 1, a, b), util.combine_int(1, 1, a, b)))
        p3 = torch.where(equal, b, torch.where(
            four, util.combine_int(1, 2, a, b), torch.zeros_like(a)))
        val = torch.where(codes == 0, a[:, None], torch.where(
            codes == 1, b[:, None], torch.where(codes == 2, p2[:, None],
                                                p3[:, None])))
        d = val.to(torch.float32) - rgb_f[:, :, ch]
        err = d * d if err is None else err + d * d
    return err.sum(dim=1)


def _color_fields(block8: torch.Tensor):
    d = block8.to(torch.int32)
    c0 = d[:, 0] + d[:, 1] * 256
    c1 = d[:, 2] + d[:, 3] * 256
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=d.device)
    codes = ((d[:, 4:8, None] >> shifts) & 3).reshape(-1, 16)
    return c0, c1, codes


def encode_dxt1_hq_blocks(rgb: torch.Tensor,
                          fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, 16, 3) int -> (N, 8) uint8 HQ DXT1 blocks: the best of the
    4-colour search, the 3-colour candidate and the reference block by
    exact decoded error, ties to the later (the reference last)."""
    rgb = rgb.to(torch.int32)
    ref = dxt.encode_dxt1_blocks(rgb)
    rgb_f = rgb.to(torch.float32)
    c0, c1, rows, err_hq = _hq_color_words(rgb, fdt)
    hq = dxt._dxt1_bytes(c0, c1, rows)
    hq3, err_hq3 = _hq3_color_words(rgb, c0, c1, fdt)
    rc0, rc1, rcodes = _color_fields(ref)
    err_ref = _block_error_from_words(rgb_f, rc0, rc1, rcodes, False)
    out, err = hq, err_hq
    for cand, e in ((hq3, err_hq3), (ref, err_ref)):
        better = e <= err
        out = torch.where(better[:, None], cand, out)
        err = torch.minimum(e, err)
    return out


# ---------------------------------------------------------------------------
# DXT5 alpha search.
# ---------------------------------------------------------------------------


def _alpha_assign(a, a0, a1):
    ramp = dxt._alpha_ramp(a0, a1)
    d = a[:, :, None] - ramp[:, None, :]
    dd = d * d
    err = dd.amin(dim=2).sum(dim=1, dtype=torch.int32).to(torch.float32)
    return _argmin_first(dd, 2), err


def _alpha_ls(a, codes, interp: bool, fdt):
    """Least-squares alpha endpoints for fixed codes under one ramp scheme,
    rounded."""
    if interp:
        w0 = _table(_ALPHA_U0_INTERP, a)[codes]
        w1 = _table(_ALPHA_U1_INTERP, a)[codes]
        free = torch.ones_like(w0)
        s = 7.0
    else:
        w0 = _table(_ALPHA_U0_EXPL, a)[codes]
        w1 = _table(_ALPHA_U1_EXPL, a)[codes]
        free = _table(_ALPHA_FREE_EXPL, a)[codes]
        s = 5.0

    def dot(x, y):
        return (x * y).sum(dim=1, dtype=torch.int32)

    a00, a01, a11 = dot(w0, w0), dot(w0, w1), dot(w1, w1)
    b0, b1 = dot(w0, a), dot(w1, a)
    det = a00 * a11 - a01 * a01
    safe = det != 0
    rdet = _det_recip(torch.where(safe, det, 1).to(torch.float32)).to(fdt)
    x0 = (s * (a11 * b0 - a01 * b1).to(fdt)) * rdet
    x1 = (s * (a00 * b1 - a01 * b0).to(fdt)) * rdet
    count = free.sum(dim=1, dtype=torch.int32).clamp(min=1)
    mean = dot(a, free).to(fdt) * _det_recip(count.to(torch.float32)).to(fdt)
    x0 = torch.where(safe, x0, mean)
    x1 = torch.where(safe, x1, mean)
    r = lambda v: torch.round(v).clamp(0, 255).to(torch.int32)
    return r(x0), r(x1)


def _hq_alpha(a, ref_a0, ref_a1, ref_codes, ref_err, fdt):
    """HQ alpha endpoints: least-squares polish in both schemes from the
    extremes, explicit seeds from interior extremes (margins 16-64),
    shrunk-spread interpolated seeds, then a +-3 joint grid around the best,
    twice; strict '<' in this order, the reference encoding first."""
    def consider(a0, a1, st):
        b0, b1, bc, be = st
        codes, err = _alpha_assign(a, a0, a1)
        better = err < be
        return codes, (torch.where(better, a0, b0), torch.where(better, a1, b1),
                       torch.where(better[:, None], codes, bc),
                       torch.minimum(err, be))

    def polish(a0, a1, st, interp):
        codes, st = consider(a0, a1, st)
        for _ in range(2):
            a0, a1 = _alpha_ls(a, codes, interp, fdt)
            lo, hi = torch.minimum(a0, a1), torch.maximum(a0, a1)
            a0, a1 = (hi, lo) if interp else (lo, hi)
            codes, st = consider(a0, a1, st)
        return st

    st = (ref_a0, ref_a1, ref_codes.long(), ref_err)
    hi = a.amax(dim=1)
    lo = a.amin(dim=1)
    st = polish(hi, lo, st, True)
    st = polish(lo, hi, st, False)
    for margin in (16, 32, 48, 64):
        ilo = torch.where(a >= margin, a, 256).amin(dim=1).clamp(0, 255)
        ihi = torch.where(a <= 255 - margin, a, -1).amax(dim=1).clamp(0, 255)
        st = polish(ilo, ihi, st, False)
    c = (lo + hi).to(fdt) / 2.0
    r = (hi - lo).to(fdt) / 2.0
    for s in (0.75, 0.875):
        s_lo = torch.round(c - r * s).clamp(0, 255).to(torch.int32)
        s_hi = torch.round(c + r * s).clamp(0, 255).to(torch.int32)
        st = polish(s_hi, s_lo, st, True)
    for _ in range(2):
        ca0, ca1 = st[0], st[1]
        for d0, d1 in _ALPHA_GRID:
            _, st = consider((ca0 + d0).clamp(0, 255), (ca1 + d1).clamp(0, 255),
                             st)
    return st[0], st[1], st[2]


def encode_dxt5_hq_blocks(rgba: torch.Tensor,
                          fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, 16, 4) int -> (N, 16) uint8 HQ DXT5 blocks: HQ colour (always
    4-colour decode) against the reference colour, ties to HQ; HQ alpha
    seeded with the reference alpha."""
    rgba = rgba.to(torch.int32)
    ref = dxt.encode_dxt5_blocks(rgba)
    ref_i = ref.to(torch.int32)
    rgb = rgba[:, :, :3]
    c0, c1, rows, err_hq = _hq_color_words(rgb, fdt)
    hq = dxt._dxt1_bytes(c0, c1, rows)
    rc0, rc1, rcodes = _color_fields(ref[:, 8:16])
    err_ref = _block_error_from_words(rgb.to(torch.float32), rc0, rc1, rcodes,
                                      True)
    color = torch.where((err_hq <= err_ref)[:, None], hq, ref[:, 8:16])

    a = rgba[:, :, 3]
    ref_a0, ref_a1 = ref_i[:, 0], ref_i[:, 1]
    ref_codes = dxt._unpack_alpha_codes(ref_i[:, 2:8])
    ref_vals = torch.gather(dxt._alpha_ramp(ref_a0, ref_a1), 1,
                            ref_codes.long())
    d = (ref_vals - a).to(torch.float32)
    ref_err = (d * d).sum(dim=-1)
    a0, a1, codes = _hq_alpha(a, ref_a0, ref_a1, ref_codes, ref_err, fdt)
    head = torch.stack([a0, a1], dim=-1)
    alpha = torch.cat([head, dxt._pack_alpha_codes(codes)], dim=-1)
    return torch.cat([alpha.to(torch.uint8), color], dim=-1)
