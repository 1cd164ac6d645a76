"""High-quality DXT1/DXT5 encoding (``quality="high"``) in PyTorch.

The port of texcomp's HQ DXT encoder. Endpoints come from PCA along the
principal colour axis, three rounds of least squares against the
hardware-decoded palette (NVIDIA 565 expansion, integer thirds), a +-1
code-point neighbourhood, and the cluster fit: the 965 non-singular
ordered cuts of the 16 axis-sorted pixels into the four ramp clusters,
scored in closed form, whose top 4 are quantized and rescored exactly.
A 3-colour-mode candidate and the reference encoder's own block compete
per block on true decoded error, so HQ is never worse than the reference.
DXT5 adds the alpha search: least squares in both ramp schemes from
several seed families and a +-3 endpoint grid, best-of with the
reference's alpha. Payloads stay standard DXT.

The bytes depend on exact arithmetic, as in texcomp:

  * integer-valued quantities (covariances, normal equations, prefix sums,
    block errors) are int32 or f32 integers below 2^24, exact in any order;
  * every fractional product is its own eager op, so nothing is contracted
    into a fused multiply-add, and no matmul (hence no TF32) appears;
  * division by anything but a power of two is the bit-seeded Newton
    reciprocal (:func:`_det_recip`), square roots the Newton rsqrt;
  * the cluster-fit score multiplies bf16-representable factors only.

Two steps run as kernels on a CUDA tensor and as their plain twins on a
CPU one: the cluster-fit top 4 (``ops.dxt_hq_cuda.cluster_topk4``) and the
reference candidate (the DXT1/DXT5 encode of ``ops.dxt_cuda``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from texcomp_torch.blocks import extract_blocks
from texcomp_torch.codecs import dxt
from texcomp_torch.codecs.etc import _argmin_first
from texcomp_torch.core import colors as cc
from texcomp_torch.ops import dxt_cuda, dxt_hq_cuda

_REFINE_ITERS = 3
# Palette weights (w0, w1) of codes 0-3, scaled by 3 so that the normal
# equations sum integers: p2 = (2 e0 + e1) / 3, p3 = (e0 + 2 e1) / 3.
_CODE_U0 = (3, 0, 2, 1)
_CODE_U1 = (0, 3, 1, 2)
# 3-colour mode [e0, e1, (e0 + e1) / 2, black], scaled by 2; black is free.
_CODE3_U0 = (2, 0, 1, 0)
_CODE3_U1 = (0, 2, 1, 0)
# Alpha ramp weights, scaled by 7 (interpolated scheme) and 5 (explicit;
# its 0 and 255 entries are free).
_ALPHA_U0_INTERP = (7, 0, 6, 5, 4, 3, 2, 1)
_ALPHA_U1_INTERP = (0, 7, 1, 2, 3, 4, 5, 6)
_ALPHA_U0_EXPL = (5, 0, 4, 3, 2, 1, 0, 0)
_ALPHA_U1_EXPL = (0, 5, 1, 2, 3, 4, 0, 0)
_ALPHA_FREE_EXPL = (1, 1, 1, 1, 1, 1, 0, 0)
# The +-3 joint alpha endpoint grid, in scan order.
_ALPHA_GRID = [(d0, d1) for d0 in range(-3, 4) for d1 in range(-3, 4)
               if (d0, d1) != (0, 0)]

#: Blocks per cluster-fit step: bounds the (chunk, 965) score planes.
_CLUSTER_CHUNK = 1 << 16
_CLUSTER_TOPK = 4


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exactly representable,
    so a tensor op uses this value on every device)."""
    return float(np.float32(x))


def _table(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# Tables and exact arithmetic.
# ---------------------------------------------------------------------------


def _cluster_tables():
    """The cluster-fit partitions and their closed-form constants.

    Every ordered cut c1 <= c2 <= c3 of the 16 axis-sorted pixels into the
    clusters of weights 1, 2/3, 1/3, 0 (969 of them), less the 4 whose
    normal equations are singular (``abs(det) <= 1e-9``), computed in
    float64 as texcomp does. With u = P[c1] + P[c2] + P[c3] over the
    descending prefix sums P and the block total Pt, the least-squares
    endpoints are e0 = alpha b0 + beta b1, e1 = beta b0 + delta b1 with
    b0 = u / 3, b1 = Pt - u / 3, and the error it removes is
    quu u.u + qut u.Pt + qtt Pt.Pt.

    Returns (cuts (P, 3) int32, quu, qut, qtt, alpha, beta, delta), the
    constants float32 (P,)."""
    parts = np.array([(c1, c2, c3)
                      for c1 in range(17)
                      for c2 in range(c1, 17)
                      for c3 in range(c2, 17)], np.int64)
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
    alpha = a11 / det
    beta = -a01 / det
    delta = a00 / det
    quu = (alpha - 2.0 * beta + delta) / 9.0
    qut = 2.0 * (beta - delta) / 3.0
    qtt = delta
    f32 = lambda x: x.astype(np.float32)
    return (parts.astype(np.int32), f32(quu), f32(qut), f32(qtt), f32(alpha),
            f32(beta), f32(delta))


(_CF_CUTS, _CF_QUU, _CF_QUT, _CF_QTT,
 _CF_ALPHA, _CF_BETA, _CF_DELTA) = _cluster_tables()


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float32."""
    u = x.astype(np.float32).view(np.uint32)
    u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def _split_bf16(x: np.ndarray):
    """float32 -> (hi, lo), both bf16-representable, hi + lo within about
    2^-16 relative: a score product of two such factors is exact in
    float32, so no multiply-add contraction can change it."""
    xf = x.astype(np.float32)
    hi = _round_bf16(xf)
    lo = _round_bf16((xf - hi).astype(np.float32))
    return hi, lo


def _cf_tables_np():
    """(cuts (P, 3) int32, qtab (P, 9) float32): qtab's columns are
    [quu_h, quu_l, qut_h, qut_l, qtt_h, qtt_l, alpha, beta, delta], the
    score constants bf16 hi/lo-split. beta is -0.0 where no pixel sits
    between the endpoints; texcomp picks a payload by a one-hot sum, which
    gives +0.0 there, so the table holds +0.0 (``+ 0.0``)."""
    qtab = np.zeros((_CF_CUTS.shape[0], 9), np.float32)
    for col, const in ((0, _CF_QUU), (2, _CF_QUT), (4, _CF_QTT)):
        qtab[:, col], qtab[:, col + 1] = _split_bf16(const)
    qtab[:, 6:9] = np.stack([_CF_ALPHA, _CF_BETA, _CF_DELTA], axis=1) + 0.0
    return _CF_CUTS, qtab


@functools.lru_cache(maxsize=None)
def _cf_device_tables(device: torch.device):
    """The partition tables of :func:`_cf_tables_np` on ``device``."""
    cuts, qtab = _cf_tables_np()
    return torch.from_numpy(cuts).to(device), torch.from_numpy(qtab).to(device)


def _det_recip(b: torch.Tensor) -> torch.Tensor:
    """1 / b in float32, the same bits on every device: four Newton steps
    from a bit-hack seed, each product and difference rounded on its own
    (a hardware divide is not bit-stable across backends)."""
    b = b.to(torch.float32)
    r = (0x7EF311C3 - b.view(torch.int32)).view(torch.float32)
    for _ in range(4):
        r = r * (2.0 - b * r)
    return r


def _det_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) in float32, the same bits on every device: four Newton
    steps from the 0x5F3759DF seed."""
    x = x.to(torch.float32)
    y = (0x5F3759DF - (x.view(torch.int32) >> 1)).view(torch.float32)
    for _ in range(4):
        y = y * (1.5 - 0.5 * (x * (y * y)))
    return y


# ---------------------------------------------------------------------------
# Palette, least squares, PCA.
# ---------------------------------------------------------------------------


def _endpoint_channels(c16: torch.Tensor):
    """Packed 565 -> the decoded 8-bit (r, g, b), NVIDIA expansion."""
    return [cc.extend565_r(c16 >> 11), cc.extend565_g((c16 >> 5) & 63),
            cc.extend565_b(c16 & 31)]


def _hardware_palette(c0, c1):
    """The decoded 4-colour palette (always 4-colour) per channel: 3 x
    (N, 4) int32 (dxtc_compressor.cc:167-192)."""
    pal = []
    for a, b in zip(_endpoint_channels(c0), _endpoint_channels(c1)):
        pal.append(torch.stack([a, b, cc.combine_int_fast(2, 1, a, b),
                                cc.combine_int_fast(1, 2, a, b)], dim=-1))
    return pal


def _nearest(rgb_f, pal):
    """Nearest palette entry per pixel by squared RGB distance (first
    occurrence) and the block's summed error: (codes (N, 16), err (N,))."""
    d = None
    for ch in range(3):
        diff = pal[ch].to(torch.float32)[:, None, :] - rgb_f[:, :, ch, None]
        d = diff * diff if d is None else d + diff * diff
    return _argmin_first(d, 2), d.amin(dim=2).sum(dim=1)


def _assign_codes(rgb_f, c0, c1):
    """Codes and exact error against the hardware 4-colour palette."""
    return _nearest(rgb_f, _hardware_palette(c0, c1))


def _least_squares_endpoints(rgb, codes, u0=_CODE_U0, u1=_CODE_U1,
                             scale: int = 3):
    """Least-squares endpoints for fixed codes, per channel: the 2x2 normal
    equations with integer-scaled weights (u = scale * w), so every sum is
    an exact int32; the only roundings are the int -> f32 conversion and
    two products. A singular system (every pixel on one endpoint) keeps the
    block mean. rgb: (N, 16, 3) int32. Returns (e0, e1), 3-lists of (N,)
    float32 in [0, 255]."""
    w0 = _table(u0, rgb)[codes]
    w1 = _table(u1, rgb)[codes]
    a00 = (w0 * w0).sum(dim=1, dtype=torch.int32)
    a01 = (w0 * w1).sum(dim=1, dtype=torch.int32)
    a11 = (w1 * w1).sum(dim=1, dtype=torch.int32)
    det = a00 * a11 - a01 * a01
    safe = det != 0
    rdet = _det_recip(torch.where(safe, det, 1).to(torch.float32))
    s = float(scale)
    e0, e1 = [], []
    for ch in range(3):
        px = rgb[:, :, ch]
        b0 = (w0 * px).sum(dim=1, dtype=torch.int32)
        b1 = (w1 * px).sum(dim=1, dtype=torch.int32)
        x0 = (s * (a11 * b0 - a01 * b1).to(torch.float32)) * rdet
        x1 = (s * (a00 * b1 - a01 * b0).to(torch.float32)) * rdet
        fallback = px.sum(dim=1, dtype=torch.int32).to(torch.float32) / 16.0
        e0.append(torch.where(safe, x0, fallback).clamp(0.0, 255.0))
        e1.append(torch.where(safe, x1, fallback).clamp(0.0, 255.0))
    return e0, e1


def _quantize_endpoints(e0, e1):
    """Float endpoints -> packed 565, one product and a round per field
    (round half to even)."""
    def q(v, bits):
        m = (1 << bits) - 1
        return torch.round(v * _f32(m / 255.0)).clamp(0, m).to(torch.int32)

    c0 = (q(e0[0], 5) << 11) | (q(e0[1], 6) << 5) | q(e0[2], 5)
    c1 = (q(e1[0], 5) << 11) | (q(e1[1], 6) << 5) | q(e1[2], 5)
    return c0, c1


def _pca_project(rgb):
    """Principal-axis projections: 3 power iterations on the block's 3x3
    covariance (int32, from 16x-scaled centred pixels), normalised by the
    Newton rsqrt. rgb: (N, 16, 3) int32. Returns (mean (N, 1, 3),
    axis (N, 3), t (N, 16)), float32."""
    n = rgb.shape[0]
    s = rgb.sum(dim=1, dtype=torch.int32)
    d16 = 16 * rgb - s[:, None, :]
    cov = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            cij = (d16[:, :, i] * d16[:, :, j]).sum(dim=1, dtype=torch.int32)
            cov[i][j] = cov[j][i] = cij.to(torch.float32)
    mean = (s.to(torch.float32) / 16.0)[:, None, :]
    v = [torch.ones(n, dtype=torch.float32, device=rgb.device)] * 3
    for _ in range(3):
        w = [cov[i][0] * v[0] + cov[i][1] * v[1] + cov[i][2] * v[2]
             for i in range(3)]
        inv = _det_rsqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + 1e-12)
        v = [wi * inv for wi in w]
    d = rgb.to(torch.float32) - mean
    t = (d[:, :, 0] * v[0][:, None] + d[:, :, 1] * v[1][:, None]
         + d[:, :, 2] * v[2][:, None])
    return mean, torch.stack(v, dim=-1), t


def _pca_endpoints(proj):
    """The extreme projections along the principal axis, clamped."""
    mean, v, t = proj
    e0 = (mean[:, 0, :] + t.amin(dim=1, keepdim=True) * v).clamp(0.0, 255.0)
    e1 = (mean[:, 0, :] + t.amax(dim=1, keepdim=True) * v).clamp(0.0, 255.0)
    return list(e0.unbind(1)), list(e1.unbind(1))


# ---------------------------------------------------------------------------
# Cluster fit.
# ---------------------------------------------------------------------------


def _prefix_sums(rgb, t):
    """(N, 17, 3) int32: row r is the sum of the r pixels of largest
    projection ``t``, ties to the lower pixel index (the stable descending
    order)."""
    idx = torch.arange(16, device=rgb.device)
    earlier = idx[None, :] < idx[:, None]  # [i, j]: pixel j precedes i
    ti, tj = t[:, :, None], t[:, None, :]
    rank = ((tj > ti) | ((tj == ti) & earlier)).sum(dim=2)
    ordered = torch.empty_like(rgb).scatter_(
        1, rank[:, :, None].expand(-1, -1, 3), rgb)
    zero = torch.zeros_like(rgb[:, :1])
    return torch.cat([zero, ordered.cumsum(dim=1, dtype=torch.int32)], dim=1)


def _cluster_fit_chunk(rgb, t):
    """The top-4 cluster-fit candidates of one chunk: 4 x (c0, c1)."""
    p = _prefix_sums(rgb, t)
    cuts, qtab = _cf_device_tables(rgb.device)
    payload = dxt_hq_cuda.cluster_topk4(p, cuts, qtab)  # (C, 4, 6)
    pt = p[:, 16, :].to(torch.float32)
    out = []
    for k in range(_CLUSTER_TOPK):
        uk = payload[:, k, 0:3]  # exact integers
        al, be, de = (payload[:, k, j:j + 1] for j in (3, 4, 5))
        b0 = uk * _f32(1.0 / 3.0)
        b1 = pt - b0
        e0 = (al * b0 + be * b1).clamp(0.0, 255.0)
        e1 = (be * b0 + de * b1).clamp(0.0, 255.0)
        out.append(_quantize_endpoints(list(e0.unbind(1)), list(e1.unbind(1))))
    return out


def _cluster_fit_candidates(rgb, t):
    """Top-4 cluster-fit endpoint candidates, 4 x (c0, c1) packed 565,
    :data:`_CLUSTER_CHUNK` blocks at a time. ``t``: the PCA projections."""
    chunks = [_cluster_fit_chunk(r, tc) for r, tc in
              zip(rgb.split(_CLUSTER_CHUNK), t.split(_CLUSTER_CHUNK))]
    return [(torch.cat([c[k][0] for c in chunks]),
             torch.cat([c[k][1] for c in chunks]))
            for k in range(_CLUSTER_TOPK)]


# ---------------------------------------------------------------------------
# DXT1 colour search.
# ---------------------------------------------------------------------------


def _perturb_565(c, ch: int, d: int):
    """``c`` with 565 field ``ch`` (0 r, 1 g, 2 b) moved by d, clamped."""
    shift = (11, 5, 0)[ch]
    m = (1 << (5, 6, 5)[ch]) - 1
    f = ((c >> shift) & m) + d
    return (c & ~(m << shift)) | (f.clamp(0, m) << shift)


def _hq_color_words(rgb):
    """The HQ 4-colour search. rgb: (N, 16, 3) int32. Returns (c0, c1,
    rows (N, 4), err): c0 > c1 or equal, err the exact decoded error."""
    rgb_f = rgb.to(torch.float32)
    proj = _pca_project(rgb)  # the seed's axis is also the cluster order
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
        e0, e1 = _least_squares_endpoints(rgb, codes)
        codes, best, best_err = take(*_quantize_endpoints(e0, e1), best,
                                     best_err)

    # +-1 code point per endpoint and channel around the converged pair.
    bc0, bc1 = best[0], best[1]
    for ch in range(3):
        for d in (-1, 1):
            _, best, best_err = take(_perturb_565(bc0, ch, d), bc1, best,
                                     best_err)
            _, best, best_err = take(bc0, _perturb_565(bc1, ch, d), best,
                                     best_err)

    # Each cluster-fit candidate, then one least-squares refit from the
    # codes it induces.
    for c0_k, c1_k in _cluster_fit_candidates(rgb, proj[2]):
        codes_k, best, best_err = take(c0_k, c1_k, best, best_err)
        e0, e1 = _least_squares_endpoints(rgb, codes_k)
        _, best, best_err = take(*_quantize_endpoints(e0, e1), best, best_err)

    # 4-colour mode needs c0 > c1: swap and remap 0<->1, 2<->3. Equal
    # endpoints decode one colour whatever the codes: all codes 0.
    c0, c1, codes = best
    swap = c0 < c1
    c0_f = torch.where(swap, c1, c0)
    c1_f = torch.where(swap, c0, c1)
    codes = torch.where(swap[:, None], codes ^ 1, codes)
    codes = torch.where((c0_f == c1_f)[:, None], 0, codes)
    return c0_f, c1_f, dxt._pack_rows(codes), best_err


def _assign_codes3(rgb_f, c0, c1):
    """Codes and error against the 3-colour palette [e0, e1, mid, black]
    (DecodeColors with c0 <= c1, dxtc_compressor.cc:183-191)."""
    pal = []
    for a, b in zip(_endpoint_channels(c0), _endpoint_channels(c1)):
        pal.append(torch.stack([a, b, cc.combine_int_fast(1, 1, a, b),
                                torch.zeros_like(a)], dim=-1))
    return _nearest(rgb_f, pal)


def _hq3_color_words(rgb, init_c0, init_c1):
    """The 3-colour-mode candidate (c0 <= c1), from the 4-colour result:
    two least-squares rounds. Returns ((N, 8) uint8 blocks, exact decoded
    error)."""
    rgb_f = rgb.to(torch.float32)
    codes, best_err = _assign_codes3(rgb_f, init_c0, init_c1)
    best = (init_c0, init_c1, codes)
    for _ in range(2):
        e0, e1 = _least_squares_endpoints(rgb, codes, _CODE3_U0, _CODE3_U1,
                                          scale=2)
        c0, c1 = _quantize_endpoints(e0, e1)
        codes, err = _assign_codes3(rgb_f, c0, c1)
        better = err < best_err
        best = (torch.where(better, c0, best[0]),
                torch.where(better, c1, best[1]),
                torch.where(better[:, None], codes, best[2]))
        best_err = torch.minimum(err, best_err)

    # 3-colour decode needs c0 <= c1: swap and remap 0<->1. With c0 == c1
    # the decoder maps code 3 to e1, not black, so every entry decodes to
    # e0 and the error is recomputed.
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
    """Exact decoded squared-RGB error of DXT1 fields, with DecodeColors'
    rules (dxtc_compressor.cc:167-192): equal endpoints, 3-colour mode."""
    equal = c0 == c1
    four = torch.ones_like(equal) if always4 else c0 > c1
    err = None
    for a, b, ch in zip(_endpoint_channels(c0), _endpoint_channels(c1),
                        range(3)):
        p2 = torch.where(equal, b, torch.where(
            four, cc.combine_int_fast(2, 1, a, b), cc.combine_int_fast(1, 1, a, b)))
        p3 = torch.where(equal, b, torch.where(
            four, cc.combine_int_fast(1, 2, a, b), torch.zeros_like(a)))
        val = torch.where(codes == 0, a[:, None], torch.where(
            codes == 1, b[:, None], torch.where(codes == 2, p2[:, None],
                                                p3[:, None])))
        d = val.to(torch.float32) - rgb_f[:, :, ch]
        err = d * d if err is None else err + d * d
    return err.sum(dim=1)


def _color_fields(block8: torch.Tensor):
    """(N, 8) DXT1 block bytes -> (c0, c1, codes (N, 16)) int32."""
    d = block8.to(torch.int32)
    c0 = d[:, 0] + d[:, 1] * 256
    c1 = d[:, 2] + d[:, 3] * 256
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=d.device)
    codes = ((d[:, 4:8, None] >> shifts) & 3).reshape(-1, 16)
    return c0, c1, codes


def _encode_dxt1_hq(rgb, ref):
    """(N, 16, 3) int32 RGB blocks and the reference encoder's (N, 8)
    uint8 blocks of them -> (N, 8) uint8 HQ blocks: the best of the
    4-colour search, the 3-colour candidate and the reference block by
    exact decoded error, ties to the later (the reference last)."""
    rgb_f = rgb.to(torch.float32)
    c0, c1, rows, err_hq = _hq_color_words(rgb)
    hq = dxt._dxt1_bytes(c0, c1, rows)
    hq3, err_hq3 = _hq3_color_words(rgb, c0, c1)
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
    """Nearest decode-ramp code per pixel and the exact block error."""
    ramp = dxt._alpha_ramp(a0, a1)
    d = a[:, :, None] - ramp[:, None, :]
    dd = d * d
    err = dd.amin(dim=2).sum(dim=1, dtype=torch.int32).to(torch.float32)
    return _argmin_first(dd, 2), err


def _alpha_ls(a, codes, interp: bool):
    """Least-squares alpha endpoints for fixed codes under one ramp scheme
    (integer-scaled exact solve; see _least_squares_endpoints), rounded."""
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
    rdet = _det_recip(torch.where(safe, det, 1).to(torch.float32))
    x0 = (s * (a11 * b0 - a01 * b1).to(torch.float32)) * rdet
    x1 = (s * (a00 * b1 - a01 * b0).to(torch.float32)) * rdet
    count = free.sum(dim=1, dtype=torch.int32).clamp(min=1)
    mean = dot(a, free).to(torch.float32) * _det_recip(count.to(torch.float32))
    x0 = torch.where(safe, x0, mean)
    x1 = torch.where(safe, x1, mean)
    r = lambda v: torch.round(v).clamp(0, 255).to(torch.int32)
    return r(x0), r(x1)


def _hq_alpha(a, ref_a0, ref_a1, ref_codes, ref_err):
    """HQ alpha endpoints: least-squares polish in both schemes from the
    extremes, explicit-scheme seeds from interior extremes (margins 16-64),
    shrunk-spread interpolated seeds, then a +-3 joint grid around the best
    so far, twice; every candidate scored exactly against its own decode
    ramp, strict '<' in this order, the reference encoding first.
    a: (N, 16) int32. Returns (a0, a1, codes)."""
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
            a0, a1 = _alpha_ls(a, codes, interp)
            # Keep the iterate in the intended scheme after rounding.
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
    c = (lo + hi).to(torch.float32) / 2.0
    r = (hi - lo).to(torch.float32) / 2.0
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


def _encode_dxt5_hq(rgba, ref):
    """(N, 16, 4) int32 RGBA blocks and the reference encoder's (N, 16)
    uint8 blocks of them -> (N, 16) uint8 HQ blocks: HQ colour (always
    4-colour decode) against the reference colour, ties to HQ; HQ alpha
    seeded with the reference alpha."""
    ref_i = ref.to(torch.int32)
    rgb = rgba[:, :, :3]
    c0, c1, rows, err_hq = _hq_color_words(rgb)
    hq = dxt._dxt1_bytes(c0, c1, rows)
    rc0, rc1, rcodes = _color_fields(ref[:, 8:16])
    err_ref = _block_error_from_words(rgb.to(torch.float32), rc0, rc1, rcodes,
                                      True)
    color = torch.where((err_hq <= err_ref)[:, None], hq, ref[:, 8:16])

    a = rgba[:, :, 3]
    ref_a0, ref_a1 = ref_i[:, 0], ref_i[:, 1]
    ref_codes = dxt._unpack_alpha_codes(ref_i[:, 2:8])
    ref_vals = torch.gather(dxt._alpha_ramp(ref_a0, ref_a1), 1, ref_codes.long())
    d = (ref_vals - a).to(torch.float32)
    ref_err = (d * d).sum(dim=-1)
    a0, a1, codes = _hq_alpha(a, ref_a0, ref_a1, ref_codes, ref_err)
    head = torch.stack([a0, a1], dim=-1)
    alpha = torch.cat([head, dxt._pack_alpha_codes(codes)], dim=-1)
    return torch.cat([alpha.to(torch.uint8), color], dim=-1)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


_BGRA = [2, 1, 0, 3]


def _row_image(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 16, C) blocks -> the (4, 4N, C) uint8 image holding them in one
    block row, block n at columns 4n..4n+3."""
    n, _, c = blocks.shape
    img = blocks.reshape(n, 4, 4, c).permute(1, 0, 2, 3).reshape(4, 4 * n, c)
    return img.to(torch.uint8).contiguous()


def encode_dxt1_hq_blocks(rgb: torch.Tensor,
                          swap_red_and_blue: bool = False) -> torch.Tensor:
    """(N, 16, 3) int blocks -> (N, 8) uint8 HQ DXT1 blocks. For BGR pass
    blocks already swapped to RGB plus ``swap_red_and_blue=True``: the
    reference candidate then repeats the const-colour double swap
    (dxtc_compressor.cc:360)."""
    rgb = rgb.to(torch.int32)
    n = rgb.shape[0]
    if n == 0:
        return torch.empty((0, 8), dtype=torch.uint8, device=rgb.device)
    src = rgb.flip(-1) if swap_red_and_blue else rgb
    ref = dxt_cuda.dxtc_encode_padded_image(_row_image(src), 4, 4 * n,
                                            swap_red_and_blue, True)
    return _encode_dxt1_hq(rgb, ref)


def encode_dxt5_hq_blocks(rgba: torch.Tensor, full_outside: torch.Tensor,
                          swap_red_and_blue: bool = False) -> torch.Tensor:
    """(N, 16, 4) int blocks and (N,) bool has_one_pixel flags -> (N, 16)
    uint8 HQ DXT5 blocks (BGRA: pre-swapped blocks plus the flag, as for
    :func:`encode_dxt1_hq_blocks`). A flagged block's reference alpha is
    its pixel 0 twice with zero codes (dxtc_compressor.cc:376-379)."""
    rgba = rgba.to(torch.int32)
    n = rgba.shape[0]
    if n == 0:
        return torch.empty((0, 16), dtype=torch.uint8, device=rgba.device)
    src = rgba[:, :, _BGRA] if swap_red_and_blue else rgba
    ref = dxt_cuda.dxtc_encode_padded_image(_row_image(src), 4, 4 * n,
                                            swap_red_and_blue, False)
    a00 = rgba[:, 0, 3].to(torch.uint8)
    one_pixel = torch.cat([a00[:, None], a00[:, None],
                           torch.zeros_like(ref[:, 2:8])], dim=1)
    ref = torch.cat([torch.where(full_outside[:, None], one_pixel, ref[:, :8]),
                     ref[:, 8:]], dim=1)
    return _encode_dxt5_hq(rgba, ref)


def _grid_blocks(image, grid_height, grid_width):
    h, w = image.shape[:2]
    gh = h if grid_height is None else grid_height
    gw = w if grid_width is None else grid_width
    return gh, gw, extract_blocks(image, height=h, width=w, grid_height=gh,
                                  grid_width=gw)


def encode_dxt1_hq_image(image: torch.Tensor, swap_red_and_blue: bool = False,
                         *, grid_height: int | None = None,
                         grid_width: int | None = None) -> torch.Tensor:
    """(h, w, 3|4) uint8 image -> (N, 8) uint8 HQ DXT1 blocks over the
    block grid (default the image; pixels beyond the image replicate its
    edge). For BGR pass the raw BGR image plus ``swap_red_and_blue=True``.
    The reference candidate is the DXT1 encode image op on the image's
    device."""
    gh, gw, blocks = _grid_blocks(image, grid_height, grid_width)
    rgb = blocks[:, :, :3]
    if swap_red_and_blue:
        rgb = rgb.flip(-1)
    ref = dxt_cuda.dxtc_encode_padded_image(image, gh, gw, swap_red_and_blue,
                                            True)
    return _encode_dxt1_hq(rgb, ref)


def encode_dxt5_hq_image(image: torch.Tensor, swap_red_and_blue: bool = False,
                         *, grid_height: int | None = None,
                         grid_width: int | None = None) -> torch.Tensor:
    """(h, w, 4) uint8 image -> (N, 16) uint8 HQ DXT5 blocks over the
    block grid; blocks wholly outside the image are has_one_pixel for the
    reference candidate. For BGRA pass the raw image plus
    ``swap_red_and_blue=True``."""
    gh, gw, rgba = _grid_blocks(image, grid_height, grid_width)
    if swap_red_and_blue:
        rgba = rgba[:, :, _BGRA]
    ref = dxt_cuda.dxtc_encode_padded_image(image, gh, gw, swap_red_and_blue,
                                            False)
    return _encode_dxt5_hq(rgba, ref)
