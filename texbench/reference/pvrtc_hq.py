"""HQ PVRTC 2bpp and 4bpp of a square power-of-two RGBA image,
``quality="high"`` (copied from ``texcomp_torch/codecs/pvrtc_hq.py`` and
the 2bpp decode of ``texcomp_torch/codecs/pvrtc.py``): seed the low-res
A/B images from the block extremes (2bpp: shrunk to half their spread);
alternate a per-pixel hard modulation choice with a least-squares refit
of A/B by conjugate gradients; quantize, choose the modulation (2bpp: and
the packing modes) by exact integer errors; 2bpp only: refit twice
against the modulation the decoder will see; keep whichever of {HQ, the
reference encode} decodes closer to the source.

Every float step has one order (each product and add its own op, the
upscale's transpose by hand, every sum over the image a halving tree), so
the bytes do not depend on the device. The fit is float32 in the port;
``fdt`` sets its float type here, so that the benchmark's control can run
the same encoder one precision lower (bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from texbench.reference import pvrtc as pv
from texbench.reference import pvrtc4 as pv4
from texbench.reference.etc import _argmin_first

_OUTER_ITERS = 4
_REFINE_CYCLES = 2
_CG_ITERS = 4
_RIDGE = 0.009999999776482582  # float32(1e-2)
_TINY = 9.999999960041972e-13  # float32(1e-12)
# Blend weight of B for each modulation value (ApplyModulation,
# pvrtc_compressor.cc:120-144).
_T = (0.0, 3.0 / 8.0, 5.0 / 8.0, 1.0)

_FLAGGED = pv._AT0 | pv._AT20


def _table(t: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def _perm(nbx: int, nby: int, device) -> torch.Tensor:
    return torch.from_numpy(pv.zorder_permutation(nbx, nby)).to(device)


def _apply_modulation(c0, c1, mod: int):
    if mod == 0:
        return c0
    if mod == 1:
        return (5 * c0 + 3 * c1) // 8
    if mod == 2:
        return (3 * c0 + 5 * c1) // 8
    return c1


def modulation_neighbor_interps(sval):
    """The decoder's checkerboard interpolations (average-4, vertical,
    horizontal) of a stored modulation image, wrapped."""
    up = sval.roll(1, dims=-2)
    down = sval.roll(-1, dims=-2)
    left = sval.roll(1, dims=-1)
    right = sval.roll(-1, dims=-1)
    return ((up + down + left + right + 2) // 4,
            (up + down + 1) // 2,
            (left + right + 1) // 2)


# ---------------------------------------------------------------------------
# Decode (the extension's model: pvrtc_compressor.h:20-55).
# ---------------------------------------------------------------------------


def decode_pvrtc_2bpp(data: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 8) uint8 Z-order records -> (h, w, 4) uint8: bilinear wrap
    upscale of A/B, per-pixel modulation; a block is 2bpp where bit 0 of
    its modulation word is set, its missing checkerboard pixels
    interpolated by the sub-mode flags at bits 0 and 20."""
    nby, nbx = h // pv.BLOCK_H, w // pv.BLOCK_W
    dev = data.device
    mod_words, color_words = pv.unpack_records(data, nbx, nby)
    a_up = pv.upscale(pv.decode_color(color_words, False), h, w)
    b_up = pv.upscale(pv.decode_color(color_words, True), h, w)

    is_2bpp = (mod_words & 1) == 1
    mw = mod_words[:, :, None, None]
    mod_1bpp = ((mw >> _table(pv._BITPOS_1BPP, dev)) & 1) * 3
    bits2 = (mw >> _table(pv._BITPOS_2BPP, dev)) & 3
    submode_other = mod_words & 1
    submode_vert = (mod_words >> 20) & 1
    bits2 = torch.where(_table(_FLAGGED, dev), bits2 & 2, bits2)
    mod_blocks = torch.where(is_2bpp[:, :, None, None], bits2, mod_1bpp)
    mod_img = mod_blocks.transpose(1, 2).reshape(h, w)

    stored = _table(pv._CHECKER, dev).repeat(nby, nbx)
    avg4, avg_v, avg_h = modulation_neighbor_interps(mod_img)

    def per_pixel(x):
        return x.repeat_interleave(pv.BLOCK_H, 0).repeat_interleave(
            pv.BLOCK_W, 1)

    interp = torch.where(per_pixel(submode_other == 1),
                         torch.where(per_pixel(submode_vert == 1), avg_v,
                                     avg_h), avg4)
    mod_full = torch.where(per_pixel(is_2bpp) & ~stored, interp, mod_img)
    out = torch.zeros((h, w, 4), dtype=torch.int32, device=dev)
    for m in range(4):
        out = torch.where((mod_full == m)[..., None],
                          _apply_modulation(a_up, b_up, m), out)
    return out.clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# The alternating fit.
# ---------------------------------------------------------------------------


def _t_of(mod: torch.Tensor, fdt) -> torch.Tensor:
    t = torch.zeros(mod.shape, dtype=fdt, device=mod.device)
    for m in (1, 2, 3):
        t = torch.where(mod == m, _T[m], t)
    return t


def _shrunk_seed(lo: torch.Tensor, hi: torch.Tensor,
                 s: float = 0.5) -> torch.Tensor:
    lo_f = lo.to(torch.float32)
    hi_f = hi.to(torch.float32)
    mean = (lo_f + hi_f) * 0.5
    half = (hi_f - lo_f) * 0.5
    return torch.stack([mean - s * half, mean + s * half])


def _upscale_f(low: torch.Tensor, grid: tuple) -> torch.Tensor:
    """Float bilinear wrap upscale to ``grid`` = (h, w, block_h, block_w):
    the integer passes, a true division."""
    h, w, bh, bw = grid
    tmp = pv._upscale_axis(low, w, axis=-2, block=bw)
    full = pv._upscale_axis(tmp, h, axis=-3, block=bh)
    return full / float(bw * bh)


def _upscale_axis_t(g: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """Transpose of one upscale pass along ``axis`` (< 0): weight each
    term, roll it back, add the two, then add each group of ``block``
    entries in order."""
    size = g.shape[axis]
    shape = [1] * g.dim()
    shape[axis] = size
    fw = ((torch.arange(size, device=g.device) + block // 2)
          & (block - 1)).reshape(shape).to(g.dtype)
    half = block // 2
    up = (g * (block - fw)).roll(-half, dims=axis) + (g * fw).roll(
        block - half, dims=axis)
    groups = up.unflatten(axis, (size // block, block))
    out = groups.select(axis, 0)
    for k in range(1, block):
        out = out + groups.select(axis, k)
    return out


def _upscale_t(full: torch.Tensor, grid: tuple) -> torch.Tensor:
    _, _, bh, bw = grid
    g = full / float(bw * bh)
    tmp = _upscale_axis_t(g, -3, bh)
    return _upscale_axis_t(tmp, -2, bw)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim as a halving tree, zero-padded to a power of
    two."""
    n = x.shape[-1]
    size = 1 << (n - 1).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] + x[..., 1] + x[..., 2] + x[..., 3]


def _tree_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    leaves = _ordered_sum((x * y).flatten(1))
    return leaves[0] + leaves[1]


def _axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return alpha * x + y


def _solve_ab(img_f, t, ab0, grid: tuple) -> torch.Tensor:
    """(J^T J + ridge I) x = J^T img + ridge x0 by ``_CG_ITERS`` CG steps
    from x0, J (A, B) = (1 - t) up(A) + t up(B)."""
    tb = t[..., None]
    weights = torch.stack([1.0 - tb, tb])

    def fwd(ab):
        up = _upscale_f(ab, grid)
        return weights[0] * up[0] + weights[1] * up[1]

    def apply_h(x):
        return _axpy(_RIDGE, x, _upscale_t(weights * fwd(x), grid))

    b = _axpy(_RIDGE, ab0, _upscale_t(weights * img_f, grid))
    x = ab0
    r = _axpy(-1.0, apply_h(x), b)
    p = r
    rs = _tree_dot(r, r)
    for _ in range(_CG_ITERS):
        hp = apply_h(p)
        alpha = rs / _tree_dot(p, hp).clamp_min(_TINY)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, hp, r)
        rs_new = _tree_dot(r, r)
        p = _axpy(rs_new / rs.clamp_min(_TINY), p, r)
        rs = rs_new
    return x


def _outer_step(img_f, ab, grid: tuple) -> torch.Tensor:
    """Hard per-pixel blend weight by squared error against the upscaled
    A/B (strict '<' over ``_T[1:]``, t = 0 scoring 0), then the refit."""
    up = _upscale_f(ab, grid)
    d = img_f - up[0]
    e = up[1] - up[0]
    s = _channel_sum(d * e)
    q = _channel_sum(e * e)
    best_t = torch.zeros_like(s)
    best_e = torch.zeros_like(s)
    for tv in _T[1:]:
        cand = (tv * tv) * q - (2.0 * tv) * s
        better = cand < best_e
        best_t = torch.where(better, tv, best_t)
        best_e = torch.where(better, cand, best_e)
    return _solve_ab(img_f, best_t, ab, grid)


def _mod_errors_int(img_i, a_up, b_up) -> torch.Tensor:
    errs = []
    for m in range(4):
        d = img_i - _apply_modulation(a_up, b_up, m)
        errs.append((d * d).sum(-1, dtype=torch.int32))
    return torch.stack(errs, dim=-1)


def _mode_recons(mod: torch.Tensor, h: int, w: int) -> list:
    """The modulation image the decoder would see under each packing mode:
    1bpp thresholding, or checkerboard storage with the average-4,
    vertical or horizontal interpolation."""
    nby, nbx = h // pv.BLOCK_H, w // pv.BLOCK_W
    stored = _table(pv._CHECKER, mod.device).repeat(nby, nbx)
    flagged = _table(_FLAGGED, mod.device).repeat(nby, nbx)
    sval = torch.where(flagged, mod & 2, mod)
    avg4, avg_v, avg_h = modulation_neighbor_interps(sval)
    return [(mod >> 1) * 3,
            torch.where(stored, sval, avg4),
            torch.where(stored, sval, avg_v),
            torch.where(stored, sval, avg_h)]


def _choose_block_modes(mod, err_m, h: int, w: int) -> torch.Tensor:
    def pick(r):
        e = err_m[..., 0]
        for m in (1, 2, 3):
            e = torch.where(r == m, err_m[..., m], e)
        return e

    scores = torch.stack([pv._per_block_sum(pick(r))
                          for r in _mode_recons(mod, h, w)], dim=-1)
    return _argmin_first(scores, -1).to(torch.int32)


def _recon_mod(mod, modes, h: int, w: int) -> torch.Tensor:
    recons = _mode_recons(mod, h, w)
    mode_px = modes.repeat_interleave(pv.BLOCK_H, 0).repeat_interleave(
        pv.BLOCK_W, 1)
    r = recons[0]
    for m in (1, 2, 3):
        r = torch.where(mode_px == m, recons[m], r)
    return r


def _quantize_ab(ab: torch.Tensor, img_i: torch.Tensor):
    """Round and clip the continuous A/B, then the channel reduction; a
    fully opaque source keeps an opaque palette."""
    all_opaque = (img_i[..., 3] == 255).all()
    alpha = torch.where(all_opaque, 255.0, ab[..., 3])
    forced = torch.cat([ab[..., :3], alpha[..., None]], dim=-1)
    q = torch.round(forced).clamp(0, 255).to(torch.int32)
    return (pv._channel_reduction(q[0], is_b=False),
            pv._channel_reduction(q[1], is_b=True))


def _assign(img_i, a_q, b_q, h: int, w: int):
    up = pv.upscale(torch.stack([a_q, b_q]), h, w)
    err_m = _mod_errors_int(img_i, up[0], up[1])
    mod = _argmin_first(err_m, -1).to(torch.int32)
    return mod, _choose_block_modes(mod, err_m, h, w)


def _encode_hq(image: torch.Tensor, fdt) -> torch.Tensor:
    h, w = image.shape[0], image.shape[1]
    nby, nbx = h // pv.BLOCK_H, w // pv.BLOCK_W
    grid = (h, w, pv.BLOCK_H, pv.BLOCK_W)
    img_i = image.to(torch.int32)
    img_f = image.to(fdt)

    lo, hi = pv.morph_extremes(img_i)
    ab = _shrunk_seed(lo, hi).to(fdt)
    for _ in range(_OUTER_ITERS):
        ab = _outer_step(img_f, ab, grid)
    for _ in range(_REFINE_CYCLES):
        a_q, b_q = _quantize_ab(ab, img_i)
        mod, modes = _assign(img_i, a_q, b_q, h, w)
        ab = _solve_ab(img_f, _t_of(_recon_mod(mod, modes, h, w), fdt), ab,
                       grid)

    a_q, b_q = _quantize_ab(ab, img_i)
    mod, modes = _assign(img_i, a_q, b_q, h, w)
    perm = _perm(nbx, nby, image.device)
    return pv.pack_records(pv._modulation_words(mod, modes).reshape(-1)[perm],
                           pv._color_words(a_q, b_q, modes).reshape(-1)[perm])


def _sse(decoded: torch.Tensor, img_i: torch.Tensor) -> torch.Tensor:
    d = decoded.to(torch.int32) - img_i
    return (d * d).sum(dtype=torch.int64)


def encode_pvrtc_2bpp_hq(image: torch.Tensor,
                         fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 4) uint8, H == W a power of two >= 8 -> (H W / 32, 8) uint8
    Z-order records: whichever of {HQ, reference} decodes closer to the
    source, HQ on a tie."""
    h, w = image.shape[0], image.shape[1]
    ref = pv.encode_pvrtc_2bpp(image)
    hq = _encode_hq(image, fdt)
    img_i = image.to(torch.int32)
    sse_hq = _sse(decode_pvrtc_2bpp(hq, h, w), img_i)
    sse_ref = _sse(decode_pvrtc_2bpp(ref, h, w), img_i)
    return torch.where(sse_hq <= sse_ref, hq, ref)


def _encode_hq4(image: torch.Tensor, fdt) -> torch.Tensor:
    """The same alternating fit on 4x4 blocks from the raw extremes; all 16
    modulation values are stored, so there is no packing mode and no
    refit round."""
    h, w = image.shape[0], image.shape[1]
    grid = (h, w, pv4.BLOCK, pv4.BLOCK)
    img_i = image.to(torch.int32)
    img_f = image.to(fdt)

    lo, hi = pv.morph_extremes(img_i, pv4.BLOCK, pv4.BLOCK)
    ab = torch.stack([lo, hi]).to(fdt)
    for _ in range(_OUTER_ITERS):
        ab = _outer_step(img_f, ab, grid)

    a_q, b_q = _quantize_ab(ab, img_i)
    up = pv.upscale(torch.stack([a_q, b_q]), h, w, pv4.BLOCK, pv4.BLOCK)
    mod = _argmin_first(_mod_errors_int(img_i, up[0], up[1]), -1)
    return pv4.pack(mod.to(torch.int32), a_q, b_q)


def encode_pvrtc_4bpp_hq(image: torch.Tensor,
                         fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 4) uint8, H == W a power of two >= 4 -> (H W / 16, 8) uint8
    Z-order 4bpp records: whichever of {HQ, the 4bpp encode} decodes
    closer to the source, HQ on a tie."""
    h, w = image.shape[0], image.shape[1]
    ref = pv4.encode_pvrtc_4bpp(image)
    hq = _encode_hq4(image, fdt)
    img_i = image.to(torch.int32)
    sse_hq = _sse(pv4.decode_pvrtc_4bpp(hq, h, w), img_i)
    sse_ref = _sse(pv4.decode_pvrtc_4bpp(ref, h, w), img_i)
    return torch.where(sse_hq <= sse_ref, hq, ref)
