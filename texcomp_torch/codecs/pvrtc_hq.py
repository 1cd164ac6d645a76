"""High-quality PVRTC encoding (``quality="high"``, 2bpp and 4bpp) in
PyTorch.

The port of texcomp's HQ PVRTC encoder. The payload format stays
standard; the encoder search is alternating minimization:

  1. Seed the low-res A/B images from the reference's unquantized block
     extremes (2bpp: shrunk to half their spread around the mean).
  2. Alternate a per-pixel hard modulation choice by squared RGBA error
     against the bilinear-wrap upscaled A/B with an exact least-squares
     refit of all A/B texels, by conjugate gradients on the normal
     equations of the linear map (A, B) -> (1 - t) up(A) + t up(B).
  3. Quantize A/B with the format's channel reduction, choose the
     modulation with integer-exact decode errors and each 2bpp block's
     packing mode by its true reconstruction error.
  4. 2bpp only: refit A/B against the modulation the decoder will see
     under the chosen packing modes, twice.
  5. Best-of: whichever of {HQ, reference} payload decodes closer to the
     source, by exact int64 sums of the integer squared errors.

The bytes depend on float32 rounding, so every float step has one order
on every device:

  * each product and each add is its own eager op (no fused multiply-add,
    no ``torch.add(..., alpha=)``, no autograd, no compile);
  * the transpose of the upscale is written by hand, its group adds
    sequential;
  * every float sum over the image is :func:`_ordered_sum`, a halving tree
    of elementwise adds, and the 4-channel sums add c0 + c1 + c2 + c3;
  * every scalar of the CG stays a 0-d tensor on the image's device, so
    nothing waits on the device and a CPU tensor and a CUDA tensor give
    the same bits.

The integer steps (modulation and mode errors, below 2^24 as texcomp's
float32 values are) are int32. texcomp's own HQ bytes depend on XLA's
order of its large float sums on some images (at a side of 256 already);
there the port's bytes are texcomp's summed in the port's order, and
close to texcomp's decoded error.

The 2bpp reference arm is ``ops.pvrtc_cuda.pvrtc_encode_image``: the
three PVRTC kernels on a CUDA tensor, their plain twins on a CPU one. The
4bpp path runs no kernel, as in texcomp.
"""

from __future__ import annotations

import torch

from texcomp_torch.codecs import pvrtc as pv
from texcomp_torch.codecs import pvrtc4
from texcomp_torch.codecs.etc import _argmin_first
from texcomp_torch.ops import pvrtc_cuda
from texcomp_torch.utils.profiling import span

# Iteration counts as texcomp tuned them (4 outer alternations, 2
# packing-aware refits, 4 CG steps a refit).
_OUTER_ITERS = 4
_REFINE_CYCLES = 2
_CG_ITERS = 4
# Ridge anchoring texels whose bilinear support is all-mod-0/3, and the
# floor of the CG denominators, as the float32 values texcomp computes
# with.
_RIDGE = 0.009999999776482582  # float32(1e-2)
_TINY = 9.999999960041972e-13  # float32(1e-12)

# Blend weight of B for each modulation value (ApplyModulation,
# pvrtc_compressor.cc:120-144).
_T = (0.0, 3.0 / 8.0, 5.0 / 8.0, 1.0)


def _t_of(mod: torch.Tensor) -> torch.Tensor:
    """``_T[mod]`` as a float32 select chain."""
    t = torch.zeros(mod.shape, dtype=torch.float32, device=mod.device)
    for m in (1, 2, 3):
        t = torch.where(mod == m, _T[m], t)
    return t


def _shrunk_seed(lo: torch.Tensor, hi: torch.Tensor,
                 s: float = 0.5) -> torch.Tensor:
    """ALS seed: block mean -+ s * (spread / 2) instead of the raw extremes.
    Returns the A and B seeds stacked, (2, ..., 4) float32."""
    lo_f = lo.to(torch.float32)
    hi_f = hi.to(torch.float32)
    mean = (lo_f + hi_f) * 0.5
    half = (hi_f - lo_f) * 0.5
    return torch.stack([mean - s * half, mean + s * half])


def _make_upscale_f(h: int, w: int, block_h: int, block_w: int):
    """Float bilinear wrap upscale of (..., nby, nbx, C) low-res images to
    (..., h, w, C): the integer upscale's two separable passes
    (``pvrtc._upscale_axis``), then a true division."""
    def upscale_f(low: torch.Tensor) -> torch.Tensor:
        tmp = pv._upscale_axis(low, w, axis=-2, block=block_w)
        full = pv._upscale_axis(tmp, h, axis=-3, block=block_h)
        return full / float(block_w * block_h)
    return upscale_f


def _upscale_axis_t(g: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """Transpose of one ``pvrtc._upscale_axis`` pass along ``axis`` (< 0).
    The pass is (block - fw) roll(repeat(x), block/2) + fw roll(repeat(x),
    block/2 - block): weight each term, roll it back, add the two, then add
    each group of ``block`` entries, in order."""
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


def _make_upscale_t(block_h: int, block_w: int):
    """Transpose of :func:`_make_upscale_f`'s map: (..., h, w, C) ->
    (..., nby, nbx, C), its passes in reverse order."""
    def upscale_t(full: torch.Tensor) -> torch.Tensor:
        g = full / float(block_w * block_h)
        tmp = _upscale_axis_t(g, -3, block_h)
        return _upscale_axis_t(tmp, -2, block_w)
    return upscale_t


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Float sum over the last dim as a halving tree of elementwise adds
    (x = x[:n/2] + x[n/2:], zero-padded to a power of two): one order, so
    the same bits on every device."""
    n = x.shape[-1]
    size = 1 << (n - 1).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...): c0 + c1 + c2 + c3, in that order."""
    return x[..., 0] + x[..., 1] + x[..., 2] + x[..., 3]


def _tree_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> of two stacked (A, B) pairs: each leaf's ordered sum, then
    A's plus B's. A 0-d tensor."""
    leaves = _ordered_sum((x * y).flatten(1))
    return leaves[0] + leaves[1]


def _tree_axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """alpha * x + y as a multiply and then an add."""
    return alpha * x + y


def _solve_ab(img_f: torch.Tensor, t: torch.Tensor, ab0: torch.Tensor,
              upscale_f, upscale_t) -> torch.Tensor:
    """Least-squares refit of the stacked A/B texels for a fixed modulation
    blend t: (J^T J + ridge I) x = J^T img + ridge x0 by ``_CG_ITERS`` CG
    steps from x0, where J (A, B) = (1 - t) up(A) + t up(B). J is its own
    JVP (it is linear); J^T weights a residual by (1 - t, t) and applies
    the upscale's transpose."""
    tb = t[..., None]
    weights = torch.stack([1.0 - tb, tb])

    def fwd(ab):
        up = upscale_f(ab)
        return weights[0] * up[0] + weights[1] * up[1]

    def fwd_t(r):
        return upscale_t(weights * r)

    def apply_h(x):
        return _tree_axpy(_RIDGE, x, fwd_t(fwd(x)))

    b = _tree_axpy(_RIDGE, ab0, fwd_t(img_f))
    x = ab0
    r = _tree_axpy(-1.0, apply_h(x), b)
    p = r
    rs = _tree_dot(r, r)
    for _ in range(_CG_ITERS):
        hp = apply_h(p)
        alpha = rs / _tree_dot(p, hp).clamp_min(_TINY)
        x = _tree_axpy(alpha, p, x)
        r = _tree_axpy(-alpha, hp, r)
        rs_new = _tree_dot(r, r)
        p = _tree_axpy(rs_new / rs.clamp_min(_TINY), p, r)
        rs = rs_new
    return x


def _outer_step(img_f: torch.Tensor, ab: torch.Tensor, upscale_f,
                upscale_t) -> torch.Tensor:
    """One alternating-minimization step: hard per-pixel blend weight by
    squared error against the upscaled A/B, |d - t e|^2 - |d|^2 = t^2 |e|^2
    - 2 t (d.e) with d = img - up(A), e = up(B) - up(A), over the strict-<
    chain of ``_T[1:]`` (t = 0 scores 0); then the CG refit."""
    up = upscale_f(ab)
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
    return _solve_ab(img_f, best_t, ab, upscale_f, upscale_t)


def _mod_errors_int(img_i: torch.Tensor, a_up: torch.Tensor,
                    b_up: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) int32 squared-RGBA error of each of the 4 integer
    modulation candidates, as the decoder reconstructs them (at most
    4 * 255^2 a pixel)."""
    errs = []
    for m in range(4):
        d = img_i - pv._apply_modulation(a_up, b_up, m)
        errs.append((d * d).sum(-1, dtype=torch.int32))
    return torch.stack(errs, dim=-1)


def _mode_recons(mod: torch.Tensor, h: int, w: int) -> list:
    """The 4 per-pixel modulation images the decoder would see, one per
    packing mode: 1BPP thresholding, or checkerboard storage (the flag
    positions keep mod & 2) with the average-4, vertical or horizontal
    neighbour interpolation."""
    nby, nbx = h // pv.BLOCK_H, w // pv.BLOCK_W
    stored = pv._table("checker", mod.device).repeat(nby, nbx)
    flagged = pv._table("flagged_2bpp", mod.device).repeat(nby, nbx)
    sval = torch.where(flagged, mod & 2, mod)
    avg4, avg_v, avg_h = pv.modulation_neighbor_interps(sval)
    return [
        (mod >> 1) * 3,
        torch.where(stored, sval, avg4),
        torch.where(stored, sval, avg_v),
        torch.where(stored, sval, avg_h),
    ]


def _choose_block_modes(mod: torch.Tensor, err_m: torch.Tensor, h: int,
                        w: int) -> torch.Tensor:
    """Per-block packing mode (nby, nbx) int32: the first mode of least
    summed candidate error under its reconstructed modulation."""
    def pick(r):
        e = err_m[..., 0]
        for m in (1, 2, 3):
            e = torch.where(r == m, err_m[..., m], e)
        return e

    scores = torch.stack([pv._per_block_sum(pick(r))
                          for r in _mode_recons(mod, h, w)], dim=-1)
    return _argmin_first(scores, -1).to(torch.int32)


def _recon_mod(mod: torch.Tensor, modes: torch.Tensor, h: int,
               w: int) -> torch.Tensor:
    """The decoder-visible modulation image under the per-block modes."""
    recons = _mode_recons(mod, h, w)
    mode_px = modes.repeat_interleave(pv.BLOCK_H, 0).repeat_interleave(
        pv.BLOCK_W, 1)
    r = recons[0]
    for m in (1, 2, 3):
        r = torch.where(mode_px == m, recons[m], r)
    return r


def _quantize_ab(ab: torch.Tensor, img_i: torch.Tensor):
    """Round (half to even) and clip the stacked continuous A/B, then apply
    the format's channel reduction. A fully opaque source keeps an opaque
    palette (the 554/555 reduction needs alpha == 255 exactly), chosen on
    the device."""
    all_opaque = (img_i[..., 3] == 255).all()
    alpha = torch.where(all_opaque, 255.0, ab[..., 3])
    forced = torch.cat([ab[..., :3], alpha[..., None]], dim=-1)
    q = torch.round(forced).clamp(0, 255).to(torch.int32)
    return (pv._apply_color_channel_reduction(q[0], is_b=False),
            pv._apply_color_channel_reduction(q[1], is_b=True))


def _assign(img_i: torch.Tensor, a_q: torch.Tensor, b_q: torch.Tensor,
            h: int, w: int):
    """Final-form assignment: integer-exact candidate errors, per-pixel
    modulation (H, W) and per-block packing mode (nby, nbx), int32."""
    up = pv._interpolate_upscaled(torch.stack([a_q, b_q]), h, w)
    err_m = _mod_errors_int(img_i, up[0], up[1])
    mod = _argmin_first(err_m, -1).to(torch.int32)
    return mod, _choose_block_modes(mod, err_m, h, w)


def _encode_hq(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 -> (num_blocks, 8) uint8 PVRTC 2BPP records
    (Z-order), by alternating minimization."""
    h, w = image.shape[0], image.shape[1]
    nby, nbx = h // pv.BLOCK_H, w // pv.BLOCK_W
    img_i = image.to(torch.int32)
    img_f = image.to(torch.float32)

    upscale_f = _make_upscale_f(h, w, pv.BLOCK_H, pv.BLOCK_W)
    upscale_t = _make_upscale_t(pv.BLOCK_H, pv.BLOCK_W)
    with span("texcomp.pvrtc.hq.fit"):
        lo, hi = pv._morph_extremes(img_i)
        ab = _shrunk_seed(lo, hi)
        for _ in range(_OUTER_ITERS):
            ab = _outer_step(img_f, ab, upscale_f, upscale_t)

    # Packing-aware rounds: refit A/B against the modulation the decoder
    # will reconstruct under the chosen packing modes.
    with span("texcomp.pvrtc.hq.refine"):
        for _ in range(_REFINE_CYCLES):
            a_q, b_q = _quantize_ab(ab, img_i)
            mod, modes = _assign(img_i, a_q, b_q, h, w)
            t = _t_of(_recon_mod(mod, modes, h, w))
            ab = _solve_ab(img_f, t, ab, upscale_f, upscale_t)

    with span("texcomp.pvrtc.hq.assign"):
        a_q, b_q = _quantize_ab(ab, img_i)
        mod, modes = _assign(img_i, a_q, b_q, h, w)
        mod_words = pv._block_modulation_data(mod, modes).reshape(-1)
        color_words = pv._encode_colors(a_q, b_q, modes).reshape(-1)
        perm = pv._perm(nbx, nby, image.device)
        return pv._pack_records(mod_words[perm], color_words[perm])


def _sse(decoded: torch.Tensor, img_i: torch.Tensor) -> torch.Tensor:
    """Exact squared RGBA error of a decoded image, a 0-d int64 tensor."""
    d = decoded.to(torch.int32) - img_i
    return (d * d).sum(dtype=torch.int64)


def _best_of(image: torch.Tensor, hq: torch.Tensor, ref: torch.Tensor,
             decode) -> torch.Tensor:
    """Whichever of the ``hq`` and ``ref`` payloads ``decode`` (records, h,
    w) -> image brings closer to ``image``, HQ on a tie."""
    with span("texcomp.pvrtc.hq.choose"):
        h, w = image.shape[0], image.shape[1]
        img_i = image.to(torch.int32)
        sse_hq = _sse(decode(hq, h, w), img_i)
        sse_ref = _sse(decode(ref, h, w), img_i)
        return torch.where(sse_hq <= sse_ref, hq, ref)


def encode_pvrtc_2bpp_hq(image: torch.Tensor) -> torch.Tensor:
    """HQ PVRTC 2BPP encode of a (H, W, 4) uint8 square power-of-two image
    (side >= 8) -> (H*W/32, 8) uint8 Z-order records: whichever of {HQ,
    reference} decodes closer to the source, HQ on a tie."""
    with span("texcomp.pvrtc.hq.encode"):
        with span("texcomp.pvrtc.hq.reference"):
            ref = pvrtc_cuda.pvrtc_encode_image(image)
        return _best_of(image, _encode_hq(image), ref, pv.decode_pvrtc_2bpp)


def _encode_hq4(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 square power-of-two -> (NB, 8) uint8 4bpp records
    (Z-order), by the same alternating minimization; all 16 modulation
    values are stored, so there is no packing mode and no refit round."""
    h, w = image.shape[0], image.shape[1]
    nb = h // pvrtc4.BLOCK
    img_i = image.to(torch.int32)
    img_f = image.to(torch.float32)

    upscale_f = _make_upscale_f(h, w, pvrtc4.BLOCK, pvrtc4.BLOCK)
    upscale_t = _make_upscale_t(pvrtc4.BLOCK, pvrtc4.BLOCK)
    with span("texcomp.pvrtc.hq.fit"):
        # 4bpp keeps the raw-extremes seed, as texcomp does.
        lo, hi = pv._morph_extremes(img_i, pvrtc4.BLOCK, pvrtc4.BLOCK)
        ab = torch.stack([lo, hi]).to(torch.float32)
        for _ in range(_OUTER_ITERS):
            ab = _outer_step(img_f, ab, upscale_f, upscale_t)

    with span("texcomp.pvrtc.hq.assign"):
        a_q, b_q = _quantize_ab(ab, img_i)
        up = pv._interpolate_upscaled(torch.stack([a_q, b_q]), h, w,
                                      pvrtc4.BLOCK, pvrtc4.BLOCK)
        mod = _argmin_first(_mod_errors_int(img_i, up[0], up[1]), -1)

        # 2 bits a pixel, pixel (y, x) at bit 2 * (y * 4 + x); the color
        # word's mode flag 0, as pvrtc4 writes them.
        blocks = mod.to(torch.int32).reshape(nb, 4, nb, 4).transpose(1, 2)
        mod_words = pv._word_sum(
            blocks << pvrtc4._shifts(image.device)).reshape(-1)
        modes0 = torch.zeros((nb, nb), dtype=torch.int32, device=image.device)
        color_words = pv._encode_colors(a_q, b_q, modes0).reshape(-1)
        perm = pv._perm(nb, nb, image.device)
        return pv._pack_records(mod_words[perm], color_words[perm])


def encode_pvrtc_4bpp_hq(image: torch.Tensor) -> torch.Tensor:
    """HQ PVRTC 4BPP encode, never worse than ``pvrtc4.encode_pvrtc_4bpp``
    by decoded squared error (HQ on a tie)."""
    with span("texcomp.pvrtc.hq.encode"):
        with span("texcomp.pvrtc.hq.reference"):
            ref = pvrtc4.encode_pvrtc_4bpp(image)
        return _best_of(image, _encode_hq4(image), ref,
                        pvrtc4.decode_pvrtc_4bpp)
