"""PVRTC v1 2-bits-per-pixel RGBA encode, and its decode extension, in
plain PyTorch.

The reference's three passes (image_compression/internal/
pvrtc_compressor.cc:586-597) over (..., H, W, 4) int32 image tensors on any
device; every leading dimension is one more image, which wraps on its own:

  Morph    — per 8x4 block, two extreme colors along 5 candidate axes
             (lightness/R/G/B/A), bit-depth-reduced into low-res A/B images
             of 1/32 the pixel count (:255-329, :506-521)
  Modulate — per pixel, the best of 4 modulation weights against the
             bilinearly wrap-upscaled A/B images (:148-237, :527-540)
  Encode   — per block, a modulation mode, 32 modulation bits and 32 color
             bits, blocks emitted in Z-order (:395-496, :551-580)

torch has no uint32 arithmetic on the CPU, so a word is an int32 tensor
holding the 32-bit pattern (``texcomp_torch.core.bits``): the color word
sets bits 15 and 31, a packed pixel with alpha >= 128 is negative, and the
1bpp modulation word can set bit 31. Every right shift is masked to the
field it reads, and the sum of disjoint bit fields stands in for an OR
reduction (adding disjoint bits never carries).

The reference encodes only (pvrtc_compressor.cc:669-705);
``decode_pvrtc_2bpp`` is the extension's decode model (the bilinear
upscale + modulation reconstruction of pvrtc_compressor.h:20-55). This
module is the ground truth for the CUDA kernels in
``texcomp_torch/csrc/pvrtc.cu``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from texcomp_torch import native

# Block geometry for 2BPP (pvrtc_compressor.cc:47-50).
LOG2_BLOCK_W = 3
LOG2_BLOCK_H = 2
BLOCK_W = 1 << LOG2_BLOCK_W  # 8
BLOCK_H = 1 << LOG2_BLOCK_H  # 4

#: Bit 31 as an int32 value.
_BIT31 = -(1 << 31)


@lru_cache(maxsize=64)
def zorder_block_permutation(nbx: int, nby: int) -> np.ndarray:
    """perm[i] = row-major block index for Z-order output slot i
    (FromZOrder, pvrtc_compressor.cc:80-86), cached per grid size."""
    return native.zorder_perm(nbx, nby)


@lru_cache(maxsize=64)
def _perm(nbx: int, nby: int, device: torch.device) -> torch.Tensor:
    """:func:`zorder_block_permutation` as an int64 tensor on ``device``,
    copied there once per grid size: a later encode makes no host-to-device
    copy, so it never waits on the host."""
    return torch.from_numpy(zorder_block_permutation(nbx, nby)).to(
        device=device, dtype=torch.int64)


@lru_cache(maxsize=64)
def _inverse_perm(nbx: int, nby: int, device: torch.device) -> torch.Tensor:
    """The inverse of :func:`_perm`, cached on ``device`` as it is."""
    perm = zorder_block_permutation(nbx, nby)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return torch.from_numpy(inv).to(device=device, dtype=torch.int64)


def pack_words(rgba: torch.Tensor) -> torch.Tensor:
    """(..., 4) int32 channels 0..255 -> (...) int32 packed words
    r | g << 8 | b << 16 | a << 24 (bit patterns)."""
    r, g, b, a = rgba.to(torch.int32).unbind(-1)
    return r | (g << 8) | (b << 16) | (a << 24)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_words`: (...) int32 -> (..., 4) int32."""
    w = words.to(torch.int32)
    return torch.stack([(w >> (8 * c)) & 255 for c in range(4)], dim=-1)


def _apply_bit_depth_reduction(v, bit_depth: int):
    """encode to bit_depth bits then decode to 8 by bit replication
    (pvrtc_compressor.cc:93-106)."""
    mask = ((1 << bit_depth) - 1) << (8 - bit_depth)
    enc = v & mask
    out = enc | (enc >> bit_depth)
    if bit_depth <= 3:
        out = out | (enc >> (bit_depth * 2))
    return out


def _apply_color_channel_reduction(rgba: torch.Tensor, is_b: bool):
    """ApplyColorChannelReduction (pvrtc_compressor.cc:337-349): 554/555 for
    opaque, 3443/3444 for translucent. rgba: (..., 4) int32."""
    r, g, b, a = rgba.unbind(-1)
    opaque = a == 255
    r_o = _apply_bit_depth_reduction(r, 5)
    g_o = _apply_bit_depth_reduction(g, 5)
    b_o = _apply_bit_depth_reduction(b, 5 if is_b else 4)
    r_t = _apply_bit_depth_reduction(r, 4)
    g_t = _apply_bit_depth_reduction(g, 4)
    b_t = _apply_bit_depth_reduction(b, 4 if is_b else 3)
    a_t = _apply_bit_depth_reduction(a, 3)
    return torch.stack(
        [
            torch.where(opaque, r_o, r_t),
            torch.where(opaque, g_o, g_t),
            torch.where(opaque, b_o, b_t),
            torch.where(opaque, a, a_t),
        ],
        dim=-1,
    )


def _color_diff(c0, c1):
    """L1 color distance over 4 channels (pvrtc_compressor.cc:74-77)."""
    return (c0 - c1).abs().sum(-1, dtype=torch.int32)


def _morph_extremes(image: torch.Tensor, block_h: int = BLOCK_H,
                    block_w: int = BLOCK_W, origin: torch.Tensor | None = None):
    """Per-block extreme colors BEFORE bit-depth reduction
    (GetExtremesFast, pvrtc_compressor.cc:255-329).

    image: (..., H, W, 4) int32. origin: (..., 4) int32, each image's
    fallback pixel; None takes each image's own pixel (0, 0). Returns
    (lo, hi), each (..., nby, nbx, 4) int32. The block size is a parameter
    so that the 4bpp extension (4x4 blocks) shares it.
    """
    h, w = image.shape[-3], image.shape[-2]
    lead = image.shape[:-3]
    nby, nbx = h // block_h, w // block_w
    blocks = image.reshape(*lead, nby, block_h, nbx, block_w, 4)
    blocks = blocks.transpose(-4, -3).reshape(
        *lead, nby, nbx, block_h * block_w, 4)

    r, g, b, a = blocks.unbind(-1)
    lightness = (77 * r + 150 * g + 28 * b) >> 8  # // 256 of a nonneg sum
    axes = [lightness, r, g, b, a]  # 5 candidate pairs (:262-302)

    def pick(idx):  # (..., nby, nbx) -> the pixel (..., nby, nbx, 4)
        index = idx[..., None, None].expand(*idx.shape, 1, 4)
        return torch.gather(blocks, -2, index).squeeze(-2)

    # GetExtremesFast initializes best_index to 0 and updates max only on
    # strictly-greater (pvrtc_compressor.cc:266-301), so when an axis is 0
    # for every pixel of the block the "max" stays index 0 — the first pixel
    # of the WHOLE IMAGE, not of the block. Replicated: all-zero axis ->
    # the image's pixel (0, 0).
    if origin is None:
        origin = image[..., 0, 0, :]
    pixel00 = origin[..., None, None, :]  # (..., 1, 1, 4)

    mins = []
    maxs = []
    diffs = []
    for f in axes:
        lo = pick(f.argmin(-1))  # first occurrence == scan order
        hi = pick(f.argmax(-1))
        all_zero = f.amax(-1) == 0
        hi = torch.where(all_zero[..., None], pixel00, hi)
        mins.append(lo)
        maxs.append(hi)
        diffs.append(_color_diff(lo, hi))

    # Best pair: strictly-greater update -> first-occurrence argmax
    # (:308-316).
    best = torch.stack(diffs, dim=-1).argmax(-1)  # (..., nby, nbx)
    index = best[..., None, None].expand(*best.shape, 1, 4)
    c0 = torch.gather(torch.stack(mins, dim=-2), -2, index).squeeze(-2)
    c1 = torch.gather(torch.stack(maxs, dim=-2), -2, index).squeeze(-2)

    # Order by brightness r+g+b+a: swap if c1 darker (:321-328).
    swap = (c1.sum(-1) < c0.sum(-1))[..., None]
    return torch.where(swap, c1, c0), torch.where(swap, c0, c1)


def _morph(image: torch.Tensor, origin: torch.Tensor | None = None):
    """Per-block extreme colors -> reduced A/B images
    (Morph + GetExtremesFast, pvrtc_compressor.cc:255-329, :506-521).

    image: (..., H, W, 4) int32. Returns (A, B), each (..., nby, nbx, 4)
    int32.
    """
    lo, hi = _morph_extremes(image, origin=origin)
    return (
        _apply_color_channel_reduction(lo, is_b=False),
        _apply_color_channel_reduction(hi, is_b=True),
    )


def _upscale_axis(low: torch.Tensor, size: int, axis: int, block: int):
    """One separable pass of the bilinear wrap upscale: the weighted sum of
    the two wrap-neighbors along ``axis``, NOT yet divided. The
    reference's neighbor lookup ``low[((p - block/2) & (size-1)) >>
    log2(block)]`` (GetInterpolatedColor2BPP, pvrtc_compressor.cc:208-237)
    is a nearest-neighbor upsample followed by a wrap roll."""
    up = low.repeat_interleave(block, dim=axis)
    prev = up.roll(block // 2, dims=axis)
    nxt = up.roll(block // 2 - block, dims=axis)
    shape = [1] * low.dim()
    shape[axis] = size
    fw = ((torch.arange(size, device=low.device) + block // 2)
          & (block - 1)).reshape(shape).to(low.dtype)
    return (block - fw) * prev + fw * nxt


def _interpolate_upscaled(low: torch.Tensor, h: int, w: int,
                          block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                          halo=None):
    """Bilinear wrap-around upscale of low-res images to (h, w)
    (GetInterpolatedColor2BPP, pvrtc_compressor.cc:208-237).

    low: (..., nby, nbx, C) int32. Returns (..., h, w, C) int32. The
    two-pass integer sum equals the reference's 4-corner weighted sum, so
    the one final division is bit-exact.

    halo: None, or (top, bottom), each (..., nbx, C): the low-res rows
    above and below ``low`` when it is a strip of a taller image (the
    previous strip's last row, the next strip's first), which replace the
    y-wrap. The strip is upscaled with both rows on, whose own wrap then
    reaches none of its pixels, and cut back out."""
    if halo is None:
        tmp = _upscale_axis(low, w, axis=-2, block=block_w)
        full = _upscale_axis(tmp, h, axis=-3, block=block_h)
        return full // (block_w * block_h)
    top, bottom = halo
    tall = torch.cat([top.unsqueeze(-3), low, bottom.unsqueeze(-3)], dim=-3)
    up = _interpolate_upscaled(tall, h + 2 * block_h, w, block_h, block_w)
    return up[..., block_h:block_h + h, :, :]


def _apply_modulation(c0, c1, mod: int):
    """ApplyModulation (pvrtc_compressor.cc:120-144)."""
    if mod == 0:
        return c0
    if mod == 1:
        return (5 * c0 + 3 * c1) // 8
    if mod == 2:
        return (3 * c0 + 5 * c1) // 8
    return c1


def _modulate(image, imga_up, imgb_up):
    """Per-pixel best modulation with the reference's early-exit update rule
    (BestModulation, pvrtc_compressor.cc:148-166): stop at the first
    non-improving candidate. Returns (..., H, W) int32 in 0..3."""
    best_diff = _color_diff(image, imga_up)
    best = torch.zeros_like(best_diff)
    alive = torch.ones_like(best_diff, dtype=torch.bool)
    for mod in (1, 2, 3):
        diff = _color_diff(image, _apply_modulation(imga_up, imgb_up, mod))
        take = alive & (diff < best_diff)
        best = torch.where(take, mod, best)
        best_diff = torch.where(take, diff, best_diff)
        alive = take
    return best


def _per_block_sum(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., nby, nbx) int32 sums over each 8x4 block."""
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    return x.reshape(*lead, h // BLOCK_H, BLOCK_H, w // BLOCK_W,
                     BLOCK_W).sum(dim=(-3, -1), dtype=torch.int32)


def _block_modulation_modes(mod: torch.Tensor, halo_v=None):
    """Per-block modulation mode (CalculateBlockModulationMode,
    pvrtc_compressor.cc:395-447). mod: (..., H, W) int32. Returns
    (..., nby, nbx) int32 with 0=1BPP, 1=Average4, 2=Vertical,
    3=Horizontal.

    halo_v: None, or (..., W), the pixel row below the last one when
    ``mod`` is a strip of a taller image (the next strip's first row),
    which replaces the vertical wrap.

    Note the reference accumulates the vertical-neighbor deltas into
    ``horizontal_count`` and vice versa (:417-429); replicated as-is.
    """
    intermediate = _per_block_sum(((mod == 1) | (mod == 2)).to(torch.int32))
    if halo_v is None:
        below = mod.roll(-1, dims=-2)
    else:
        below = torch.cat([mod[..., 1:, :], halo_v.unsqueeze(-2)], dim=-2)
    dv = (mod - below).abs()  # vertical neighbor
    dh = (mod - mod.roll(-1, dims=-1)).abs()  # horizontal neighbor
    horizontal_count = _per_block_sum(dv)  # crossed, per the reference
    vertical_count = _per_block_sum(dh)

    vertical = (vertical_count > 10) & (vertical_count > horizontal_count * 2)
    horizontal = (horizontal_count > 10) & (
        horizontal_count > vertical_count * 2)
    mode = torch.where(vertical, 2, torch.where(horizontal, 3, 1))
    return torch.where(intermediate <= 4, 0, mode).to(torch.int32)


# Static per-pixel bit positions within a block, row-major (y, x).
_YY, _XX = np.mgrid[0:BLOCK_H, 0:BLOCK_W]
_BITPOS_1BPP = (_YY * 8 + _XX).astype(np.int32)
_CHECKER = ((_XX ^ _YY) & 1) == 0  # stored pixels in 2BPP modes
_BITPOS_2BPP = (2 * (_YY * 4 + _XX // 2)).astype(np.int32)
# Checkerboard positions whose low bit is stolen for the sub-mode flags
# (bitpos 0 and 20, pvrtc_compressor.cc:470-489): the decoder sees mod&2.
_FLAGGED_2BPP = ((_BITPOS_2BPP == 0) | (_BITPOS_2BPP == 20)) & _CHECKER


_TABLES = {
    "bitpos_1bpp": _BITPOS_1BPP,
    "bitpos_2bpp": _BITPOS_2BPP,
    "checker": _CHECKER,
    "flagged_2bpp": _FLAGGED_2BPP,
    "at0": (_BITPOS_2BPP == 0) & _CHECKER,
    "at20": (_BITPOS_2BPP == 20) & _CHECKER,
}


@lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """The per-block table ``_TABLES[name]`` on ``device``, copied there
    once (as :func:`_perm`)."""
    return torch.from_numpy(np.ascontiguousarray(_TABLES[name])).to(device)


def _word_sum(x: torch.Tensor) -> torch.Tensor:
    """OR of disjoint int32 bit fields over the last two dims, as their
    sum (exactly one term at most holds bit 31)."""
    return x.sum(dim=(-2, -1)).to(torch.int32)


def _blocks_of(mod: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., nby, nbx, 4, 8) per-block pixel tiles."""
    h, w = mod.shape[-2:]
    lead = mod.shape[:-2]
    return mod.reshape(*lead, h // BLOCK_H, BLOCK_H, w // BLOCK_W,
                       BLOCK_W).transpose(-3, -2)


def modulation_neighbor_interps(sval):
    """The decoder's three checkerboard interpolations of a stored
    modulation image (image-wrapped neighbors): (average-4, vertical,
    horizontal)."""
    up = sval.roll(1, dims=-2)
    down = sval.roll(-1, dims=-2)
    left = sval.roll(1, dims=-1)
    right = sval.roll(-1, dims=-1)
    return ((up + down + left + right + 2) // 4,
            (up + down + 1) // 2,
            (left + right + 1) // 2)


def _block_modulation_data(mod, modes):
    """Pack 32 modulation bits per block (CalculateBlockModulationData,
    pvrtc_compressor.cc:456-496). mod: (..., H, W) int32, modes:
    (..., nby, nbx). Returns (..., nby, nbx) int32 bit patterns."""
    dev = mod.device
    m = _blocks_of(mod).to(torch.int32)

    # 1BPP: bit per pixel = mod/2 at bitpos y*8+x.
    word_1bpp = _word_sum((m >> 1) << _table("bitpos_1bpp", dev))

    # 2BPP checkerboard: 2 bits per stored pixel; sub-mode flags steal a bit
    # at bitpos 0 (average4 vs other) and bitpos 20 (vertical vs horizontal).
    modes_b = modes[..., None, None]
    at0 = _table("at0", dev)
    at20 = _table("at20", dev)
    # bitpos 0: average4 -> bit &= 2, else bit |= 1 (:476-481)
    bits = torch.where(at0, torch.where(modes_b == 1, m & 2, m | 1), m)
    # bitpos 20: vertical -> bit |= 1, else bit &= 2 (:482-488)
    bits = torch.where(at20, torch.where(modes_b == 2, bits | 1, bits & 2),
                       bits)
    bit2 = torch.where(_table("checker", dev),
                       bits << _table("bitpos_2bpp", dev), 0)
    word_2bpp = _word_sum(bit2)
    return torch.where(modes == 0, word_1bpp, word_2bpp)


def _encode_colors(a, b, modes):
    """Pack the two block colors + mode flag into 32 bits (EncodeColors,
    pvrtc_compressor.cc:356-388). a, b: (..., 4) int32 (already
    bit-depth-reduced). Returns (...) int32 bit patterns."""
    ar, ag, ab, aa = a.to(torch.int32).unbind(-1)
    br, bg, bb, ba = b.to(torch.int32).unbind(-1)

    a_bits_o = (1 << 15) | ((ab >> 4) << 1) | ((ag >> 3) << 5) | (
        (ar >> 3) << 10)
    a_bits_t = ((ab >> 5) << 1) | ((ag >> 4) << 4) | ((ar >> 4) << 8) | (
        (aa >> 5) << 12)
    b_bits_o = _BIT31 | ((bb >> 3) << 16) | ((bg >> 3) << 21) | (
        (br >> 3) << 26)
    b_bits_t = ((bb >> 4) << 16) | ((bg >> 4) << 20) | ((br >> 4) << 24) | (
        (ba >> 5) << 28)
    value = torch.where(aa == 255, a_bits_o, a_bits_t) | torch.where(
        ba == 255, b_bits_o, b_bits_t)
    return value | (modes != 0).to(torch.int32)


def _pack_records(mod_words: torch.Tensor,
                  color_words: torch.Tensor) -> torch.Tensor:
    """(..., N) int32 mod/color words -> (..., N, 8) uint8 LE block records
    (Append32, pvrtc_compressor.cc:59-65)."""
    parts = [(w >> s) & 0xFF for w in (mod_words, color_words)
             for s in (0, 8, 16, 24)]
    return torch.stack(parts, dim=-1).to(torch.uint8)


def encode_pvrtc_2bpp(image: torch.Tensor) -> torch.Tensor:
    """Full PVRTC 2BPP encode: (..., H, W, 4) uint8 -> (..., num_blocks, 8)
    uint8 block records in Z-order file layout (mod word LE, color word LE;
    Append32 + the Z-order loop, pvrtc_compressor.cc:59-65, :551-580).

    H, W must be equal powers of two (validated by the caller).
    """
    h, w = image.shape[-3], image.shape[-2]
    nby, nbx = h // BLOCK_H, w // BLOCK_W
    img = image.to(torch.int32)

    a, b = _morph(img)
    a_up = _interpolate_upscaled(a, h, w)
    b_up = _interpolate_upscaled(b, h, w)
    mod = _modulate(img, a_up, b_up)

    modes = _block_modulation_modes(mod)
    mod_words = _block_modulation_data(mod, modes).flatten(-2)
    color_words = _encode_colors(a, b, modes).flatten(-2)

    perm = _perm(nbx, nby, image.device)
    return _pack_records(mod_words[..., perm], color_words[..., perm])


# ---------------------------------------------------------------------------
# Decode (extension — the reference cannot decode PVRTC).
# ---------------------------------------------------------------------------


def records_to_words(data: torch.Tensor):
    """(N, 8) uint8 LE records -> (mod words, color words), (N,) int32."""
    d = data.to(torch.int32)
    mod_words = d[:, 0] | (d[:, 1] << 8) | (d[:, 2] << 16) | (d[:, 3] << 24)
    color_words = d[:, 4] | (d[:, 5] << 8) | (d[:, 6] << 16) | (d[:, 7] << 24)
    return mod_words, color_words


def unpermute_zorder(words: torch.Tensor, nbx: int, nby: int) -> torch.Tensor:
    """(N,) words in Z-order slots -> (nby, nbx) in row-major block order."""
    return words[_inverse_perm(nbx, nby, words.device)].reshape(nby, nbx)


def _decode_color(word: torch.Tensor, is_b: bool):
    """Inverse of EncodeColors for one palette color; reconstructs 8-bit
    channels with the same bit-replication rules the hardware uses."""
    w = word.to(torch.int32)
    if is_b:
        opaque = (w >> 31) & 1
        r_o = _apply_bit_depth_reduction(((w >> 26) & 31) << 3, 5)
        g_o = _apply_bit_depth_reduction(((w >> 21) & 31) << 3, 5)
        b_o = _apply_bit_depth_reduction(((w >> 16) & 31) << 3, 5)
        r_t = _apply_bit_depth_reduction(((w >> 24) & 15) << 4, 4)
        g_t = _apply_bit_depth_reduction(((w >> 20) & 15) << 4, 4)
        b_t = _apply_bit_depth_reduction(((w >> 16) & 15) << 4, 4)
        a_t = _apply_bit_depth_reduction(((w >> 28) & 7) << 5, 3)
    else:
        opaque = (w >> 15) & 1
        r_o = _apply_bit_depth_reduction(((w >> 10) & 31) << 3, 5)
        g_o = _apply_bit_depth_reduction(((w >> 5) & 31) << 3, 5)
        b_o = _apply_bit_depth_reduction(((w >> 1) & 15) << 4, 4)
        r_t = _apply_bit_depth_reduction(((w >> 8) & 15) << 4, 4)
        g_t = _apply_bit_depth_reduction(((w >> 4) & 15) << 4, 4)
        b_t = _apply_bit_depth_reduction(((w >> 1) & 7) << 5, 3)
        a_t = _apply_bit_depth_reduction(((w >> 12) & 7) << 5, 3)
    opq = opaque == 1
    return torch.stack(
        [
            torch.where(opq, r_o, r_t),
            torch.where(opq, g_o, g_t),
            torch.where(opq, b_o, b_t),
            torch.where(opq, 255, a_t),
        ],
        dim=-1,
    )


def decode_pvrtc_2bpp(data: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """Decode PVRTC 2BPP records back to (H, W, 4) uint8 (extension).

    The documented reconstruction (pvrtc_compressor.h:20-55): bilinear wrap
    upscale of the A/B palette images, then per-pixel modulation.
    Checkerboard sub-modes interpolate the missing pixels from their
    neighbors; the 1BPP mode maps bit 0 -> mod 0, bit 1 -> mod 3. As in
    texcomp's decode extension, a block counts as 2BPP when bit 0 of its
    MODULATION word is set (the encoder's mode flag is bit 0 of the color
    word), which is what the self-pinned digests record.
    """
    h, w = height, width
    nby, nbx = h // BLOCK_H, w // BLOCK_W
    dev = data.device
    mod_words, color_words = records_to_words(data)
    mod_words = unpermute_zorder(mod_words, nbx, nby)
    color_words = unpermute_zorder(color_words, nbx, nby)

    a = _decode_color(color_words, is_b=False)
    b = _decode_color(color_words, is_b=True)
    a_up = _interpolate_upscaled(a, h, w)
    b_up = _interpolate_upscaled(b, h, w)

    is_2bpp = (mod_words & 1) == 1

    # Extract raw per-pixel bits.
    mw = mod_words[:, :, None, None]
    mod_1bpp = ((mw >> _table("bitpos_1bpp", dev)) & 1) * 3  # bit set -> color1
    bits2 = (mw >> _table("bitpos_2bpp", dev)) & 3
    # Sub-mode flags (stored at bitpos 0 and 20).
    submode_other = mod_words & 1  # 1 -> vertical/horizontal
    submode_vert = (mod_words >> 20) & 1  # 1 -> vertical
    # Flag-carrying positions lose their low bit: value is bit&2 -> {0, 2}.
    bits2 = torch.where(_table("flagged_2bpp", dev), bits2 & 2, bits2)

    mod_blocks = torch.where(is_2bpp[:, :, None, None], bits2, mod_1bpp)
    mod_img = mod_blocks.transpose(1, 2).reshape(h, w)

    # Interpolate modulation for non-stored checkerboard pixels.
    stored = _table("checker", dev).repeat(nby, nbx)
    avg4, avg_v, avg_h = modulation_neighbor_interps(mod_img)

    def per_pixel(x):
        return x.repeat_interleave(BLOCK_H, 0).repeat_interleave(BLOCK_W, 1)

    interp = torch.where(per_pixel(submode_other == 1),
                         torch.where(per_pixel(submode_vert == 1), avg_v, avg_h),
                         avg4)
    mod_full = torch.where(per_pixel(is_2bpp) & ~stored, interp, mod_img)

    # Apply modulation.
    out = torch.zeros((h, w, 4), dtype=torch.int32, device=dev)
    for m in range(4):
        cand = _apply_modulation(a_up, b_up, m)
        out = torch.where((mod_full == m)[..., None], cand, out)
    return out.clamp(0, 255).to(torch.uint8)
