"""PVRTC v1 2bpp encode of a square power-of-two RGBA image (copied from
``texcomp_torch/codecs/pvrtc.py``; pvrtc_compressor.cc:586-597): morph
into low-res A/B images, per-pixel modulation against their bilinear wrap
upscale, per-block modes, 8-byte records in Z-order. Words are int32
tensors holding 32-bit patterns; each image falls back to its own pixel
(0, 0) where an extreme axis is all zero."""

from __future__ import annotations

import numpy as np
import torch

BLOCK_W, BLOCK_H = 8, 4
_BIT31 = -(1 << 31)


def zorder_permutation(nbx: int, nby: int) -> np.ndarray:
    """perm[i] = row-major block index of Z-order slot i (FromZOrder,
    pvrtc_compressor.cc:80-86): x takes the odd bits of i, y the even."""
    i = np.arange(nbx * nby, dtype=np.uint64)
    x = np.zeros_like(i)
    y = np.zeros_like(i)
    for j in range(16):
        x |= ((i >> np.uint64(2 * j + 1)) & np.uint64(1)) << np.uint64(j)
        y |= ((i >> np.uint64(2 * j)) & np.uint64(1)) << np.uint64(j)
    return (y * nbx + x).astype(np.int64)


def _bit_depth(v, bits: int):
    mask = ((1 << bits) - 1) << (8 - bits)
    enc = v & mask
    out = enc | (enc >> bits)
    if bits <= 3:
        out = out | (enc >> (bits * 2))
    return out


def _channel_reduction(rgba: torch.Tensor, is_b: bool):
    """554/555 for opaque, 3443/3444 for translucent (:337-349)."""
    r, g, b, a = rgba.unbind(-1)
    opaque = a == 255
    return torch.stack([
        torch.where(opaque, _bit_depth(r, 5), _bit_depth(r, 4)),
        torch.where(opaque, _bit_depth(g, 5), _bit_depth(g, 4)),
        torch.where(opaque, _bit_depth(b, 5 if is_b else 4),
                    _bit_depth(b, 4 if is_b else 3)),
        torch.where(opaque, a, _bit_depth(a, 3))], dim=-1)


def _color_diff(c0, c1):
    return (c0 - c1).abs().sum(-1, dtype=torch.int32)


def _morph(image: torch.Tensor):
    """GetExtremesFast + Morph (:255-329, :506-521): (H, W, 4) int32 ->
    (A, B), each (nby, nbx, 4) int32."""
    h, w = image.shape[0], image.shape[1]
    nby, nbx = h // BLOCK_H, w // BLOCK_W
    blocks = image.reshape(nby, BLOCK_H, nbx, BLOCK_W, 4).transpose(1, 2)
    blocks = blocks.reshape(nby, nbx, BLOCK_H * BLOCK_W, 4)
    r, g, b, a = blocks.unbind(-1)
    lightness = (77 * r + 150 * g + 28 * b) >> 8

    def pick(idx):
        index = idx[..., None, None].expand(*idx.shape, 1, 4)
        return torch.gather(blocks, -2, index).squeeze(-2)

    pixel00 = image[0, 0][None, None, :]
    mins, maxs, diffs = [], [], []
    for f in (lightness, r, g, b, a):
        lo = pick(f.argmin(-1))
        hi = pick(f.argmax(-1))
        hi = torch.where((f.amax(-1) == 0)[..., None], pixel00, hi)
        mins.append(lo)
        maxs.append(hi)
        diffs.append(_color_diff(lo, hi))
    best = torch.stack(diffs, dim=-1).argmax(-1)
    index = best[..., None, None].expand(*best.shape, 1, 4)
    c0 = torch.gather(torch.stack(mins, dim=-2), -2, index).squeeze(-2)
    c1 = torch.gather(torch.stack(maxs, dim=-2), -2, index).squeeze(-2)
    swap = (c1.sum(-1) < c0.sum(-1))[..., None]
    lo, hi = torch.where(swap, c1, c0), torch.where(swap, c0, c1)
    return _channel_reduction(lo, False), _channel_reduction(hi, True)


def _upscale_axis(low: torch.Tensor, size: int, axis: int, block: int):
    up = low.repeat_interleave(block, dim=axis)
    prev = up.roll(block // 2, dims=axis)
    nxt = up.roll(block // 2 - block, dims=axis)
    shape = [1] * low.dim()
    shape[axis] = size
    fw = ((torch.arange(size, device=low.device) + block // 2)
          & (block - 1)).reshape(shape).to(low.dtype)
    return (block - fw) * prev + fw * nxt


def _upscale(low: torch.Tensor, h: int, w: int):
    """Bilinear wrap upscale (GetInterpolatedColor2BPP, :208-237)."""
    tmp = _upscale_axis(low, w, axis=-2, block=BLOCK_W)
    return _upscale_axis(tmp, h, axis=-3, block=BLOCK_H) // (BLOCK_W * BLOCK_H)


def _modulate(image, a_up, b_up):
    """BestModulation with the early exit (:148-166): (H, W) int32."""
    def apply(mod):
        if mod == 1:
            return (5 * a_up + 3 * b_up) // 8
        if mod == 2:
            return (3 * a_up + 5 * b_up) // 8
        return b_up

    best_diff = _color_diff(image, a_up)
    best = torch.zeros_like(best_diff)
    alive = torch.ones_like(best_diff, dtype=torch.bool)
    for mod in (1, 2, 3):
        diff = _color_diff(image, apply(mod))
        take = alive & (diff < best_diff)
        best = torch.where(take, mod, best)
        best_diff = torch.where(take, diff, best_diff)
        alive = take
    return best


def _per_block_sum(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    return x.reshape(h // BLOCK_H, BLOCK_H, w // BLOCK_W, BLOCK_W).sum(
        dim=(1, 3), dtype=torch.int32)


def _modes(mod: torch.Tensor):
    """CalculateBlockModulationMode (:395-447), with the reference's
    crossed horizontal and vertical counts."""
    intermediate = _per_block_sum(((mod == 1) | (mod == 2)).to(torch.int32))
    horizontal_count = _per_block_sum((mod - mod.roll(-1, dims=0)).abs())
    vertical_count = _per_block_sum((mod - mod.roll(-1, dims=1)).abs())
    vertical = (vertical_count > 10) & (vertical_count > horizontal_count * 2)
    horizontal = (horizontal_count > 10) & (horizontal_count > vertical_count * 2)
    mode = torch.where(vertical, 2, torch.where(horizontal, 3, 1))
    return torch.where(intermediate <= 4, 0, mode).to(torch.int32)


_YY, _XX = np.mgrid[0:BLOCK_H, 0:BLOCK_W]
_BITPOS_1BPP = (_YY * 8 + _XX).astype(np.int32)
_CHECKER = ((_XX ^ _YY) & 1) == 0
_BITPOS_2BPP = (2 * (_YY * 4 + _XX // 2)).astype(np.int32)
_AT0 = (_BITPOS_2BPP == 0) & _CHECKER
_AT20 = (_BITPOS_2BPP == 20) & _CHECKER


def _modulation_words(mod, modes):
    """CalculateBlockModulationData (:456-496): (nby, nbx) int32 words."""
    dev = mod.device
    h, w = mod.shape
    m = mod.reshape(h // BLOCK_H, BLOCK_H, w // BLOCK_W, BLOCK_W).transpose(1, 2)

    def table(t):
        return torch.from_numpy(np.ascontiguousarray(t)).to(dev)

    word_1bpp = ((m >> 1) << table(_BITPOS_1BPP)).sum(dim=(-2, -1)).to(torch.int32)
    modes_b = modes[..., None, None]
    bits = torch.where(table(_AT0), torch.where(modes_b == 1, m & 2, m | 1), m)
    bits = torch.where(table(_AT20), torch.where(modes_b == 2, bits | 1, bits & 2),
                       bits)
    bit2 = torch.where(table(_CHECKER), bits << table(_BITPOS_2BPP), 0)
    word_2bpp = bit2.sum(dim=(-2, -1)).to(torch.int32)
    return torch.where(modes == 0, word_1bpp, word_2bpp)


def _color_words(a, b, modes):
    """EncodeColors (:356-388)."""
    ar, ag, ab, aa = a.unbind(-1)
    br, bg, bb, ba = b.unbind(-1)
    a_o = (1 << 15) | ((ab >> 4) << 1) | ((ag >> 3) << 5) | ((ar >> 3) << 10)
    a_t = ((ab >> 5) << 1) | ((ag >> 4) << 4) | ((ar >> 4) << 8) | ((aa >> 5) << 12)
    b_o = _BIT31 | ((bb >> 3) << 16) | ((bg >> 3) << 21) | ((br >> 3) << 26)
    b_t = ((bb >> 4) << 16) | ((bg >> 4) << 20) | ((br >> 4) << 24) | ((ba >> 5) << 28)
    value = torch.where(aa == 255, a_o, a_t) | torch.where(ba == 255, b_o, b_t)
    return value | (modes != 0).to(torch.int32)


def encode_pvrtc_2bpp(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8, H == W a power of two >= 8 -> (H W / 32, 8) uint8
    records (modulation word, color word, little-endian) in Z-order."""
    h, w = image.shape[0], image.shape[1]
    img = image.to(torch.int32)
    a, b = _morph(img)
    mod = _modulate(img, _upscale(a, h, w), _upscale(b, h, w))
    modes = _modes(mod)
    perm = torch.from_numpy(zorder_permutation(w // BLOCK_W, h // BLOCK_H)
                            ).to(image.device)
    mod_words = _modulation_words(mod, modes).flatten()[perm]
    color_words = _color_words(a, b, modes).flatten()[perm]
    parts = [(wd >> s) & 0xFF for wd in (mod_words, color_words)
             for s in (0, 8, 16, 24)]
    return torch.stack(parts, dim=-1).to(torch.uint8)
