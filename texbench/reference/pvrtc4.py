"""PVRTC v1 4bpp of a square power-of-two RGBA image (copied from
``texcomp_torch/codecs/pvrtc4.py``): the 2bpp encoder in shape on 4x4
blocks, with every one of the 16 modulation values stored (2 bits a
pixel, pixel (y, x) at bit 2 * (y * 4 + x)), /16 bilinear weights and the
color word's mode bit clear; 64-bit records in Z-order."""

from __future__ import annotations

import torch

from texbench.reference import pvrtc as pv

BLOCK = 4


def _shifts(device) -> torch.Tensor:
    return 2 * torch.arange(BLOCK * BLOCK, dtype=torch.int32,
                            device=device).reshape(BLOCK, BLOCK)


def pack(mod: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 modulation and the (nb, nb, 4) int32 reduced A/B ->
    (nb * nb, 8) uint8 Z-order records."""
    h, w = mod.shape
    nb = h // BLOCK
    blocks = mod.reshape(nb, BLOCK, w // BLOCK, BLOCK).transpose(1, 2)
    mod_words = (blocks << _shifts(mod.device)).sum(dim=(-2, -1)).to(
        torch.int32).reshape(-1)
    modes0 = torch.zeros((nb, nb), dtype=torch.int32, device=mod.device)
    color_words = pv._color_words(a, b, modes0).reshape(-1)
    perm = torch.from_numpy(pv.zorder_permutation(nb, nb)).to(mod.device)
    return pv.pack_records(mod_words[perm], color_words[perm])


def encode_pvrtc_4bpp(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8, H == W a power of two >= 4 -> (H W / 16, 8) uint8
    records (modulation word, color word, little-endian) in Z-order."""
    h, w = image.shape[0], image.shape[1]
    img = image.to(torch.int32)
    lo, hi = pv.morph_extremes(img, BLOCK, BLOCK)
    a = pv._channel_reduction(lo, False)
    b = pv._channel_reduction(hi, True)
    mod = pv._modulate(img, pv.upscale(a, h, w, BLOCK, BLOCK),
                       pv.upscale(b, h, w, BLOCK, BLOCK))
    return pack(mod, a, b)


def decode_pvrtc_4bpp(data: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 8) uint8 Z-order 4bpp records -> (h, w, 4) uint8."""
    nb = h // BLOCK
    mod_words, color_words = pv.unpack_records(data, nb, nb)
    a_up = pv.upscale(pv.decode_color(color_words, False), h, w, BLOCK, BLOCK)
    b_up = pv.upscale(pv.decode_color(color_words, True), h, w, BLOCK, BLOCK)
    mod = (mod_words[:, :, None, None] >> _shifts(data.device)) & 3
    mod = mod.transpose(1, 2).reshape(h, w)[..., None]
    out = a_up
    out = torch.where(mod == 1, (5 * a_up + 3 * b_up) >> 3, out)
    out = torch.where(mod == 2, (3 * a_up + 5 * b_up) >> 3, out)
    out = torch.where(mod == 3, b_up, out)
    return out.clamp(0, 255).to(torch.uint8)
