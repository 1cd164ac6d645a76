"""PVRTC v1 4-bits-per-pixel RGBA encode/decode (EXTENSION), in plain
PyTorch on any device.

The reference implements only the 2BPP variant (pvrtc_compressor.h:16-17).
Same low-frequency-signal-modulation design: two low-res palette images A/B
bilinearly upscaled with wrap-around, plus a per-pixel 2-bit modulation,
but with 4x4 blocks, all 16 modulation values stored (no checkerboard) and
/16 bilinear weights. The encoder is the 2BPP one in shape: the
GetExtremesFast extremes (the same tie-breaks, all-zero-axis fallback and
reduction), the early-exit BestModulation, and the same color word with
the mode bit clear; 64-bit records in Z-order (square grids only).

It shares the reduction, color-packing, upscale and modulation helpers of
``codecs.pvrtc``. texcomp computes it outside any Pallas kernel, so there
is no kernel of its own.
"""

from __future__ import annotations

import torch

from texcomp_torch.codecs import pvrtc

BLOCK = 4  # 4x4 blocks, 2 bits/pixel modulation + 64-bit record = 4 bpp


def _shifts(device: torch.device) -> torch.Tensor:
    """Bit position of pixel (y, x) in the modulation word, 2 * (y * 4 + x),
    made on ``device`` (no host-to-device copy)."""
    return 2 * torch.arange(BLOCK * BLOCK, dtype=torch.int32,
                            device=device).reshape(BLOCK, BLOCK)


def morph_4bpp(image: torch.Tensor, origin: torch.Tensor | None = None):
    """(H, W, 4) uint8 -> the reduced low-res colors (A, B), each
    (H / 4, W / 4, 4) int32. origin: the fallback pixel of an all-zero
    axis, (4,) uint8; None takes ``image``'s own pixel (0, 0), a strip of a
    taller image passes the whole image's."""
    img = image.to(torch.int32)
    if origin is not None:
        origin = origin.to(torch.int32)
    lo, hi = pvrtc._morph_extremes(img, BLOCK, BLOCK, origin=origin)
    return (pvrtc._apply_color_channel_reduction(lo, is_b=False),
            pvrtc._apply_color_channel_reduction(hi, is_b=True))


def encode_strip_words(image: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       halo=None):
    """(H, W, 4) uint8 + its :func:`morph_4bpp` colors -> (modulation
    words, color words), each (H / 4 * W / 4,) int32, row-major.

    halo: None (the image wraps), or ((a_top, b_top), (a_bot, b_bot)),
    each (W / 4, 4) int32: the low-res rows above and below ``image`` when
    it is a strip of a taller one, which replace the upscale's y-wrap."""
    h, w = image.shape[0], image.shape[1]
    a_halo = b_halo = None
    if halo is not None:
        (a_top, b_top), (a_bot, b_bot) = halo
        a_halo, b_halo = (a_top, a_bot), (b_top, b_bot)
    a_up = pvrtc._interpolate_upscaled(a, h, w, BLOCK, BLOCK, halo=a_halo)
    b_up = pvrtc._interpolate_upscaled(b, h, w, BLOCK, BLOCK, halo=b_halo)
    mod = pvrtc._modulate(image.to(torch.int32), a_up, b_up)

    blocks = mod.reshape(h // BLOCK, BLOCK, w // BLOCK, BLOCK).transpose(1, 2)
    mod_words = pvrtc._word_sum(blocks << _shifts(image.device)).reshape(-1)
    # Bit 0 of the color word is the mode flag: 0, the standard weights.
    modes0 = torch.zeros(a.shape[:2], dtype=torch.int32, device=image.device)
    color_words = pvrtc._encode_colors(a, b, modes0).reshape(-1)
    return mod_words, color_words


def encode_pvrtc_4bpp(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 (square power-of-two, >= 4) -> (NB, 8) uint8 Z-order
    4bpp records: the 32-bit modulation word (2 bits/pixel, pixel (y, x)
    at bit 2*(y*4+x)) then the 32-bit color word, both little-endian."""
    nb = image.shape[0] // BLOCK
    a, b = morph_4bpp(image)
    mod_words, color_words = encode_strip_words(image, a, b)
    perm = pvrtc._perm(nb, nb, image.device)
    return pvrtc._pack_records(mod_words[perm], color_words[perm])


def decode_pvrtc_4bpp(data: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """(NB, 8) uint8 4bpp records -> (H, W, 4) uint8."""
    h, w = height, width
    nb = h // BLOCK
    mod_words, color_words = pvrtc.records_to_words(data)
    mod_words = pvrtc.unpermute_zorder(mod_words, nb, nb)
    color_words = pvrtc.unpermute_zorder(color_words, nb, nb)

    a_up = pvrtc._interpolate_upscaled(
        pvrtc._decode_color(color_words, is_b=False), h, w, BLOCK, BLOCK)
    b_up = pvrtc._interpolate_upscaled(
        pvrtc._decode_color(color_words, is_b=True), h, w, BLOCK, BLOCK)

    shifts = _shifts(data.device)
    mod = (mod_words[:, :, None, None] >> shifts) & 3  # (nb, nb, 4, 4)
    mod = mod.transpose(1, 2).reshape(h, w)[..., None]

    out = a_up
    out = torch.where(mod == 1, (5 * a_up + 3 * b_up) >> 3, out)
    out = torch.where(mod == 2, (3 * a_up + 5 * b_up) >> 3, out)
    out = torch.where(mod == 3, b_up, out)
    return out.clamp(0, 255).to(torch.uint8)
