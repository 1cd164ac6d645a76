"""Image-level PVRTC 2bpp encode ops: CUDA kernels with their plain twins.

The encode runs in three stages, each a kernel in
``texcomp_torch/csrc/pvrtc.cu`` with a wrapper here (``*_cuda``) and a
plain PyTorch version of the same function beside it (``*_plain``), built
from ``codecs.pvrtc``:

  morph             (H, W, 4) uint8 image + (4,) uint8 fallback pixel
                    -> ab (NB, 2) int32: the packed reduced colors A, B of
                    each 8x4 block, row-major. The batched form takes
                    (B, H, W, 4) and each image's own pixel (0, 0).
  upscale_modulate  (B, H, W, 4) images + ab (B*NB, 2) -> (B*NB, 32) uint8
                    modulation 0..3, pixel (py, px) of a block at py*8+px.
  modes_pack        the modulation + ab -> (B*NB, 8) uint8 records, each
                    image's blocks in Z-order slots.

A strip of a taller image (the block rows of one "data" shard of an
atlas, ``dist.mesh``) goes through the same three stages: the morph as it
is (``pvrtc_morph_strip``, with the whole image's fallback pixel), then
two variants that take from outside what a square image takes from its own
wrap: ``upscale_modulate_halo`` the low-res rows above and below the strip,
``modes_pack_strip`` the modulation row below it; the latter writes
row-major records, which the caller permutes to Z-order once for the
whole image.

Words are int32 bit patterns (``texcomp_torch.core.bits``). Every image is
square with a power-of-two side of at least 8, so its block grid is
(2 * nbx, nbx) and Z-order maps it onto the slots one to one; a strip's
grid is any (nby, nbx) of powers of two. The stages
dispatch by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. No path falls back from one to
the other.
"""

from __future__ import annotations

import torch

from texcomp_torch.codecs import pvrtc
from texcomp_torch.ops._launch import check as _check
from texcomp_torch.ops._launch import launch as _launch
from texcomp_torch.ops._launch import pick as _pick

BLOCK_W = pvrtc.BLOCK_W
BLOCK_H = pvrtc.BLOCK_H


def _grid(images: torch.Tensor):
    """(batch, nby, nbx) of a (B, H, W, 4) stack of square power-of-two
    images of side >= 8; raises on any other shape."""
    if images.dim() != 4 or images.shape[-1] != 4:
        raise ValueError(f"expected (B, H, W, 4) images, got "
                         f"{tuple(images.shape)}")
    b, h, w = images.shape[:3]
    if h != w or h < BLOCK_W or h & (h - 1):
        raise ValueError(f"PVRTC 2bpp needs square power-of-two images of "
                         f"side >= {BLOCK_W}, got {h}x{w}")
    return b, h // BLOCK_H, w // BLOCK_W


def _strip_grid(strip: torch.Tensor):
    """(nby, nbx) of an (H, W, 4) strip: H and W / 2 powers of two with
    W >= 8, an (H / 4, W / 8) grid of powers of two (a strip of a square
    power-of-two image over a power-of-two number of shards); raises on any
    other shape."""
    if strip.dim() != 3 or strip.shape[-1] != 4:
        raise ValueError(f"expected an (H, W, 4) strip, got "
                         f"{tuple(strip.shape)}")
    h, w = strip.shape[:2]
    nby, nbx = h // BLOCK_H, w // BLOCK_W
    if (h % BLOCK_H or w % BLOCK_W or nby < 1 or nbx < 1 or nby & (nby - 1)
            or nbx & (nbx - 1)):
        raise ValueError(f"a PVRTC 2bpp strip needs a power-of-two block "
                         f"grid of width >= {BLOCK_W}, got {h}x{w}")
    return nby, nbx


def _ab_ok(ab: torch.Tensor, n: int) -> bool:
    return ab.dim() == 2 and ab.shape == (n, 2)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device).
# ---------------------------------------------------------------------------


def _morph_words(images: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4) uint8 + (B, 4) fallback pixels -> (B*NB, 2) int32."""
    a, b = pvrtc._morph(images.to(torch.int32), origin=origin.to(torch.int32))
    return torch.stack([pvrtc.pack_words(a), pvrtc.pack_words(b)],
                       dim=-1).reshape(-1, 2)


def pvrtc_morph_plain(image: torch.Tensor,
                      origin: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 + (4,) uint8 fallback pixel -> (NB, 2) int32 packed
    reduced (A, B) per block, row-major."""
    _grid(image[None])
    return _morph_words(image[None], origin[None])


def pvrtc_morph_batched_plain(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4) uint8 -> (B*NB, 2) int32; image b falls back to its own
    pixel (0, 0)."""
    _grid(images)
    return _morph_words(images, images[:, 0, 0])


def pvrtc_morph_strip_plain(strip: torch.Tensor,
                            origin: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 strip + (4,) uint8 fallback pixel -> (NB, 2) int32,
    as :func:`pvrtc_morph_plain` on a strip's grid."""
    _strip_grid(strip)
    return _morph_words(strip[None], origin[None])


def pvrtc_upscale_modulate_plain(images: torch.Tensor,
                                 ab: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4) uint8 + (B*NB, 2) int32 -> (B*NB, 32) uint8 modulation,
    pixel (py, px) of a block at py*8+px."""
    b, nby, nbx = _grid(images)
    h, w = 4 * nby, 8 * nbx
    low = pvrtc.unpack_words(ab.reshape(b, nby, nbx, 2))  # (b, nby, nbx, 2, 4)
    a_up = pvrtc._interpolate_upscaled(low[..., 0, :], h, w)
    b_up = pvrtc._interpolate_upscaled(low[..., 1, :], h, w)
    mod = pvrtc._modulate(images.to(torch.int32), a_up, b_up)  # (b, h, w)
    return pvrtc._blocks_of(mod).reshape(-1, 32).to(torch.uint8)


def pvrtc_upscale_modulate_halo_plain(strip: torch.Tensor, ab: torch.Tensor,
                                      halo_top: torch.Tensor,
                                      halo_bot: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 strip + (NB, 2) int32 ab + the (nbx, 2) int32 packed
    rows above and below it -> (NB, 32) uint8 modulation, as
    :func:`pvrtc_upscale_modulate_plain` with the halo rows in place of the
    y-wrap."""
    nby, nbx = _strip_grid(strip)
    h, w = 4 * nby, 8 * nbx
    low = pvrtc.unpack_words(ab.reshape(nby, nbx, 2))  # (nby, nbx, 2, 4)
    top = pvrtc.unpack_words(halo_top.reshape(nbx, 2))
    bot = pvrtc.unpack_words(halo_bot.reshape(nbx, 2))
    a_up = pvrtc._interpolate_upscaled(low[..., 0, :], h, w,
                                       halo=(top[:, 0], bot[:, 0]))
    b_up = pvrtc._interpolate_upscaled(low[..., 1, :], h, w,
                                       halo=(top[:, 1], bot[:, 1]))
    mod = pvrtc._modulate(strip.to(torch.int32), a_up, b_up)  # (h, w)
    return pvrtc._blocks_of(mod).reshape(-1, 32).to(torch.uint8)


def _mode_words(mod: torch.Tensor, ab: torch.Tensor, nby: int, nbx: int,
                halo_v: torch.Tensor | None = None):
    """(B*NB, 32) uint8 modulation + (B*NB, 2) int32 ab on (nby, nbx) grids
    -> (modulation words, color words), each (B, NB) int32 row-major.
    halo_v: None (each grid wraps), or the (nbx, 8) uint8 modulation row
    below a single strip."""
    nb = nby * nbx
    m = mod.to(torch.int32).reshape(-1, nby, nbx, BLOCK_H, BLOCK_W)
    m = m.transpose(2, 3).reshape(-1, BLOCK_H * nby, BLOCK_W * nbx)
    below = None if halo_v is None else halo_v.to(torch.int32).reshape(1, -1)
    modes = pvrtc._block_modulation_modes(m, below)
    mod_words = pvrtc._block_modulation_data(m, modes).reshape(-1, nb)
    low = pvrtc.unpack_words(ab.reshape(-1, nby, nbx, 2))
    color_words = pvrtc._encode_colors(low[..., 0, :], low[..., 1, :],
                                       modes).reshape(-1, nb)
    return mod_words, color_words


def pvrtc_modes_pack_plain(mod: torch.Tensor, ab: torch.Tensor, nby: int,
                           nbx: int) -> torch.Tensor:
    """(B*NB, 32) uint8 modulation + (B*NB, 2) int32 ab on (nby, nbx) grids
    -> (B*NB, 8) uint8 records, each image's in Z-order slots."""
    mod_words, color_words = _mode_words(mod, ab, nby, nbx)
    perm = pvrtc._perm(nbx, nby, mod.device)
    return pvrtc._pack_records(mod_words[:, perm],
                               color_words[:, perm]).reshape(-1, 8)


def pvrtc_modes_pack_strip_plain(mod: torch.Tensor, ab: torch.Tensor,
                                 halo_v: torch.Tensor, nby: int,
                                 nbx: int) -> torch.Tensor:
    """(NB, 32) uint8 modulation + (NB, 2) int32 ab of an (nby, nbx) strip
    + halo_v, the (nbx, 8) uint8 modulation row below it -> (NB, 8) uint8
    records, row-major."""
    mod_words, color_words = _mode_words(mod, ab, nby, nbx, halo_v)
    return pvrtc._pack_records(mod_words, color_words).reshape(-1, 8)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only).
# ---------------------------------------------------------------------------


def pvrtc_morph_cuda(image: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_morph_plain`."""
    _, nby, nbx = _grid(image[None])
    return _morph_launch(image, origin, nby, nbx)


def _morph_launch(image: torch.Tensor, origin: torch.Tensor, nby: int,
                  nbx: int) -> torch.Tensor:
    """The morph kernel on an (nby, nbx) grid of powers of two."""
    _check(image, "pvrtc_morph", image.dim() == 3, 16)
    _check(origin, "pvrtc_morph", origin.shape == (4,), 4)
    out = torch.empty((nby * nbx, 2), dtype=torch.int32, device=image.device)
    _launch("pvrtc_morph", image.device, "texcomp_pvrtc_morph",
            image.data_ptr(), nby, nbx, origin.data_ptr(), out.data_ptr())
    return out


def pvrtc_morph_strip_cuda(strip: torch.Tensor,
                           origin: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_morph_strip_plain`: the morph kernel,
    counted as ``pvrtc_morph``."""
    return _morph_launch(strip, origin, *_strip_grid(strip))


def pvrtc_morph_batched_cuda(images: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_morph_batched_plain`."""
    _check(images, "pvrtc_morph_batched", images.dim() == 4, 16)
    b, nby, nbx = _grid(images)
    out = torch.empty((b * nby * nbx, 2), dtype=torch.int32,
                      device=images.device)
    _launch("pvrtc_morph_batched", images.device,
            "texcomp_pvrtc_morph_batched", images.data_ptr(), b, nby, nbx,
            out.data_ptr())
    return out


def pvrtc_upscale_modulate_cuda(images: torch.Tensor,
                                ab: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_upscale_modulate_plain`."""
    _check(images, "pvrtc_upscale_modulate", images.dim() == 4, 16)
    b, nby, nbx = _grid(images)
    n = b * nby * nbx
    _check(ab, "pvrtc_upscale_modulate", _ab_ok(ab, n), 8, torch.int32)
    out = torch.empty((n, 32), dtype=torch.uint8, device=images.device)
    _launch("pvrtc_upscale_modulate", images.device,
            "texcomp_pvrtc_upscale_modulate", images.data_ptr(),
            ab.data_ptr(), b, nby, nbx, out.data_ptr())
    return out


def pvrtc_upscale_modulate_halo_cuda(strip: torch.Tensor, ab: torch.Tensor,
                                     halo_top: torch.Tensor,
                                     halo_bot: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_upscale_modulate_halo_plain`."""
    name = "pvrtc_upscale_modulate_halo"
    _check(strip, name, strip.dim() == 3, 16)
    nby, nbx = _strip_grid(strip)
    n = nby * nbx
    _check(ab, name, _ab_ok(ab, n), 8, torch.int32)
    for halo in (halo_top, halo_bot):
        _check(halo, name, _ab_ok(halo, nbx), 8, torch.int32)
    out = torch.empty((n, 32), dtype=torch.uint8, device=strip.device)
    _launch(name, strip.device, "texcomp_pvrtc_upscale_modulate_halo",
            strip.data_ptr(), ab.data_ptr(), halo_top.data_ptr(),
            halo_bot.data_ptr(), nby, nbx, out.data_ptr())
    return out


def pvrtc_modes_pack_cuda(mod: torch.Tensor, ab: torch.Tensor, nby: int,
                          nbx: int) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_modes_pack_plain`."""
    nb = nby * nbx
    grid_ok = nbx >= 1 and nby == 2 * nbx and not nbx & (nbx - 1)
    _check(mod, "pvrtc_modes_pack", grid_ok and mod.dim() == 2
           and mod.shape[1] == 32 and mod.shape[0] % nb == 0, 16)
    _check(ab, "pvrtc_modes_pack", _ab_ok(ab, mod.shape[0]), 8, torch.int32)
    out = torch.empty((mod.shape[0], 8), dtype=torch.uint8, device=mod.device)
    _launch("pvrtc_modes_pack", mod.device, "texcomp_pvrtc_modes_pack",
            mod.data_ptr(), ab.data_ptr(), mod.shape[0] // nb, nby, nbx,
            out.data_ptr())
    return out


def pvrtc_modes_pack_strip_cuda(mod: torch.Tensor, ab: torch.Tensor,
                                halo_v: torch.Tensor, nby: int,
                                nbx: int) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_modes_pack_strip_plain`."""
    name = "pvrtc_modes_pack_strip"
    n = nby * nbx
    grid_ok = (nby >= 1 and nbx >= 1 and not nby & (nby - 1)
               and not nbx & (nbx - 1))
    _check(mod, name, grid_ok and mod.shape == (n, 32), 16)
    _check(ab, name, _ab_ok(ab, n), 8, torch.int32)
    _check(halo_v, name, halo_v.shape == (nbx, 8), 8)
    out = torch.empty((n, 8), dtype=torch.uint8, device=mod.device)
    _launch(name, mod.device, "texcomp_pvrtc_modes_pack_strip",
            mod.data_ptr(), ab.data_ptr(), halo_v.data_ptr(), nby, nbx,
            out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# Image ops: dispatch by the tensor's device.
# ---------------------------------------------------------------------------


def _finish(images: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """The upscale + modulate and mode + pack stages of ``images``."""
    _, nby, nbx = _grid(images)
    mod = _pick(images, pvrtc_upscale_modulate_plain,
                pvrtc_upscale_modulate_cuda)(images, ab)
    return _pick(mod, pvrtc_modes_pack_plain, pvrtc_modes_pack_cuda)(
        mod, ab, nby, nbx)


def pvrtc_encode_image(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8, square power-of-two side >= 8 -> (H*W/32, 8) uint8
    PVRTC 2bpp records in Z-order, byte-equal to the reference."""
    morph = _pick(image, pvrtc_morph_plain, pvrtc_morph_cuda)
    ab = morph(image, image[0, 0])
    return _finish(image[None], ab)


def pvrtc_encode_batched(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4) uint8 same-size images -> (B, NB, 8) uint8; each image's
    records are byte-equal to :func:`pvrtc_encode_image` of that image."""
    b, nby, nbx = _grid(images)
    morph = _pick(images, pvrtc_morph_batched_plain, pvrtc_morph_batched_cuda)
    return _finish(images, morph(images)).reshape(b, nby * nbx, 8)


# ---------------------------------------------------------------------------
# Strip ops (an atlas's "data" shard): dispatch by the tensor's device.
# ---------------------------------------------------------------------------


def pvrtc_morph_strip(strip: torch.Tensor,
                      origin: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 strip + the whole image's (4,) pixel (0, 0) -> (NB, 2)
    int32 packed reduced (A, B), row-major."""
    return _pick(strip, pvrtc_morph_strip_plain, pvrtc_morph_strip_cuda)(
        strip, origin)


def pvrtc_upscale_modulate_halo(strip: torch.Tensor, ab: torch.Tensor,
                                halo_top: torch.Tensor,
                                halo_bot: torch.Tensor) -> torch.Tensor:
    """(NB, 32) uint8 modulation of a strip, the (nbx, 2) packed rows above
    and below it in place of the wrap."""
    return _pick(strip, pvrtc_upscale_modulate_halo_plain,
                 pvrtc_upscale_modulate_halo_cuda)(strip, ab, halo_top,
                                                   halo_bot)


def pvrtc_modes_pack_strip(mod: torch.Tensor, ab: torch.Tensor,
                           halo_v: torch.Tensor, nby: int,
                           nbx: int) -> torch.Tensor:
    """(NB, 8) uint8 row-major records of an (nby, nbx) strip, halo_v the
    (nbx, 8) modulation row below it."""
    return _pick(mod, pvrtc_modes_pack_strip_plain,
                 pvrtc_modes_pack_strip_cuda)(mod, ab, halo_v, nby, nbx)
