"""Image-level DXT1/DXT5 ops: CUDA kernels with their plain twins.

Each kernel in ``texcomp_torch/csrc/dxt.cu`` has a wrapper here
(``*_cuda``) and a plain PyTorch version of the same function beside it
(``*_plain``), built from ``blocks`` and ``codecs.dxt``. The image ops
pick by the device of the tensor they are given: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. No path falls
back from one to the other.

Encode takes an (h, w, C) uint8 image and a block grid at least that
large; pixels beyond the image replicate its edge, as Pixel4x4 does.
Decode returns the (4 * block_rows, 4 * block_cols, 4) uint8 image on
every device: RGBX with X = 0 for DXT1, RGBA for DXT5. The fused
downsample maps one mip level's payload to the next one's.
"""

from __future__ import annotations

import functools

import torch

from texcomp_torch.blocks import extract_blocks, full_outside_mask, scatter_blocks
from texcomp_torch.codecs import dxt
from texcomp_torch.core.constants import DXTC_CONST_COLOR_TABLE
from texcomp_torch.ops._launch import check as _check
from texcomp_torch.ops._launch import decode_grid as _decode_grid
from texcomp_torch.ops._launch import downsample_grid as _downsample_grid
from texcomp_torch.ops._launch import encode_grid as _encode_grid
from texcomp_torch.ops._launch import launch as _launch
from texcomp_torch.ops._launch import pick as _pick

_BGRA = [2, 1, 0, 3]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device).
# ---------------------------------------------------------------------------


def dxt1_encode_plain(image: torch.Tensor, grid_height: int, grid_width: int,
                      swap: bool = False,
                      always4: bool = False) -> torch.Tensor:
    """(h, w, 3|4) uint8 -> (N, 8) uint8 DXT1 blocks over the grid."""
    h, w = image.shape[:2]
    blocks = extract_blocks(image, height=h, width=w, grid_height=grid_height,
                            grid_width=grid_width)[:, :, :3]
    if swap:
        blocks = blocks.flip(-1)
    return dxt.encode_dxt1_blocks(blocks, always4, swap)


def dxt5_encode_plain(image: torch.Tensor, grid_height: int, grid_width: int,
                      swap: bool = False) -> torch.Tensor:
    """(h, w, 4) uint8 -> (N, 16) uint8 DXT5 blocks over the grid."""
    h, w = image.shape[:2]
    blocks = extract_blocks(image, height=h, width=w, grid_height=grid_height,
                            grid_width=grid_width)
    if swap:
        blocks = blocks[:, :, _BGRA]
    outside = full_outside_mask(h, w, grid_height, grid_width,
                                device=image.device)
    return dxt.encode_dxt5_blocks(blocks, outside, swap)


def dxt1_decode_plain(data: torch.Tensor, height: int, width: int,
                      swap: bool = False,
                      always4: bool = False) -> torch.Tensor:
    """(N, 8) uint8 DXT1 blocks -> (height, width, 4) uint8 RGBX."""
    px = dxt.decode_dxt1_blocks(data, always4)
    if swap:
        # DecodeColors swaps the endpoints (dxtc_compressor.cc:178-181);
        # interpolation is channelwise, so swapping the output is the same.
        px = px.flip(-1)
    px = torch.cat([px, torch.zeros_like(px[:, :, :1])], dim=-1)
    return scatter_blocks(px, height=height, width=width)


def dxt5_decode_plain(data: torch.Tensor, height: int, width: int,
                      swap: bool = False) -> torch.Tensor:
    """(N, 16) uint8 DXT5 blocks -> (height, width, 4) uint8 RGBA."""
    px = dxt.decode_dxt5_blocks(data)
    if swap:
        px = px[:, :, _BGRA]
    return scatter_blocks(px, height=height, width=width)


def average_2x2(image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8 -> (H/2, W/2, C) uint8: the truncating 2x2 average
    (ComputeAveragePixel2x2; ``>> 2`` on the non-negative sums)."""
    h, w, c = image.shape
    sums = image.to(torch.int32).reshape(h // 2, 2, w // 2, 2, c).sum(
        dim=(1, 3), dtype=torch.int32)
    return (sums >> 2).to(torch.uint8)


def dxtc_downsample_plain(data: torch.Tensor, nby: int, nbx: int,
                          is_dxt1: bool) -> torch.Tensor:
    """(nby * nbx, 8 | 16) uint8 payload on an (nby, nbx) block grid, both
    even -> the (nby * nbx / 4, 8 | 16) payload of the next mip level:
    swap-free decode, 2x2 truncating average, encode (the Downsample path,
    compressor4x4_helper.h:602-607)."""
    h, w = 4 * nby, 4 * nbx
    if is_dxt1:
        avg = average_2x2(dxt1_decode_plain(data, h, w)[:, :, :3])
        return dxt1_encode_plain(avg, h // 2, w // 2)
    avg = average_2x2(dxt5_decode_plain(data, h, w))
    return dxt5_encode_plain(avg, h // 2, w // 2)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _device_lut(device: torch.device) -> torch.Tensor:
    """The (256, 8) uint8 const-color table on ``device``."""
    return torch.from_numpy(DXTC_CONST_COLOR_TABLE).to(device)


def dxt1_encode_cuda(image: torch.Tensor, grid_height: int, grid_width: int,
                     swap: bool = False,
                     always4: bool = False) -> torch.Tensor:
    """Kernel version of :func:`dxt1_encode_plain`."""
    _check(image, "dxt1_encode", image.dim() == 3 and image.shape[2] in (3, 4),
           1)
    h, w, nbr, nbc = _encode_grid(image, grid_height, grid_width)
    out = torch.empty((nbr * nbc, 8), dtype=torch.uint8, device=image.device)
    _launch("dxt1_encode", image.device, "texcomp_dxt1_encode",
            image.data_ptr(), image.shape[2], h, w, nbr, nbc,
            _device_lut(image.device).data_ptr(), out.data_ptr(), int(swap),
            int(always4))
    return out


def dxt5_encode_cuda(image: torch.Tensor, grid_height: int, grid_width: int,
                     swap: bool = False) -> torch.Tensor:
    """Kernel version of :func:`dxt5_encode_plain`."""
    _check(image, "dxt5_encode", image.dim() == 3 and image.shape[2] == 4, 1)
    h, w, nbr, nbc = _encode_grid(image, grid_height, grid_width)
    out = torch.empty((nbr * nbc, 16), dtype=torch.uint8, device=image.device)
    _launch("dxt5_encode", image.device, "texcomp_dxt5_encode",
            image.data_ptr(), h, w, nbr, nbc,
            _device_lut(image.device).data_ptr(), out.data_ptr(), int(swap))
    return out


def dxt1_decode_cuda(data: torch.Tensor, height: int, width: int,
                     swap: bool = False,
                     always4: bool = False) -> torch.Tensor:
    """Kernel version of :func:`dxt1_decode_plain`."""
    _check(data, "dxt1_decode", data.dim() == 2 and data.shape[1] == 8, 8)
    nbr, nbc = _decode_grid(data, height, width)
    out = torch.empty((height, width, 4), dtype=torch.uint8, device=data.device)
    _launch("dxt1_decode", data.device, "texcomp_dxt1_decode",
            data.data_ptr(), nbr, nbc, out.data_ptr(), int(swap), int(always4))
    return out


def dxt5_decode_cuda(data: torch.Tensor, height: int, width: int,
                     swap: bool = False) -> torch.Tensor:
    """Kernel version of :func:`dxt5_decode_plain`."""
    _check(data, "dxt5_decode", data.dim() == 2 and data.shape[1] == 16, 16)
    nbr, nbc = _decode_grid(data, height, width)
    out = torch.empty((height, width, 4), dtype=torch.uint8, device=data.device)
    _launch("dxt5_decode", data.device, "texcomp_dxt5_decode",
            data.data_ptr(), nbr, nbc, out.data_ptr(), int(swap))
    return out


def dxtc_downsample_cuda(data: torch.Tensor, nby: int, nbx: int,
                         is_dxt1: bool) -> torch.Tensor:
    """Kernel version of :func:`dxtc_downsample_plain`."""
    bs = 8 if is_dxt1 else 16
    name = "dxt1_downsample" if is_dxt1 else "dxt5_downsample"
    _check(data, name, data.dim() == 2 and data.shape[1] == bs, bs)
    _downsample_grid(data, nby, nbx)
    out = torch.empty((nby * nbx // 4, bs), dtype=torch.uint8,
                      device=data.device)
    _launch(name, data.device, f"texcomp_{name}", data.data_ptr(), nby, nbx,
            _device_lut(data.device).data_ptr(), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# Image ops: dispatch by the tensor's device.
# ---------------------------------------------------------------------------


def dxtc_encode_padded_image(image: torch.Tensor, grid_height: int,
                             grid_width: int, swap: bool,
                             is_dxt1: bool) -> torch.Tensor:
    """The API's compress route: the (h, w, C) valid image, edge-padded to
    the block grid and encoded, in one call. DXT5 blocks wholly outside
    the image are has_one_pixel. Returns (N, 8 | 16) uint8."""
    if is_dxt1:
        fn = _pick(image, dxt1_encode_plain, dxt1_encode_cuda)
    else:
        fn = _pick(image, dxt5_encode_plain, dxt5_encode_cuda)
    return fn(image, grid_height, grid_width, swap)


def dxt1_encode_image(image: torch.Tensor, *, swap: bool = False,
                      always4: bool = False) -> torch.Tensor:
    """(H, W, 3) uint8 -> (N, 8) uint8 DXT1 blocks."""
    h, w = image.shape[:2]
    fn = _pick(image, dxt1_encode_plain, dxt1_encode_cuda)
    return fn(image, h, w, swap, always4)


def dxt5_encode_image(image: torch.Tensor, *, swap: bool = False) -> torch.Tensor:
    """(H, W, 4) uint8 -> (N, 16) uint8 DXT5 blocks."""
    h, w = image.shape[:2]
    return _pick(image, dxt5_encode_plain, dxt5_encode_cuda)(image, h, w, swap)


def dxt1_decode_image(data: torch.Tensor, *, height: int, width: int,
                      swap: bool = False,
                      always4: bool = False) -> torch.Tensor:
    """(N, 8) uint8 DXT1 blocks -> (height, width, 4) uint8 RGBX image
    (BGRX for swap=True); height, width span the whole block grid."""
    fn = _pick(data, dxt1_decode_plain, dxt1_decode_cuda)
    return fn(data, height, width, swap, always4)


def dxt5_decode_image(data: torch.Tensor, *, height: int, width: int,
                      swap: bool = False) -> torch.Tensor:
    """(N, 16) uint8 DXT5 blocks -> (height, width, 4) uint8 RGBA image
    (BGRA for swap=True)."""
    fn = _pick(data, dxt5_decode_plain, dxt5_decode_cuda)
    return fn(data, height, width, swap)


def dxtc_downsample_encode(data: torch.Tensor, *, nby: int, nbx: int,
                           is_dxt1: bool) -> torch.Tensor:
    """One fused mip level: the (N_src, 8 | 16) uint8 payload on an
    (nby, nbx) block grid (both even) -> the (N_src / 4, 8 | 16) payload of
    the 2x downsampled level, equal to decode -> 2x2 truncating average ->
    encode."""
    fn = _pick(data, dxtc_downsample_plain, dxtc_downsample_cuda)
    return fn(data, nby, nbx, is_dxt1)
