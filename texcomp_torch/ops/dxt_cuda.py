"""Image-level DXT1/DXT5 ops: CUDA kernels with their plain twins.

Each of the four kernels in ``texcomp_torch/csrc/dxt.cu`` has a wrapper
here (``*_cuda``) and a plain PyTorch version of the same function beside
it (``*_plain``), built from ``blocks`` and ``codecs.dxt``. The image ops
pick by the device of the tensor they are given: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. No path falls
back from one to the other.

Encode takes an (h, w, C) uint8 image and a block grid at least that
large; pixels beyond the image replicate its edge, as Pixel4x4 does.
Decode returns the (4 * block_rows, 4 * block_cols, 4) uint8 image on
every device: RGBX with X = 0 for DXT1, RGBA for DXT5.
"""

from __future__ import annotations

import functools

import torch

from texcomp_torch.blocks import (
    extract_blocks,
    full_outside_mask,
    num_blocks,
    scatter_blocks,
)
from texcomp_torch.codecs import dxt
from texcomp_torch.core.constants import DXTC_CONST_COLOR_TABLE
from texcomp_torch.ops import _build

#: Launches of each kernel since the last :func:`reset_launches`. A wrapper
#: adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"dxt1_encode": 0, "dxt5_encode": 0, "dxt1_decode": 0,
            "dxt5_decode": 0}

_BGRA = [2, 1, 0, 3]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _device_lut(device: torch.device) -> torch.Tensor:
    """The (256, 8) uint8 const-color table on ``device``."""
    return torch.from_numpy(DXTC_CONST_COLOR_TABLE).to(device)


def _check(t: torch.Tensor, name: str, shape_ok: bool, align: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.uint8:
        raise TypeError(f"{name}: expected uint8, got {t.dtype}")
    if not shape_ok:
        raise ValueError(f"{name}: unsupported shape {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: tensor must be contiguous and "
                         f"{align}-byte aligned")


def _launch(name: str, device: torch.device, entry: str, *args) -> None:
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.texcomp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _encode_grid(image: torch.Tensor, grid_height: int, grid_width: int):
    h, w = image.shape[:2]
    if not (0 < h <= grid_height and 0 < w <= grid_width):
        raise ValueError(f"grid {grid_height}x{grid_width} does not cover "
                         f"image {h}x{w}")
    return h, w, num_blocks(grid_height), num_blocks(grid_width)


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


def _decode_grid(data: torch.Tensor, height: int, width: int):
    if height % 4 or width % 4:
        raise ValueError(f"decode extent {height}x{width} is not a block grid")
    nbr, nbc = height // 4, width // 4
    if data.shape[0] != nbr * nbc:
        raise ValueError(f"{data.shape[0]} blocks for a {nbr}x{nbc} grid")
    return nbr, nbc


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


# ---------------------------------------------------------------------------
# Image ops: dispatch by the tensor's device.
# ---------------------------------------------------------------------------


def _pick(t: torch.Tensor, plain, cuda):
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return cuda
    raise ValueError(f"unsupported device {t.device}")


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
