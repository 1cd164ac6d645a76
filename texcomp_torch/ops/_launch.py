"""What every kernel wrapper shares: argument checks, the launch with its
count, and dispatch of an image op by its tensor's device.

A CPU tensor takes the plain PyTorch version, a CUDA tensor launches the
kernel or raises. No path falls back from one to the other.
"""

from __future__ import annotations

import torch

from texcomp_torch.blocks import num_blocks
from texcomp_torch.ops import _build

#: Launches of each kernel since the last :func:`reset_launches`. A wrapper
#: adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"dxt1_encode": 0, "dxt5_encode": 0, "dxt1_decode": 0,
            "dxt5_decode": 0, "dxt1_downsample": 0, "dxt5_downsample": 0,
            "etc1_encode": 0, "etc1_decode": 0, "etc1_downsample": 0,
            "pvrtc_morph": 0, "pvrtc_morph_batched": 0,
            "pvrtc_upscale_modulate": 0, "pvrtc_modes_pack": 0,
            "dxt_hq_cluster_topk4": 0, "etc1_hq_search": 0,
            "etc1_hq_fit_search": 0,
            "pvrtc_upscale_modulate_halo": 0, "pvrtc_modes_pack_strip": 0,
            "pvrtc_hq_normal": 0, "pvrtc_hq_dot": 0, "pvrtc_hq_choose": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check(t: torch.Tensor, name: str, shape_ok: bool, align: int,
          dtype: torch.dtype = torch.uint8) -> None:
    """Raise unless ``t`` is a contiguous, ``align``-byte aligned CUDA
    tensor of ``dtype`` and of a shape the kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not shape_ok:
        raise ValueError(f"{name}: unsupported shape {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: tensor must be contiguous and "
                         f"{align}-byte aligned")


def encode_grid(image: torch.Tensor, grid_height: int, grid_width: int):
    """(h, w, block rows, block columns) of an encode over a grid that must
    cover the image."""
    h, w = image.shape[:2]
    if not (0 < h <= grid_height and 0 < w <= grid_width):
        raise ValueError(f"grid {grid_height}x{grid_width} does not cover "
                         f"image {h}x{w}")
    return h, w, num_blocks(grid_height), num_blocks(grid_width)


def decode_grid(data: torch.Tensor, height: int, width: int):
    """(block rows, block columns) of a decode to a whole block grid."""
    if height % 4 or width % 4:
        raise ValueError(f"decode extent {height}x{width} is not a block grid")
    nbr, nbc = height // 4, width // 4
    if data.shape[0] != nbr * nbc:
        raise ValueError(f"{data.shape[0]} blocks for a {nbr}x{nbc} grid")
    return nbr, nbc


def downsample_grid(data: torch.Tensor, nby: int, nbx: int) -> None:
    """Raise unless ``data`` covers an even (nby, nbx) block grid."""
    if nby < 2 or nbx < 2 or nby % 2 or nbx % 2:
        raise ValueError(f"downsample needs an even block grid, got "
                         f"{nby}x{nbx}")
    if data.shape[0] != nby * nbx:
        raise ValueError(f"{data.shape[0]} blocks for a {nby}x{nbx} grid")


def launch(name: str, device: torch.device, entry: str, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream, raise if
    the launch was refused, and count it under ``name``."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.texcomp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def pick(t: torch.Tensor, plain, cuda):
    """The plain version for a CPU tensor, the kernel wrapper for a CUDA
    tensor."""
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return cuda
    raise ValueError(f"unsupported device {t.device}")
