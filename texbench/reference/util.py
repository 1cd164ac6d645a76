"""Bit fields, integer color math, the block grid and the codec tables
(copied from ``texcomp_torch/core/{bits,colors,constants}.py`` and
``texcomp_torch/blocks/grid.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Bit fields on int32 words holding 32-bit patterns (bit_util.h:30-69).
# ---------------------------------------------------------------------------


def get_mask(num_ones: int) -> int:
    return (1 << num_ones) - 1


def _as_signed32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def get_bits(bits: torch.Tensor, start_bit: int, num_bits: int) -> torch.Tensor:
    return (bits.to(torch.int32) >> start_bit) & get_mask(num_bits)


def set_bits(bits: torch.Tensor, start_bit: int, num_bits: int,
             value) -> torch.Tensor:
    """``bits`` with the field [start_bit, start_bit + num_bits) replaced by
    ``value``, masked to the field width."""
    mask = get_mask(num_bits)
    word = bits.to(torch.int32)
    val = torch.as_tensor(value).to(torch.int32) & mask
    keep = _as_signed32(~(mask << start_bit))
    return (word & keep) | (val << start_bit)


def extend_sign_bit(value, num_bits: int) -> torch.Tensor:
    value = torch.as_tensor(value).to(torch.int32)
    shift = 32 - num_bits
    return (value << shift) >> shift


# ---------------------------------------------------------------------------
# Integer color math (color_util.h).
# ---------------------------------------------------------------------------


def quantize8(v, num_bits: int):
    """Blinn's round-exact 8-bit -> num_bits quantization."""
    i = v * ((1 << num_bits) - 1) + 128
    return (i + (i >> 8)) >> 8


def extend_4bit(bits):
    return (bits << 4) | bits


def extend_5bit(bits):
    return (bits << 3) | ((bits >> 2) & 7)


def extend565(r5, g6, b5):
    return (r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)


def pack565(r5, g6, b5):
    return (r5 << 11) | (g6 << 5) | b5


def unpack565(p):
    return p >> 11, (p >> 5) & 0x3F, p & 0x1F


def clamp8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0, 255)


def combine_int(scale0: int, scale1: int, v0, v1):
    """(s0 * v0 + s1 * v1) / (s0 + s1), C truncating division."""
    return torch.div(scale0 * v0 + scale1 * v1, scale0 + scale1,
                     rounding_mode="trunc")


def luminance(r, g, b):
    return r * 4 + g * 8 + b


def difference_luminance(c0, c1):
    dl = luminance(*((a - b).abs() for a, b in zip(c0, c1)))
    return dl * dl


# ---------------------------------------------------------------------------
# The block grid.
# ---------------------------------------------------------------------------


def num_blocks(num_pixels: int) -> int:
    return (int(num_pixels) + 3) // 4


def image_to_blocks(image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8, H and W multiples of 4 -> (N, 16, C) int32, blocks
    row-major, pixels row-major within a block."""
    h, w, c = image.shape
    blk = image.to(torch.int32).reshape(h // 4, 4, w // 4, 4, c)
    return blk.permute(0, 2, 1, 3, 4).reshape(-1, 16, c)


def blocks_to_image(blocks: torch.Tensor, nbr: int, nbc: int) -> torch.Tensor:
    """(nbr * nbc, 16, C) -> (4 nbr, 4 nbc, C) uint8."""
    c = blocks.shape[-1]
    img = blocks.reshape(nbr, nbc, 4, 4, c).permute(0, 2, 1, 3, 4)
    return img.reshape(4 * nbr, 4 * nbc, c).to(torch.uint8)


# ---------------------------------------------------------------------------
# Tables.
# ---------------------------------------------------------------------------


def _find_endpoints(channel_bits: int, t: float) -> np.ndarray:
    max_value = 1 << channel_bits
    i = np.arange(max_value, dtype=np.float64)[:, None]
    j = np.arange(max_value, dtype=np.float64)[None, :]
    interp = ((1.0 - t) * i + t * j) / (max_value - 1.0)
    v = np.arange(256, dtype=np.float64) / 255.0
    err = np.abs(v[:, None, None] - interp[None, :, :])
    best = err.reshape(256, -1).argmin(axis=1)
    return np.stack([best // max_value, best % max_value], axis=1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def dxtc_const_color_table() -> np.ndarray:
    """(256, 8) uint8: the best 5/6-bit endpoint pairs of a constant color
    (dxtc_const_color_table.cc:22-58): r/b thirds, r/b halves, g thirds,
    g halves."""
    return np.concatenate([_find_endpoints(5, 1.0 / 3.0),
                           _find_endpoints(5, 1.0 / 2.0),
                           _find_endpoints(6, 1.0 / 3.0),
                           _find_endpoints(6, 1.0 / 2.0)], axis=1)


#: ETC1 modifier codebook (etc_compressor.cc:101-110), rows [a, b, -a, -b].
ETC1_CODEBOOK = np.array([[2, 8, -2, -8], [5, 17, -5, -17], [9, 29, -9, -29],
                          [13, 42, -13, -42], [18, 60, -18, -60],
                          [24, 80, -24, -80], [33, 106, -33, -106],
                          [47, 183, -47, -183]], dtype=np.int32)

#: ETC1 heuristic codeword thresholds (etc_compressor.cc:435-451).
ETC1_HEURISTIC_THRESHOLDS = np.array([12, 23, 35, 51, 70, 93, 144],
                                     dtype=np.int32)
