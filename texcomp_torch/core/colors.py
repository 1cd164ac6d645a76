"""Integer color math on int32/int64 tensors.

Tensor equivalents of the reference's inline color helpers
(image_compression/internal/color_util.h:37-423). The formulas (Blinn
rounding, NVIDIA-style 565 expansion, truncating integer lerp) fix the
exact output bytes of every codec, so they keep the reference's integer
semantics. Inputs are integer tensors of any shape holding channel values;
the shift-and-add helpers also accept Python ints.
"""

from __future__ import annotations

import torch


def div_trunc(n: torch.Tensor, d: int) -> torch.Tensor:
    """C-style truncating integer division (round toward zero).

    The reference relies on C semantics in CombineIntFast
    (color_util.h:282-286). ``d`` must be positive.
    """
    return torch.div(n, d, rounding_mode="trunc")


def quantize8_fast(v, num_bits: int):
    """Shift-quantize an 0-255 component to num_bits (color_util.h:142-148)."""
    return v >> (8 - num_bits)


def quantize8(v, num_bits: int):
    """Round-exact 8-bit -> num_bits quantization (color_util.h:156-164).

    Jim Blinn's "Three Wrongs Make a Right" trick; equals
    round(v / 255 * ((1<<num_bits)-1)) for v in [0, 255].
    """
    i = v * ((1 << num_bits) - 1) + 128
    return (i + (i >> 8)) >> 8


def quantize_to_565(r, g, b):
    """RGB 0-255 -> (r5, g6, b5) via Quantize8 (color_util.h:185-189)."""
    return quantize8(r, 5), quantize8(g, 6), quantize8(b, 5)


def extend_4bit(bits):
    """4-bit -> 8-bit by replication (color_util.h:193-195)."""
    return (bits << 4) | bits


def extend_5bit(bits):
    """5-bit -> 8-bit: '10110' -> '10110101' (color_util.h:200-202)."""
    return (bits << 3) | ((bits >> 2) & 7)


def extend565_r(r5):
    """NVIDIA-hardware-style 5-bit expansion (color_util.h:226-230)."""
    return (r5 << 3) | (r5 >> 2)


def extend565_g(g6):
    """NVIDIA-hardware-style 6-bit expansion (color_util.h:226-230)."""
    return (g6 << 2) | (g6 >> 4)


def extend565_b(b5):
    return extend565_r(b5)


def to_uint16_565(r5, g6, b5):
    """(r5, g6, b5) -> packed 565 value (color_util.h:91-95)."""
    return (r5 << 11) | (g6 << 5) | b5


def from_uint16_565(p):
    """Packed 565 -> (r5, g6, b5) (color_util.h:98-102)."""
    return p >> 11, (p >> 5) & 0x3F, p & 0x1F


def clamp8(v: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 255] (color_util.h:248-265)."""
    return torch.clamp(v, 0, 255)


def combine_int_fast(scale0: int, scale1: int, v0: torch.Tensor,
                     v1: torch.Tensor) -> torch.Tensor:
    """Integer lerp: (s0*v0 + s1*v1) / (s0+s1), C truncating division
    (color_util.h:282-286)."""
    return div_trunc(scale0 * v0 + scale1 * v1, scale0 + scale1)


def average4_fast(v0, v1, v2, v3):
    """Truncating average of 4 components (color_util.h:335-341)."""
    return (v0 + v1 + v2 + v3) // 4


def compute_luminance_fast(r, g, b):
    """Approximate luminance 4r + 8g + b (color_util.h:383-395)."""
    return r * 4 + g * 8 + b


def compute_squared_luminance_distance_fast(r0, g0, b0, r1, g1, b1):
    """(lum(c1) - lum(c0))^2 (color_util.h:399-403)."""
    diff = compute_luminance_fast(r1, g1, b1) - compute_luminance_fast(r0, g0, b0)
    return diff * diff


def compute_difference_luminance_fast(r0, g0, b0, r1, g1, b1):
    """lum(|c0 - c1|)^2, a chroma-aware distance (color_util.h:410-417)."""
    dl = compute_luminance_fast(
        torch.abs(r0 - r1), torch.abs(g0 - g1), torch.abs(b0 - b1))
    return dl * dl


def compute_squared_component_distance(c0, c1):
    """(c1 - c0)^2 (color_util.h:420-423)."""
    diff = c1 - c0
    return diff * diff
