"""Bit-field helpers on 32-bit integer tensors.

Tensor equivalents of the reference's bit_util.h:30-69. torch on the CPU
has no shift, add or compare for ``torch.uint32``, so a word is an int32
tensor holding the 32-bit pattern: bit 31 is the sign bit. ``>>`` on int32
is an arithmetic shift, so every right shift here is masked to the field
it extracts, and results are the same bits the uint32 reference gives.
"""

from __future__ import annotations

import torch


def get_mask(num_ones: int) -> int:
    """num_ones 1-bits in the LSBs (bit_util.h:30-32)."""
    return (1 << num_ones) - 1


def _as_signed32(v: int) -> int:
    """A 32-bit pattern as the int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def get_bits(bits: torch.Tensor, start_bit: int, num_bits: int) -> torch.Tensor:
    """Extract num_bits starting at start_bit (bit_util.h:37-41) -> int32."""
    word = bits.to(torch.int32)
    return (word >> start_bit) & get_mask(num_bits)


def set_bits(bits: torch.Tensor, start_bit: int, num_bits: int,
             value) -> torch.Tensor:
    """``bits`` with the field [start_bit, start_bit+num_bits) replaced by
    ``value`` (bit_util.h:46-57). Negative values are masked to the field
    width, as the reference's unsigned cast does (ETC's signed 3-bit color
    deltas, etc_compressor.cc:334-336)."""
    mask = get_mask(num_bits)
    word = bits.to(torch.int32)
    val = torch.as_tensor(value).to(torch.int32) & mask
    keep = _as_signed32(~(mask << start_bit))
    return (word & keep) | (val << start_bit)


def extend_sign_bit(value, num_bits: int) -> torch.Tensor:
    """Sign-extend a num_bits two's-complement field to int32
    (bit_util.h:61-69)."""
    value = torch.as_tensor(value).to(torch.int32)
    shift = 32 - num_bits
    return (value << shift) >> shift
