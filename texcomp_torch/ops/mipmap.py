"""Mip chains in the compressed domain, one fused op per level.

Each level's payload is made from the previous level's payload by one
call of the fused downsample op of its codec (decode the 2x2 source
blocks, truncating 2x2 average, encode), on the payload's device: one
kernel launch per level on the card, its plain twin on the CPU. Levels
chain through the encoded payloads, not the pre-encode pixels, so every
level equals what repeated ``Compressor.downsample`` calls give
(compressor4x4_helper.h:264-391).

The chain covers grids whose block counts stay even: extents that are
multiples of 8 at every level it makes (:func:`num_chain_levels`). The
API finishes the tail below that (4x4 -> 2x2 -> 1x1, and ragged sizes)
level by level.
"""

from __future__ import annotations

import torch

from texcomp_torch.ops import dxt_cuda, etc_cuda

CODECS = ("dxt1", "dxt5", "etc1")


def num_chain_levels(height: int, width: int) -> int:
    """How many chained levels the fused op can make: downsampling a level
    needs an even block count in both dimensions (extents that are
    multiples of 8); the chain stops at the first level that has not."""
    levels = 0
    h, w = height, width
    while h % 8 == 0 and w % 8 == 0 and h > 0 and w > 0:
        h //= 2
        w //= 2
        levels += 1
    return levels


def mipmap_chain(data: torch.Tensor, *, height: int, width: int, codec: str,
                 levels: int, strategy: int = 2) -> tuple[torch.Tensor, ...]:
    """(N, block_size) uint8 level-0 payload -> the payloads of levels
    1..levels, each by one fused downsample call.

    codec: "dxt1" | "dxt5" | "etc1" (``strategy`` applies to etc1 only).
    height, width: level 0's extent, with even block counts through every
    requested level (see :func:`num_chain_levels`).
    """
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    if levels > num_chain_levels(height, width):
        raise ValueError(f"{levels} levels requested; a {height}x{width} "
                         f"chain has {num_chain_levels(height, width)}")
    outs = []
    cur = data
    h, w = height, width
    for _ in range(levels):
        if codec == "etc1":
            cur = etc_cuda.etc1_downsample_encode(cur, nby=h // 4, nbx=w // 4,
                                                  strategy=strategy)
        else:
            cur = dxt_cuda.dxtc_downsample_encode(cur, nby=h // 4, nbx=w // 4,
                                                  is_dxt1=codec == "dxt1")
        outs.append(cur)
        h //= 2
        w //= 2
    return tuple(outs)
