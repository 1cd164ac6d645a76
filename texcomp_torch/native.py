"""Host-side block-grid byte movement (numpy).

The byte shuffles of the compressed-domain operations: assembling a padded
block grid, copying a block sub-rectangle, replicating a solid block,
copying rows between strided buffers, and the PVRTC Z-order permutation.
"""

from __future__ import annotations

import numpy as np


def pad_block_grid(src: np.ndarray, pbr: int, pbc: int, col_pad: np.ndarray,
                   row_pad: np.ndarray, corner_pad: np.ndarray) -> np.ndarray:
    """Assemble a padded block grid (Compressor4x4Helper::Pad's byte
    movement, compressor4x4_helper.h:420-474).

    src: (nbr, nbc, bs) uint8; col_pad: (nbr, bs); row_pad: (nbc, bs);
    corner_pad: (bs,). Returns (pbr, pbc, bs) uint8.
    """
    nbr, nbc, bs = src.shape
    dst = np.empty((pbr, pbc, bs), dtype=np.uint8)
    dst[:nbr, :nbc] = src
    if pbc > nbc:
        dst[:nbr, nbc:] = col_pad[:, None, :]
    if pbr > nbr:
        dst[nbr:, :nbc] = row_pad[None, :, :]
        if pbc > nbc:
            dst[nbr:, nbc:] = corner_pad[None, None, :]
    return dst


def copy_subgrid(src: np.ndarray, r0: int, c0: int, nbr: int,
                 nbc: int) -> np.ndarray:
    """(src_nbr, src_nbc, bs) -> (nbr, nbc, bs) block sub-rectangle."""
    return np.ascontiguousarray(src[r0 : r0 + nbr, c0 : c0 + nbc])


def fill_blocks(n: int, block: np.ndarray) -> np.ndarray:
    """Replicate one block n times -> (n, bs) uint8."""
    block = np.ascontiguousarray(block, dtype=np.uint8).reshape(-1)
    return np.broadcast_to(block, (n, block.size)).copy()


def strided_copy_rows(src: np.ndarray, rows: int, row_bytes: int,
                      src_stride: int, dst_stride: int,
                      dst_size: int) -> np.ndarray:
    """Row-strided byte copy (image buffer <-> padded row buffer)."""
    src = np.ascontiguousarray(src.reshape(-1).view(np.uint8))
    dst = np.zeros(dst_size, dtype=np.uint8)
    for r in range(rows):
        dst[r * dst_stride : r * dst_stride + row_bytes] = src[
            r * src_stride : r * src_stride + row_bytes]
    return dst


def zorder_perm(nbx: int, nby: int) -> np.ndarray:
    """Z-order block permutation (FromZOrder, pvrtc_compressor.cc:80-86):
    perm[i] is the row-major block index of Z-order slot i, where x takes
    the odd bits of i and y the even bits. (nbx * nby,) int32."""
    n = nbx * nby
    i = np.arange(n, dtype=np.uint64)
    x = np.zeros(n, dtype=np.uint64)
    y = np.zeros(n, dtype=np.uint64)
    for j in range(16):
        x |= ((i >> np.uint64(j * 2 + 1)) & np.uint64(1)) << np.uint64(j)
        y |= ((i >> np.uint64(j * 2)) & np.uint64(1)) << np.uint64(j)
    return (y * nbx + x).astype(np.int32)
