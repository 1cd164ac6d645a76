"""Batched block gather/scatter.

The reference gathers one 4x4 window at a time into a ``Pixel4x4`` with
clamp-to-edge replication for windows overhanging the image
(pixel4x4.cc:23-59). Here the whole block grid is gathered at once through
clamped row and column indices (torch's ``replicate`` pad does not take
uint8) and reshaped to an (N, 16, C) batch: the same pixels in the same
scan order.
"""

from __future__ import annotations

import torch


def num_blocks(num_pixels: int) -> int:
    """Blocks needed to cover num_pixels (compressor4x4_helper.h:86-88)."""
    return (int(num_pixels) + 3) // 4


def extract_blocks(
    image: torch.Tensor,
    *,
    height: int,
    width: int,
    grid_height: int | None = None,
    grid_width: int | None = None,
) -> torch.Tensor:
    """Gather an image into a batch of 4x4 blocks.

    Args:
      image: (>=height, >=width, C) uint8 tensor.
      height, width: the valid image extent.
      grid_height, grid_width: pixel extent of the block grid; defaults to
        the image extent rounded up to multiples of 4. A larger grid
        reproduces CompressAndPad's encode over the padded grid
        (compressor4x4_helper.h:479-520), where blocks fully outside the
        image replicate the nearest edge or corner pixel.

    Returns:
      (num_block_rows * num_block_cols, 16, C) int32 on the image's device,
      blocks in row-major order, pixels within a block in row-major order
      (y*4 + x), the reference's scan order (pixel4x4.h:54-61).
    """
    gh = 4 * num_blocks(grid_height if grid_height is not None else height)
    gw = 4 * num_blocks(grid_width if grid_width is not None else width)
    c = image.shape[-1]
    # Pixel4x4's min(row+y, height-1) / min(col+x, width-1) clamping
    # (pixel4x4.cc:44-53).
    ys = torch.arange(gh, device=image.device).clamp_(max=height - 1)
    xs = torch.arange(gw, device=image.device).clamp_(max=width - 1)
    img = image.index_select(0, ys).index_select(1, xs).to(torch.int32)
    blocks = img.reshape(gh // 4, 4, gw // 4, 4, c).permute(0, 2, 1, 3, 4)
    return blocks.reshape(-1, 16, c)


def image_to_blocks(image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8 -> (N, 16, C) int32 for aligned images (H and W
    multiples of 4). Ragged sizes go through :func:`extract_blocks`."""
    h, w, c = image.shape
    blk = image.to(torch.int32).reshape(h // 4, 4, w // 4, 4, c)
    return blk.permute(0, 2, 1, 3, 4).reshape(-1, 16, c)


def full_outside_mask(height: int, width: int, grid_height: int,
                      grid_width: int, *, device) -> torch.Tensor:
    """Per-block ``has_one_pixel`` flag (pixel4x4.cc:56-58): True iff the
    block's 4x4 window lies fully outside the valid image in both
    dimensions, so every gathered pixel is the replicated corner pixel.

    Returns (num_block_rows * num_block_cols,) bool, row-major block order.
    """
    row_out = torch.arange(num_blocks(grid_height), device=device) * 4 >= height
    col_out = torch.arange(num_blocks(grid_width), device=device) * 4 >= width
    return (row_out[:, None] & col_out[None, :]).reshape(-1)


def scatter_blocks(blocks: torch.Tensor, *, height: int,
                   width: int) -> torch.Tensor:
    """Inverse of :func:`extract_blocks`: write a block batch into an image,
    clipping blocks that overhang the uncompressed extent (the decode
    write-back of compressor4x4_helper.h:241-259).

    Args:
      blocks: (num_block_rows * num_block_cols, 16, C) integer tensor; the
        grid must be num_blocks(height) x num_blocks(width).
      height, width: the image extent to produce.

    Returns:
      (height, width, C) uint8.
    """
    nbr = num_blocks(height)
    nbc = num_blocks(width)
    c = blocks.shape[-1]
    img = blocks.reshape(nbr, nbc, 4, 4, c).permute(0, 2, 1, 3, 4)
    img = img.reshape(nbr * 4, nbc * 4, c)
    return img[:height, :width].to(torch.uint8)
