"""Block engine: batched 4x4 block gather/scatter and grid geometry."""

from texcomp_torch.blocks.grid import (
    extract_blocks,
    full_outside_mask,
    image_to_blocks,
    num_blocks,
    scatter_blocks,
)

__all__ = ["extract_blocks", "full_outside_mask", "image_to_blocks",
           "num_blocks", "scatter_blocks"]
