"""Shared grid-level operations for 4x4-block codecs.

The port of Compressor4x4Helper (image_compression/internal/
compressor4x4_helper.h:81-640): each codec operation is one image-level
device call on a tensor on the compressor's device, plus host-side
block-grid bookkeeping (numpy byte ops for pad/copy/solid, which are pure
memcpy shuffles in the reference too).

Codecs plug in through three callables:

  encode_image_fn(image, grid_height, grid_width) -> (N, block_size) uint8
      image: (h, w, C) uint8 tensor, channels in the format's own order
  decode_image_fn(data, height, width) -> (height, width, 4) uint8
      data: (N, block_size) uint8 tensor; height, width span the grid
  downsample_fn(data, nby, nbx) -> (nby * nbx / 4, block_size) uint8
      one fused mip level of an (nby, nbx) block grid, both even
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from texcomp_torch import native
from texcomp_torch.api.container import (
    CompressedImage,
    Format,
    Metadata,
    num_format_components,
)
from texcomp_torch.blocks import num_blocks
from texcomp_torch.ops.mipmap import mipmap_chain, num_chain_levels
from texcomp_torch.utils.profiling import span

EncodeImageFn = Callable[[torch.Tensor, int, int], torch.Tensor]
DecodeImageFn = Callable[[torch.Tensor, int, int], torch.Tensor]
DownsampleFn = Callable[[torch.Tensor, int, int], torch.Tensor]


def setup_compressed_image(
    image: CompressedImage,
    compressor_name: str,
    block_size: int,
    fmt: Format,
    height: int,
    width: int,
    padding_bytes_per_row: int,
) -> bool:
    """SetUpCompressedImage (compressor4x4_helper.cc:22-43)."""
    nbr = num_blocks(height)
    nbc = num_blocks(width)
    data_size = nbr * nbc * block_size
    metadata = Metadata(
        format=fmt,
        compressor_name=compressor_name,
        uncompressed_height=height,
        uncompressed_width=width,
        compressed_height=4 * nbr,
        compressed_width=4 * nbc,
        padding_bytes_per_row=padding_bytes_per_row,
    )
    if image.owns_data():
        image.create_owned_data(metadata, data_size)
    else:
        if image.get_data_size() != data_size:
            return False
        image.set_metadata(metadata)
    return True


def downsample_chain_tail(compressor, cur: CompressedImage,
                          results: list, levels: int | None) -> list:
    """Extend ``results`` with repeated compressor.downsample() calls until
    ``levels`` are collected, downsample fails, or a 1x1 level is reached
    (a 1x1 image downsamples to itself forever)."""
    while levels is None or len(results) < levels:
        cm = cur.get_metadata()
        if max(cm.uncompressed_height, cm.uncompressed_width) <= 1:
            break
        nxt = CompressedImage()
        if not compressor.downsample(cur, nxt):
            break
        results.append(nxt)
        cur = nxt
    return results


def downsample_chain(compressor, image: CompressedImage, levels: int | None,
                     *, block_size: int, codec: str, device: torch.device,
                     strategy: int = 2, fused_ok: bool = True) -> list:
    """The mip chain of ``image``, byte-equal to repeated downsample calls:
    the prefix of levels with even block counts as one fused op per level
    on ``device`` (ops/mipmap.py), chained through the payload with no
    host copy between levels, then the rest level by level."""
    if not compressor.is_valid_compressed_image(image):
        return []
    md = image.get_metadata()
    h, w = md.uncompressed_height, md.uncompressed_width
    results: list[CompressedImage] = []

    fused = 0
    if fused_ok and h % 4 == 0 and w % 4 == 0:
        fused = num_chain_levels(h, w)
        if levels is not None:
            fused = min(fused, levels)
    if fused > 0:
        data = _payload_blocks(image, block_size, num_blocks(h),
                               num_blocks(w), device)
        payloads = mipmap_chain(data, height=h, width=w, codec=codec,
                                levels=fused, strategy=strategy)
        lh, lw = h, w
        for p in payloads:
            lh //= 2
            lw //= 2
            ci = CompressedImage()
            if not setup_compressed_image(
                    ci, compressor.name, block_size, md.format, lh, lw, 0):
                return results
            ci.get_mutable_data()[:] = p.cpu().numpy().reshape(-1)
            results.append(ci)

    return downsample_chain_tail(
        compressor, results[-1] if results else image, results, levels)


def buffer_to_image_array(
    buffer, height: int, width: int, components: int, padding_bytes_per_row: int
) -> np.ndarray:
    """View a row-padded interleaved byte buffer as an (H, W, C) uint8 array
    (the input contract of compressor.h:19-26 / pixel4x4.h:45-67)."""
    flat = np.frombuffer(buffer, dtype=np.uint8) if not isinstance(
        buffer, np.ndarray
    ) else buffer.reshape(-1).view(np.uint8)
    bpr = width * components + padding_bytes_per_row
    needed = (height - 1) * bpr + width * components
    if flat.size < needed:
        raise ValueError(
            f"buffer has {flat.size} bytes; need {needed} for "
            f"{height}x{width}x{components} (+{padding_bytes_per_row}/row)"
        )
    rows = np.lib.stride_tricks.as_strided(
        flat, shape=(height, width * components), strides=(bpr, 1)
    )
    return rows.reshape(height, width, components)


def image_array_to_buffer(
    image: np.ndarray, padding_bytes_per_row: int
) -> np.ndarray:
    """(H, W, C) uint8 -> flat byte buffer with per-row padding (zeros in the
    padding gap). Size is (H-1)*stride + W*C: rows at the padded stride, with
    no trailing padding after the final row.

    The reference's Decompress sizes its output H*W*C but writes rows at the
    padded stride (compressor4x4_helper.h:225-226 vs :238-239), which
    overflows for padding > 0; the buffer is sized correctly here instead.
    For padding == 0 (the only well-defined case) the bytes are identical.
    """
    h, w, c = image.shape
    if padding_bytes_per_row == 0:
        return image.reshape(-1).copy()
    bpr = w * c + padding_bytes_per_row
    return native.strided_copy_rows(
        image, rows=h, row_bytes=w * c, src_stride=w * c, dst_stride=bpr,
        dst_size=(h - 1) * bpr + w * c,
    )


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. Strided views and read-only
    buffers are first copied into a contiguous writable array."""
    array = np.require(array, dtype=np.uint8, requirements=["C", "W"])
    return torch.from_numpy(array).to(device)


def _payload_blocks(image: CompressedImage, block_size: int, nbr: int,
                    nbc: int, device: torch.device) -> torch.Tensor:
    """The first nbr*nbc blocks of the payload, as a tensor on ``device``.

    The reference reads blocks sequentially over the uncompressed block
    grid (compressor4x4_helper.h:241-245, `*block++`), so a payload that
    covers a larger (padded) grid contributes only its first nbr*nbc blocks.
    """
    data = image.get_data().reshape(-1, block_size)[: nbr * nbc]
    return _to_device(data, device)


def _grid_view(image: CompressedImage, block_size: int) -> np.ndarray:
    """View a compressed payload as (num_block_rows, num_block_cols,
    block_size) using the compressed dimensions."""
    md = image.get_metadata()
    nbr = num_blocks(md.compressed_height)
    nbc = num_blocks(md.compressed_width)
    return image.get_mutable_data().reshape(nbr, nbc, block_size)


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------


def compress(
    encode_image_fn: EncodeImageFn,
    compressor_name: str,
    block_size: int,
    fmt: Format,
    height: int,
    width: int,
    padding_bytes_per_row: int,
    buffer,
    image: CompressedImage,
    device: torch.device,
    *,
    padded_height: int = 0,
    padded_width: int = 0,
) -> bool:
    """Compress (and optionally pad) an image in one image-level encode.

    Covers both Compressor4x4Helper::Compress (compressor4x4_helper.h:
    175-216) and ::CompressAndPad (:479-520): the padded variant encodes
    over a larger block grid, where overhanging blocks replicate edge
    pixels and blocks wholly outside are has_one_pixel.
    """
    with span("texcomp.api.compress"):
        final_height = max(height, padded_height)
        final_width = max(width, padded_width)
        if not setup_compressed_image(
            image, compressor_name, block_size, fmt, final_height,
            final_width, padding_bytes_per_row,
        ):
            return False

        with span("texcomp.api.upload"):
            img = _to_device(buffer_to_image_array(
                buffer, height, width, num_format_components(fmt),
                padding_bytes_per_row,
            ), device)
        encoded = encode_image_fn(img, final_height, final_width)
        # The one place the host waits for the card: its backlog, then the
        # copy back.
        with span("texcomp.api.download"):
            encoded = encoded.cpu()
        image.get_mutable_data()[:] = encoded.numpy().reshape(-1)
        return True


def decompress(
    decode_image_fn: DecodeImageFn,
    image: CompressedImage,
    decompressed_buffer: bytearray,
    block_size: int,
    device: torch.device,
) -> bool:
    """Compressor4x4Helper::Decompress (compressor4x4_helper.h:218-262):
    one image-level decode, clipped to the uncompressed extent."""
    md = image.get_metadata()
    nbr = num_blocks(md.uncompressed_height)
    nbc = num_blocks(md.uncompressed_width)
    data = _payload_blocks(image, block_size, nbr, nbc, device)
    out = decode_image_fn(data, 4 * nbr, 4 * nbc)
    out = out[: md.uncompressed_height, : md.uncompressed_width,
              : num_format_components(md.format)]
    buf = image_array_to_buffer(np.ascontiguousarray(out.cpu().numpy()),
                                md.padding_bytes_per_row)
    decompressed_buffer[:] = buf.tobytes()
    return True


def downsample(
    encode_image_fn: EncodeImageFn,
    decode_image_fn: DecodeImageFn,
    downsample_fn: DownsampleFn,
    image: CompressedImage,
    downsampled_image: CompressedImage,
    block_size: int,
    device: torch.device,
) -> bool:
    """Compressor4x4Helper::Downsample (compressor4x4_helper.h:264-391).

    A grid of more than one block in each direction takes one fused
    downsample call. A grid of a single block row or column is decoded to
    an image, 2x2-averaged, tiled (the reference stores each downsampled
    2x2 at two positions, :357-379 and :618-633) and re-encoded. The
    callables must not swap red and blue: the reference decodes and
    re-encodes swap-free here (:602-607).
    """
    md = image.get_metadata()
    nbr = num_blocks(md.uncompressed_height)
    nbc = num_blocks(md.uncompressed_width)
    # Even block counts required except the single-block special case
    # (compressor4x4_helper.h:281-284).
    if (nbr > 1 and nbr % 2 != 0) or (nbc > 1 and nbc % 2 != 0):
        return False

    orig_height = md.uncompressed_height
    orig_width = md.uncompressed_width
    if not setup_compressed_image(
        downsampled_image, md.compressor_name, block_size, md.format,
        (orig_height + 1) // 2, (orig_width + 1) // 2, 0,
    ):
        return False

    data = _payload_blocks(image, block_size, nbr, nbc, device)
    if nbr > 1 and nbc > 1:
        encoded = downsample_fn(data, nbr, nbc)
        downsampled_image.get_mutable_data()[:] = encoded.cpu().numpy().reshape(-1)
        return True

    c = num_format_components(md.format)
    img = decode_image_fn(data, 4 * nbr, 4 * nbc)[:, :, :c].to(torch.int32)

    if nbr == 1 and nbc == 1:
        # Single-block case (compressor4x4_helper.h:344-388): a 3-pixel
        # dimension cannot be downsampled; 1- and 2-pixel dimensions
        # replicate before averaging.
        if orig_height == 3 or orig_width == 3:
            return False
        if orig_width == 1:
            img[:, 1:4] = img[:, 0:1]
        elif orig_width == 2:
            img[:, 2:4] = img[:, 0:2]
        if orig_height == 1:
            img[1:4, :] = img[0:1, :]
        elif orig_height == 2:
            img[2:4, :] = img[0:2, :]

    # 2x2 truncating average (color_util.h:335-380).
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    avg = img.reshape(h2, 2, w2, 2, c).sum(dim=(1, 3)) // 4

    # Tile to fill 4x4 blocks where a grid dimension had one block
    # (DownsampleBlocks2x1/1x2, compressor4x4_helper.h:610-636).
    if avg.shape[1] < 4:
        avg = avg.repeat(1, 4 // avg.shape[1], 1)
    if avg.shape[0] < 4:
        avg = avg.repeat(4 // avg.shape[0], 1, 1)

    encoded = encode_image_fn(avg.to(torch.uint8), avg.shape[0], avg.shape[1])
    downsampled_image.get_mutable_data()[:] = encoded.cpu().numpy().reshape(-1)
    return True


def pad(
    column_pad_fn: Callable[[np.ndarray], np.ndarray],
    row_pad_fn: Callable[[np.ndarray], np.ndarray],
    corner_pad_fn: Callable[[np.ndarray], np.ndarray],
    image: CompressedImage,
    padded_height: int,
    padded_width: int,
    padded_image: CompressedImage,
    block_size: int,
) -> bool:
    """Compressor4x4Helper::Pad (compressor4x4_helper.h:393-477).

    The pad functors are batched: they map (M, block_size) uint8 arrays of
    last-column / last-row / corner blocks to their pad blocks.
    """
    md = image.get_metadata()
    if md.compressed_height >= padded_height and md.compressed_width >= padded_width:
        padded_image.duplicate(image)
        return True

    if not setup_compressed_image(
        padded_image, md.compressor_name, block_size, md.format,
        padded_height, padded_width, 0,
    ):
        return False

    orig = _grid_view(image, block_size)
    out = _grid_view(padded_image, block_size)
    nbr, nbc = orig.shape[0], orig.shape[1]
    pbr, pbc = out.shape[0], out.shape[1]

    col_pad = (column_pad_fn(orig[:, nbc - 1]) if nbc < pbc
               else np.zeros((nbr, block_size), np.uint8))
    if nbr < pbr:
        row_pad = row_pad_fn(orig[nbr - 1])
        corner = (corner_pad_fn(orig[nbr - 1 : nbr, nbc - 1])[0]
                  if nbc < pbc else np.zeros(block_size, np.uint8))
    else:
        row_pad = np.zeros((nbc, block_size), np.uint8)
        corner = np.zeros(block_size, np.uint8)
    out[:] = native.pad_block_grid(orig, pbr, pbc, col_pad, row_pad, corner)
    return True


def create_solid_image(
    compressor_name: str,
    fmt: Format,
    height: int,
    width: int,
    block_bytes: np.ndarray,
    image: CompressedImage,
) -> bool:
    """Compressor4x4Helper::CreateSolidImage (compressor4x4_helper.h:522-543)."""
    block_size = int(block_bytes.size)
    if not setup_compressed_image(
        image, compressor_name, block_size, fmt, height, width, 0
    ):
        return False
    data = image.get_mutable_data()
    n = data.size // block_size
    data.reshape(-1, block_size)[:] = native.fill_blocks(n, block_bytes)
    return True


def copy_subimage(
    image: CompressedImage,
    start_row: int,
    start_column: int,
    height: int,
    width: int,
    subimage: CompressedImage,
    block_size: int,
) -> bool:
    """Compressor4x4Helper::CopySubimage (compressor4x4_helper.h:545-592)."""
    md = image.get_metadata()
    if (
        start_row % 4 != 0
        or start_column % 4 != 0
        or height % 4 != 0
        or width % 4 != 0
        or start_row > md.compressed_height
        or start_column > md.compressed_width
        or start_row + height > md.compressed_height
        or start_column + width > md.compressed_width
    ):
        return False
    if not setup_compressed_image(
        subimage, md.compressor_name, block_size, md.format, height, width, 0
    ):
        return False
    orig = _grid_view(image, block_size)
    sub = _grid_view(subimage, block_size)
    sub[:] = native.copy_subgrid(orig, num_blocks(start_row),
                                 num_blocks(start_column), sub.shape[0],
                                 sub.shape[1])
    return True
