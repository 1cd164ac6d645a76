"""DxtcCompressor: DXT1 (RGB/BGR) and DXT5 (RGBA/BGRA).

Public behavior mirrors image_compression/public/dxtc_compressor.h:52-83 and
the dispatch logic of internal/dxtc_compressor.cc:704-855: 3-component
formats use DXT1 (8-byte blocks), 4-component formats DXT5 (16-byte blocks).

Every encode, decode and fused downsample runs through the image ops of
``texcomp_torch.ops.dxt_cuda`` on the compressor's device: the CUDA
kernels on a CUDA device, their plain PyTorch twins on the CPU. With
``quality="high"`` the encode is ``codecs.dxt_hq``'s image route, whose
cluster fit and reference candidate are kernels on a CUDA device too.
"""

from __future__ import annotations

import numpy as np
import torch

from texcomp_torch.api import helper4x4 as h4
from texcomp_torch.api.compressor import Compressor
from texcomp_torch.api.container import (
    CompressedImage,
    Format,
    needs_red_and_blue_swapped,
    num_format_components,
)
from texcomp_torch.blocks import num_blocks
from texcomp_torch.codecs import dxt, dxt_hq
from texcomp_torch.ops import dxt_cuda

_DXT1_BLOCK_SIZE = 8
_DXT5_BLOCK_SIZE = 16


class DxtcCompressor(Compressor):
    """DXT1/DXT5 compressor (dxtc_compressor.h:52-83).

    Args:
      quality: "reference" (default), byte-identical to the C++ reference;
        or "high", texcomp's extension (PCA, least squares, the cluster
        fit, a 3-colour candidate, the DXT5 alpha search; per block never
        worse than the reference, payloads standard DXT), byte-identical
        to texcomp's. It changes the encodes only: compress,
        compress_and_pad and the re-encode of downsample.
      device: the torch device that encodes and decodes; the card unless
        the caller passes "cpu". Nothing falls back to another device: a
        CUDA device on a machine without one raises at the first
        operation.
    """

    name = "dxtc"

    def __init__(self, quality: str = "reference", *, device="cuda"):
        if quality not in ("reference", "high"):
            raise ValueError(f"unknown quality {quality!r}")
        self._quality = quality
        self._device = torch.device(device)

    def _is_dxt1(self, fmt: Format) -> bool:
        return num_format_components(fmt) == 3

    def _block_size(self, fmt: Format) -> int:
        return _DXT1_BLOCK_SIZE if self._is_dxt1(fmt) else _DXT5_BLOCK_SIZE

    def _encode_image_fn(self, fmt: Format, swap: bool):
        is_dxt1 = self._is_dxt1(fmt)
        if self._quality == "high":
            hq = (dxt_hq.encode_dxt1_hq_image if is_dxt1
                  else dxt_hq.encode_dxt5_hq_image)

            def fn(image, grid_height, grid_width):
                return hq(image, swap, grid_height=grid_height,
                          grid_width=grid_width)
        else:
            def fn(image, grid_height, grid_width):
                return dxt_cuda.dxtc_encode_padded_image(
                    image, grid_height, grid_width, swap, is_dxt1)

        return fn

    def _decode_image_fn(self, fmt: Format, swap: bool):
        decode = (dxt_cuda.dxt1_decode_image if self._is_dxt1(fmt)
                  else dxt_cuda.dxt5_decode_image)

        def fn(data, height, width):
            return decode(data, height=height, width=width, swap=swap)

        return fn

    def _downsample_fn(self, fmt: Format):
        """One mip level, swap-free: the fused kernel, or for
        ``quality="high"`` decode, 2x2 average and the HQ encode."""
        is_dxt1 = self._is_dxt1(fmt)
        if self._quality == "high":
            decode = self._decode_image_fn(fmt, False)
            encode = self._encode_image_fn(fmt, False)
            channels = 3 if is_dxt1 else 4

            def fn(data, nby, nbx):
                image = decode(data, 4 * nby, 4 * nbx)[:, :, :channels]
                return encode(dxt_cuda.average_2x2(image), 2 * nby, 2 * nbx)
        else:
            def fn(data, nby, nbx):
                return dxt_cuda.dxtc_downsample_encode(data, nby=nby, nbx=nbx,
                                                       is_dxt1=is_dxt1)

        return fn

    # -- Compressor interface -------------------------------------------------

    def supports_format(self, fmt: Format) -> bool:
        """DXTC supports all formats (dxtc_compressor.cc:707-710)."""
        return True

    def is_valid_compressed_image(self, image: CompressedImage) -> bool:
        """dxtc_compressor.cc:712-723."""
        md = image.get_metadata()
        return (
            md.compressor_name == self.name
            and md.uncompressed_height > 0
            and md.uncompressed_width > 0
            and md.compressed_height >= md.uncompressed_height
            and md.compressed_width >= md.uncompressed_width
            and image.get_data_size()
            == self.compute_compressed_data_size(
                md.format, md.compressed_height, md.compressed_width
            )
        )

    def compute_compressed_data_size(self, fmt: Format, height: int,
                                     width: int) -> int:
        """dxtc_compressor.cc:725-733."""
        if height == 0 or width == 0:
            return 0
        return (
            max(1, num_blocks(height))
            * max(1, num_blocks(width))
            * self._block_size(fmt)
        )

    def compress(self, fmt, height, width, padding_bytes_per_row, buffer,
                 image) -> bool:
        if buffer is None or image is None or height == 0 or width == 0:
            return False
        return h4.compress(
            self._encode_image_fn(fmt, needs_red_and_blue_swapped(fmt)),
            self.name, self._block_size(fmt), fmt, height, width,
            padding_bytes_per_row, buffer, image, self._device,
        )

    def decompress(self, image, decompressed_buffer) -> bool:
        if not self.is_valid_compressed_image(image) or decompressed_buffer is None:
            return False
        fmt = image.get_metadata().format
        return h4.decompress(
            self._decode_image_fn(fmt, needs_red_and_blue_swapped(fmt)),
            image, decompressed_buffer, self._block_size(fmt), self._device)

    def downsample(self, image, downsampled_image) -> bool:
        if not self.is_valid_compressed_image(image) or downsampled_image is None:
            return False
        fmt = image.get_metadata().format
        # Downsample decodes and re-encodes with swap_red_and_blue=false
        # (compressor4x4_helper.h:602-607).
        return h4.downsample(
            self._encode_image_fn(fmt, False), self._decode_image_fn(fmt, False),
            self._downsample_fn(fmt), image, downsampled_image,
            self._block_size(fmt), self._device)

    def downsample_chain(self, image, levels: int | None = None) -> list:
        """The whole mip chain in one call: [level 1, level 2, ...], each
        byte-equal to repeated :meth:`downsample` calls. The levels with
        even block counts run as one fused kernel each, chained on the
        device; the tail runs level by level. Swapped formats and
        ``quality="high"`` go level by level all the way, as texcomp's
        chain does (the fused_ok guard of texcomp/api/dxtc.py)."""
        if not self.is_valid_compressed_image(image):
            return []
        fmt = image.get_metadata().format
        return h4.downsample_chain(
            self, image, levels, block_size=self._block_size(fmt),
            codec="dxt1" if self._is_dxt1(fmt) else "dxt5",
            device=self._device,
            fused_ok=(self._quality == "reference"
                      and not needs_red_and_blue_swapped(fmt)))

    def pad(self, image, padded_height, padded_width, padded_image) -> bool:
        if not self.is_valid_compressed_image(image) or padded_image is None:
            return False
        fmt = image.get_metadata().format
        if self._is_dxt1(fmt):
            fns = (dxt.dxt1_column_pad_blocks, dxt.dxt1_row_pad_blocks,
                   dxt.dxt1_corner_pad_blocks)
        else:
            fns = (dxt.dxt5_column_pad_blocks, dxt.dxt5_row_pad_blocks,
                   dxt.dxt5_corner_pad_blocks)
        return h4.pad(*fns, image, padded_height, padded_width, padded_image,
                      self._block_size(fmt))

    def compress_and_pad(self, fmt, height, width, padded_height, padded_width,
                         padding_bytes_per_row, buffer, padded_image) -> bool:
        if buffer is None or padded_image is None or height == 0 or width == 0:
            return False
        return h4.compress(
            self._encode_image_fn(fmt, needs_red_and_blue_swapped(fmt)),
            self.name, self._block_size(fmt), fmt, height, width,
            padding_bytes_per_row, buffer, padded_image, self._device,
            padded_height=padded_height, padded_width=padded_width,
        )

    def create_solid_image(self, fmt, height, width, color, image) -> bool:
        """dxtc_compressor.cc:820-839: the solid block stores the quantized
        565 color twice with zero index bits; DXT5 adds equal base alphas and
        zero alpha codes. No red/blue swap is applied (matching the
        reference, which passes color[0..2] straight through)."""
        if image is None:
            return False
        color = np.frombuffer(bytes(color), dtype=np.uint8) if not isinstance(
            color, np.ndarray
        ) else color
        r, g, b = int(color[0]), int(color[1]), int(color[2])
        q565 = dxt._pack565(*dxt._quantize565(r, g, b))
        dxt1 = np.array(
            [q565 & 0xFF, q565 >> 8, q565 & 0xFF, q565 >> 8, 0, 0, 0, 0],
            dtype=np.uint8,
        )
        if self._is_dxt1(fmt):
            block = dxt1
        else:
            a = int(color[3])
            block = np.concatenate(
                [np.array([a, a, 0, 0, 0, 0, 0, 0], dtype=np.uint8), dxt1]
            )
        return h4.create_solid_image(self.name, fmt, height, width, block, image)

    def copy_subimage(self, image, start_row, start_column, height, width,
                      subimage) -> bool:
        if not self.is_valid_compressed_image(image) or subimage is None:
            return False
        fmt = image.get_metadata().format
        return h4.copy_subimage(image, start_row, start_column, height, width,
                                subimage, self._block_size(fmt))
