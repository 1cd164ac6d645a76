"""EtcCompressor: ETC1 (RGB only).

Public behavior mirrors image_compression/public/etc_compressor.h:53-109
and internal/etc_compressor.cc:706-824: RGB only, 8-byte blocks, and a
per-instance compression strategy (the reference's only runtime setting,
etc_compressor.h:71-76, default kSmallerError).

Every encode, decode, fused downsample and pad block runs through the image
ops of ``texcomp_torch.ops.etc_cuda`` on the compressor's device: the CUDA
kernels on a CUDA device, their plain PyTorch twins on the CPU; with
``quality="high"`` the encodes take the HQ search
(``etc_cuda.etc1_hq_encode_padded_image``).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from texcomp_torch.api import helper4x4 as h4
from texcomp_torch.api.compressor import Compressor
from texcomp_torch.api.container import CompressedImage, Format
from texcomp_torch.blocks import num_blocks
from texcomp_torch.codecs import etc
from texcomp_torch.ops import dxt_cuda, etc_cuda

_BLOCK_SIZE = 8


class CompressionStrategy(enum.IntEnum):
    """ETC encode strategies (etc_compressor.h:57-66)."""

    SPLIT_HORIZONTALLY = etc.SPLIT_HORIZONTALLY
    SPLIT_VERTICALLY = etc.SPLIT_VERTICALLY
    SMALLER_ERROR = etc.SMALLER_ERROR
    HEURISTIC = etc.HEURISTIC


class EtcCompressor(Compressor):
    """ETC1 compressor (etc_compressor.h:53-109).

    Args:
      strategy: the encode strategy (default SMALLER_ERROR).
      quality: "reference" (default), byte-identical to the C++ reference
        under the strategy; or "high", texcomp's extension (some 40
        candidate base pairs per flip, two least-squares refits and +-1
        probes, all through the exhaustive codeword search; never worse
        than SMALLER_ERROR, payloads standard ETC1), byte-identical to
        texcomp's. It changes compress, compress_and_pad and the
        re-encode of downsample; pad keeps the strategy's reference
        encoder, as texcomp does.
      device: the torch device that encodes and decodes; the card unless
        the caller passes "cpu". Nothing falls back to another device: a
        CUDA device on a machine without one raises at the first
        operation.
    """

    name = "etc"

    def __init__(
        self, strategy: CompressionStrategy = CompressionStrategy.SMALLER_ERROR,
        quality: str = "reference", *, device="cuda",
    ):
        if quality not in ("reference", "high"):
            raise ValueError(f"unknown quality {quality!r}")
        self._quality = quality
        self._strategy = int(CompressionStrategy(strategy))
        self._device = torch.device(device)

    def set_compression_strategy(self, strategy: CompressionStrategy) -> None:
        """etc_compressor.h:71-76."""
        self._strategy = int(CompressionStrategy(strategy))

    def get_compression_strategy(self) -> CompressionStrategy:
        return CompressionStrategy(self._strategy)

    def _encode_image_fn(self):
        if self._quality == "high":
            return etc_cuda.etc1_hq_encode_padded_image
        strategy = self._strategy

        def fn(image, grid_height, grid_width):
            return etc_cuda.etc1_encode_padded_image(image, grid_height,
                                                     grid_width, strategy)

        return fn

    @staticmethod
    def _decode_image_fn(data, height, width):
        return etc_cuda.etc1_decode_image(data, height=height, width=width)

    def _downsample_fn(self):
        """One mip level: the fused kernel, or for ``quality="high"``
        decode, 2x2 average and the HQ encode."""
        if self._quality == "high":
            def fn(data, nby, nbx):
                image = self._decode_image_fn(data, 4 * nby, 4 * nbx)
                return etc_cuda.etc1_hq_encode_padded_image(
                    dxt_cuda.average_2x2(image[:, :, :3]), 2 * nby, 2 * nbx)

            return fn
        strategy = self._strategy

        def fn(data, nby, nbx):
            return etc_cuda.etc1_downsample_encode(data, nby=nby, nbx=nbx,
                                                   strategy=strategy)

        return fn

    def _on_device(self, fn):
        """A pad functor over (M, 8) uint8 numpy blocks that runs ``fn`` on
        the compressor's device."""
        def run(blocks: np.ndarray) -> np.ndarray:
            data = torch.from_numpy(np.ascontiguousarray(blocks)).to(self._device)
            return fn(data).cpu().numpy()

        return run

    # -- Compressor interface -------------------------------------------------

    def supports_format(self, fmt: Format) -> bool:
        """ETC is RGB-only (etc_compressor.cc:713-717)."""
        return fmt == Format.RGB

    def is_valid_compressed_image(self, image: CompressedImage) -> bool:
        """etc_compressor.cc:719-732."""
        md = image.get_metadata()
        return (
            md.format == Format.RGB
            and md.compressor_name == self.name
            and md.uncompressed_height > 0
            and md.uncompressed_width > 0
            and md.compressed_height >= md.uncompressed_height
            and md.compressed_width >= md.uncompressed_width
            and image.get_data_size()
            == num_blocks(md.compressed_height)
            * num_blocks(md.compressed_width)
            * _BLOCK_SIZE
        )

    def compute_compressed_data_size(self, fmt, height, width) -> int:
        """etc_compressor.cc:734-745."""
        if height == 0 or width == 0 or fmt != Format.RGB:
            return 0
        return max(1, num_blocks(height)) * max(1, num_blocks(width)) * _BLOCK_SIZE

    def compress(self, fmt, height, width, padding_bytes_per_row, buffer,
                 image) -> bool:
        if (buffer is None or image is None or height == 0 or width == 0
                or fmt != Format.RGB):
            return False
        return h4.compress(
            self._encode_image_fn(), self.name, _BLOCK_SIZE, fmt, height,
            width, padding_bytes_per_row, buffer, image, self._device)

    def decompress(self, image, decompressed_buffer) -> bool:
        if not self.is_valid_compressed_image(image) or decompressed_buffer is None:
            return False
        return h4.decompress(self._decode_image_fn, image, decompressed_buffer,
                             _BLOCK_SIZE, self._device)

    def downsample(self, image, downsampled_image) -> bool:
        if not self.is_valid_compressed_image(image) or downsampled_image is None:
            return False
        return h4.downsample(
            self._encode_image_fn(), self._decode_image_fn,
            self._downsample_fn(), image, downsampled_image, _BLOCK_SIZE,
            self._device)

    def downsample_chain(self, image, levels: int | None = None) -> list:
        """The whole mip chain in one call: [level 1, level 2, ...], each
        byte-equal to repeated :meth:`downsample` calls. The levels with
        even block counts run as one fused kernel each, chained on the
        device; the tail runs level by level, and ``quality="high"`` all
        of it."""
        return h4.downsample_chain(
            self, image, levels, block_size=_BLOCK_SIZE, codec="etc1",
            device=self._device, strategy=self._strategy,
            fused_ok=self._quality == "reference")

    def pad(self, image, padded_height, padded_width, padded_image) -> bool:
        if not self.is_valid_compressed_image(image) or padded_image is None:
            return False
        strategy = self._strategy
        return h4.pad(
            self._on_device(
                lambda d: etc_cuda.etc1_edge_pad_blocks(d, "column", strategy)),
            self._on_device(
                lambda d: etc_cuda.etc1_edge_pad_blocks(d, "row", strategy)),
            self._on_device(etc_cuda.etc1_corner_pad_blocks),
            image, padded_height, padded_width, padded_image, _BLOCK_SIZE)

    def compress_and_pad(self, fmt, height, width, padded_height, padded_width,
                         padding_bytes_per_row, buffer, padded_image) -> bool:
        if (buffer is None or padded_image is None or height == 0 or width == 0
                or fmt != Format.RGB):
            return False
        return h4.compress(
            self._encode_image_fn(), self.name, _BLOCK_SIZE, fmt, height,
            width, padding_bytes_per_row, buffer, padded_image, self._device,
            padded_height=padded_height, padded_width=padded_width)

    def create_solid_image(self, fmt, height, width, color, image) -> bool:
        """etc_compressor.cc:802-813."""
        if image is None or fmt != Format.RGB:
            return False
        color = np.frombuffer(bytes(color), dtype=np.uint8) if not isinstance(
            color, np.ndarray
        ) else color
        block = etc.create_solid_block_bytes(int(color[0]), int(color[1]),
                                             int(color[2]))
        return h4.create_solid_image(self.name, fmt, height, width, block,
                                     image)

    def copy_subimage(self, image, start_row, start_column, height, width,
                      subimage) -> bool:
        if not self.is_valid_compressed_image(image) or subimage is None:
            return False
        return h4.copy_subimage(image, start_row, start_column, height, width,
                                subimage, _BLOCK_SIZE)
