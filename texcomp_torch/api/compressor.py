"""Compressor abstract interface.

Python equivalent of image_compression/public/compressor.h:48-138: the same
nine operations with the same bool-return error model. Input images are
8-bit, RGB (3 bytes/px) or RGBA (4 bytes/px), row-major interleaved, with
optional per-row padding bytes (compressor.h:19-26).

Buffers are numpy uint8 arrays or bytes (consumed as flat bytes).
``decompress`` fills a caller-provided ``bytearray`` so the out-parameter
semantics of the reference are preserved.
"""

from __future__ import annotations

import abc

import numpy as np

from texcomp_torch.api.container import CompressedImage, Format


class Compressor(abc.ABC):
    """Base interface for block-based texture compressors (compressor.h:48)."""

    @abc.abstractmethod
    def supports_format(self, fmt: Format) -> bool:
        """True if this compressor can compress images of ``fmt``
        (compressor.h:54)."""

    @abc.abstractmethod
    def is_valid_compressed_image(self, image: CompressedImage) -> bool:
        """Validate an instance for processing by this compressor
        (compressor.h:61)."""

    @abc.abstractmethod
    def compute_compressed_data_size(self, fmt: Format, height: int,
                                     width: int) -> int:
        """Payload size for an image of the given format/size
        (compressor.h:68)."""

    @abc.abstractmethod
    def compress(self, fmt: Format, height: int, width: int,
                 padding_bytes_per_row: int, buffer: np.ndarray | bytes,
                 image: CompressedImage) -> bool:
        """Compress ``buffer`` into ``image`` (compressor.h:77). False on
        error."""

    @abc.abstractmethod
    def decompress(self, image: CompressedImage,
                   decompressed_buffer: bytearray) -> bool:
        """Decompress into ``decompressed_buffer`` (resized as needed)
        (compressor.h:85). False on error."""

    @abc.abstractmethod
    def downsample(self, image: CompressedImage,
                   downsampled_image: CompressedImage) -> bool:
        """Half-size mipmap in the compressed domain (compressor.h:95)."""

    @abc.abstractmethod
    def pad(self, image: CompressedImage, padded_height: int,
            padded_width: int, padded_image: CompressedImage) -> bool:
        """Pad by replicating the last row/column (compressor.h:105)."""

    @abc.abstractmethod
    def compress_and_pad(self, fmt: Format, height: int, width: int,
                         padded_height: int, padded_width: int,
                         padding_bytes_per_row: int,
                         buffer: np.ndarray | bytes,
                         padded_image: CompressedImage) -> bool:
        """Fused compress + pad (compressor.h:114)."""

    @abc.abstractmethod
    def create_solid_image(self, fmt: Format, height: int, width: int,
                           color: np.ndarray | bytes,
                           image: CompressedImage) -> bool:
        """Create a solid-color compressed image (compressor.h:125)."""

    @abc.abstractmethod
    def copy_subimage(self, image: CompressedImage, start_row: int,
                      start_column: int, height: int, width: int,
                      subimage: CompressedImage) -> bool:
        """Copy a region of a compressed image (compressor.h:134)."""
