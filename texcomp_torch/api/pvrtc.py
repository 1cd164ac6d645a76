"""PvrtcCompressor: PVRTC v1 2BPP RGBA, and Pvrtc4bppCompressor, its 4BPP
extension.

Mirrors image_compression/public/pvrtc_compressor.h:71-104 and
internal/pvrtc_compressor.cc:605-705: encode-only in the reference —
Decompress/Downsample/Pad/CompressAndPad/CreateSolidImage/CopySubimage all
return false (:669-705). A decode extension is available separately via
``decompress_extension`` (the reference cannot decode; see
pvrtc_compressor.h:62-67).

The 2BPP encode runs through ``texcomp_torch.ops.pvrtc_cuda`` on the
compressor's device: the three CUDA kernels on a CUDA device, their plain
PyTorch twins on the CPU. ``quality="high"`` runs ``codecs.pvrtc_hq``
(whose 2BPP reference arm is that same encode). The decode extension and
the 4BPP codec are plain PyTorch on either device (texcomp runs them
outside any Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from texcomp_torch.api import helper4x4 as h4
from texcomp_torch.api.compressor import Compressor
from texcomp_torch.api.container import CompressedImage, Format, Metadata
from texcomp_torch.codecs import pvrtc, pvrtc4, pvrtc_hq
from texcomp_torch.ops import pvrtc_cuda
from texcomp_torch.utils.profiling import span


def _is_power_of_two(x: int) -> bool:
    return x != 0 and (x & (x - 1)) == 0


def _check_quality(quality: str) -> None:
    if quality not in ("reference", "high"):
        raise ValueError(f"unknown quality {quality!r}")


class _PvrtcBase(Compressor):
    """What the 2BPP and 4BPP compressors share: RGBA only, square
    power-of-two images without row padding, no compressed-domain
    operation."""

    name = ""
    #: The block size: the smallest height and width a compressed image
    #: may have.
    min_side_h = min_side_w = 0

    def __init__(self, quality: str = "reference", *, device="cuda"):
        _check_quality(quality)
        self._quality = quality
        self._device = torch.device(device)

    def supports_format(self, fmt: Format) -> bool:
        """RGBA only (pvrtc_compressor.cc:611-613)."""
        return fmt == Format.RGBA

    def is_valid_compressed_image(self, image: CompressedImage) -> bool:
        """pvrtc_compressor.cc:615-629."""
        md = image.get_metadata()
        return (
            md.format == Format.RGBA
            and md.compressor_name == self.name
            and md.uncompressed_height >= self.min_side_h
            and md.uncompressed_width >= self.min_side_w
            and md.compressed_width == md.compressed_height
            and _is_power_of_two(md.uncompressed_height)
            and _is_power_of_two(md.uncompressed_width)
            and md.compressed_height == md.uncompressed_height
            and md.compressed_width == md.uncompressed_width
            and image.get_data_size()
            == self.compute_compressed_data_size(
                md.format, md.uncompressed_height, md.uncompressed_width
            )
        )

    def _encode(self, image: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def compress(self, fmt, height, width, padding_bytes_per_row, buffer,
                 image) -> bool:
        """pvrtc_compressor.cc:636-667: requires square power-of-two, no row
        padding."""
        with span("texcomp.api.compress"):
            if buffer is None or image is None or height == 0 or width == 0:
                return False
            if (not _is_power_of_two(width) or not _is_power_of_two(height)
                    or width != height):
                return False
            if padding_bytes_per_row != 0:
                return False
            if width % self.min_side_w != 0 or height % self.min_side_h != 0:
                return False

            data_size = self.compute_compressed_data_size(fmt, height, width)
            metadata = Metadata(
                format=fmt, compressor_name=self.name,
                uncompressed_height=height, uncompressed_width=width,
                compressed_height=height, compressed_width=width,
                padding_bytes_per_row=0,
            )
            if image.owns_data():
                image.create_owned_data(metadata, data_size)
            else:
                if image.get_data_size() != data_size:
                    return False
                image.set_metadata(metadata)

            with span("texcomp.api.upload"):
                img = h4._to_device(
                    h4.buffer_to_image_array(buffer, height, width, 4, 0),
                    self._device)
            out = self._encode(img)
            # The one place the host waits for the card, as in
            # helper4x4.compress.
            with span("texcomp.api.download"):
                out = out.cpu()
            image.get_mutable_data()[:] = out.numpy().reshape(-1)
            return True

    def _decode_into(self, decode, image: CompressedImage,
                     decompressed_buffer) -> bool:
        if not self.is_valid_compressed_image(image) or decompressed_buffer is None:
            return False
        md = image.get_metadata()
        data = h4._to_device(image.get_data().reshape(-1, 8), self._device)
        out = decode(data, md.uncompressed_height, md.uncompressed_width)
        decompressed_buffer[:] = np.ascontiguousarray(out.cpu().numpy()).tobytes()
        return True

    # The reference's PVRTC compressor supports no other operation
    # (pvrtc_compressor.cc:669-705).

    def decompress(self, image, decompressed_buffer) -> bool:
        return False

    def downsample(self, image, downsampled_image) -> bool:
        return False

    def pad(self, image, padded_height, padded_width, padded_image) -> bool:
        return False

    def compress_and_pad(self, fmt, height, width, padded_height, padded_width,
                         padding_bytes_per_row, buffer, padded_image) -> bool:
        return False

    def create_solid_image(self, fmt, height, width, color, image) -> bool:
        return False

    def copy_subimage(self, image, start_row, start_column, height, width,
                      subimage) -> bool:
        return False


class PvrtcCompressor(_PvrtcBase):
    """PVRTC 2BPP compressor (pvrtc_compressor.h:71-104), byte-identical to
    the C++ reference.

    Args:
      quality: "reference" (byte-identical to the C++ reference) or
        "high" (``codecs.pvrtc_hq``: alternating minimization, never worse
        than the reference by decoded error; texcomp's bytes).
      device: the torch device that encodes and decodes; the card unless
        the caller passes "cpu". Nothing falls back to another device: a
        CUDA device on a machine without one raises at the first
        operation.
    """

    name = "pvrtc"
    min_side_h = pvrtc.BLOCK_H
    min_side_w = pvrtc.BLOCK_W

    def compute_compressed_data_size(self, fmt, height, width) -> int:
        """2 bits/pixel (pvrtc_compressor.cc:631-634)."""
        return width * height // 4

    def _encode(self, image: torch.Tensor) -> torch.Tensor:
        if self._quality == "high":
            return pvrtc_hq.encode_pvrtc_2bpp_hq(image)
        return pvrtc_cuda.pvrtc_encode_image(image)

    # -- extensions beyond the reference ---------------------------------------

    def decompress_extension(self, image: CompressedImage,
                             decompressed_buffer: bytearray) -> bool:
        """Decode a PVRTC 2BPP image (EXTENSION — the reference returns
        false here): the documented reconstruction model, used for quality
        metrics and round-trip testing."""
        return self._decode_into(pvrtc.decode_pvrtc_2bpp, image,
                                 decompressed_buffer)


class Pvrtc4bppCompressor(_PvrtcBase):
    """PVRTC v1 4BPP RGBA compressor (EXTENSION — the reference implements
    only 2BPP, pvrtc_compressor.h:16-17).

    Same Compressor contract and validation style; 4x4 blocks, 64-bit
    records, 0.5 bytes/pixel, square power-of-two images, encode AND
    decode. Arguments as :class:`PvrtcCompressor`."""

    name = "pvrtc4"
    min_side_h = pvrtc4.BLOCK
    min_side_w = pvrtc4.BLOCK

    def compute_compressed_data_size(self, fmt, height, width) -> int:
        return width * height // 2  # 4 bits/pixel

    def _encode(self, image: torch.Tensor) -> torch.Tensor:
        if self._quality == "high":
            return pvrtc_hq.encode_pvrtc_4bpp_hq(image)
        return pvrtc4.encode_pvrtc_4bpp(image)

    def decompress(self, image, decompressed_buffer) -> bool:
        return self._decode_into(pvrtc4.decode_pvrtc_4bpp, image,
                                 decompressed_buffer)
