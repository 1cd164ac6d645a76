"""Image-level encode and decode ops.

Each op maps an (H, W, C) uint8 image tensor (H, W multiples of 4) to
packed blocks, blocks back to an image, or one mip level's blocks to the
next level's, on the tensor's own device: the CUDA kernels for a CUDA
tensor, their plain PyTorch twins for a CPU tensor (``dxt_cuda`` for
DXT1/DXT5, ``dxt_hq_cuda`` for the HQ DXT cluster fit, ``etc_cuda`` for
ETC1 (the HQ search too) and the transcoder, ``mipmap`` for chains,
``pvrtc_cuda`` for PVRTC 2bpp). The decode result is an (H, W, 4) image
on every device.
"""

from __future__ import annotations

from texcomp_torch.ops import dxt_cuda, etc_cuda, pvrtc_cuda


def dxt1_encode_image_op(image):
    """(H, W, 3) uint8 -> (H/4*W/4, 8) uint8 DXT1 blocks."""
    return dxt_cuda.dxt1_encode_image(image)


def dxt5_encode_image_op(image):
    """(H, W, 4) uint8 -> (H/4*W/4, 16) uint8 DXT5 blocks."""
    return dxt_cuda.dxt5_encode_image(image)


def etc1_encode_image_op(image, strategy: int = 2):
    """(H, W, 3) uint8 -> (H/4*W/4, 8) uint8 ETC1 blocks."""
    return etc_cuda.etc1_encode_image(image, strategy)


def dxt1_decode_image_op(data, height: int, width: int):
    """(N, 8) uint8 DXT1 blocks -> (H, W, 4) uint8 RGBX image."""
    return dxt_cuda.dxt1_decode_image(data, height=height, width=width)


def etc1_decode_image_op(data, height: int, width: int):
    """(N, 8) uint8 ETC1 blocks -> (H, W, 4) uint8 RGBX image."""
    return etc_cuda.etc1_decode_image(data, height=height, width=width)


def pvrtc_encode_image_op(image):
    """(H, W, 4) uint8, square power-of-two side >= 8 -> (H*W/32, 8) uint8
    PVRTC 2bpp block records in Z-order."""
    return pvrtc_cuda.pvrtc_encode_image(image)
