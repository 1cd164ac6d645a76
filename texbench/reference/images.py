"""Image-level reference: the encode, decode and mip-chain rules of the
port's API and asset pipeline (``api/helper4x4.py``, ``dist/pipeline.py``)
over whole images whose sides are multiples of 4, and the Metadata each
entry carries."""

from __future__ import annotations

import torch

from texbench.reference import dxt, etc, pvrtc, util

#: codec -> (compressor name, format code, channels encoded): Format.RGB
#: is 0 and Format.RGBA 2 (compressed_image.h:35-40).
CODECS = {"dxt1": ("dxtc", 0, 3), "dxt5": ("dxtc", 2, 4),
          "etc1": ("etc", 0, 3), "pvrtc": ("pvrtc", 2, 4)}


def metadata(codec: str, h: int, w: int) -> tuple:
    """(format, compressor name, uncompressed h, w, compressed h, w,
    padding bytes per row) of an entry."""
    name, fmt, _ = CODECS[codec]
    if codec == "pvrtc":
        return (fmt, name, h, w, h, w, 0)
    return (fmt, name, h, w, 4 * util.num_blocks(h), 4 * util.num_blocks(w), 0)


def encode(codec: str, image: torch.Tensor, strategy: int = etc.SMALLER_ERROR,
           quality: str = "reference",
           fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, C) uint8, sides multiples of 4 (PVRTC: a square power of two)
    -> (N, block bytes) uint8."""
    if codec == "pvrtc":
        return pvrtc.encode_pvrtc_2bpp(image)
    blocks = util.image_to_blocks(image)[:, :, :CODECS[codec][2]]
    if codec == "dxt1":
        return dxt.encode_dxt1_blocks(blocks)
    if codec == "dxt5":
        return dxt.encode_dxt5_blocks(blocks)
    if quality == "high":
        return etc.encode_etc1_hq_blocks(blocks, fdt)
    return etc.encode_etc1_blocks(blocks, strategy)


def decode(codec: str, data: torch.Tensor, nbr: int, nbc: int) -> torch.Tensor:
    """(nbr * nbc, block bytes) -> (4 nbr, 4 nbc, C) uint8."""
    fn = {"dxt1": dxt.decode_dxt1_blocks, "dxt5": dxt.decode_dxt5_blocks,
          "etc1": etc.decode_etc1_blocks}[codec]
    return util.blocks_to_image(fn(data), nbr, nbc)


def can_downsample(h: int, w: int) -> bool:
    """Whether the reference downsamples an (h, w) level: not 1x1, even
    block counts unless a single block, no 3-pixel single block
    (compressor4x4_helper.h:281-284, :344-350)."""
    nbr, nbc = util.num_blocks(h), util.num_blocks(w)
    if max(h, w) <= 1 or (nbr > 1 and nbr % 2) or (nbc > 1 and nbc % 2):
        return False
    return not (nbr == 1 and nbc == 1 and (h == 3 or w == 3))


def chain_extents(h: int, w: int) -> list:
    """The (h, w) of each mip level after (h, w), down to the last."""
    out = []
    while can_downsample(h, w):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def downsample(codec: str, data: torch.Tensor, h: int, w: int,
               strategy: int = etc.SMALLER_ERROR):
    """One mip level (Compressor4x4Helper::Downsample,
    compressor4x4_helper.h:264-391, swap-free): decode, replicate 1- and
    2-pixel sides of a single block, truncating 2x2 average, tile a side
    under 4 pixels, encode. Returns (payload, h', w'), or None where the
    reference refuses (:func:`can_downsample`)."""
    if not can_downsample(h, w):
        return None
    nbr, nbc = util.num_blocks(h), util.num_blocks(w)
    single = nbr == 1 and nbc == 1
    img = decode(codec, data, nbr, nbc).to(torch.int32)
    if single:
        if w == 1:
            img[:, 1:4] = img[:, 0:1]
        elif w == 2:
            img[:, 2:4] = img[:, 0:2]
        if h == 1:
            img[1:4, :] = img[0:1, :]
        elif h == 2:
            img[2:4, :] = img[0:2, :]
    c = img.shape[2]
    avg = img.reshape(img.shape[0] // 2, 2, img.shape[1] // 2, 2, c).sum(
        dim=(1, 3)) // 4
    if avg.shape[1] < 4:
        avg = avg.repeat(1, 4 // avg.shape[1], 1)
    if avg.shape[0] < 4:
        avg = avg.repeat(4 // avg.shape[0], 1, 1)
    return (encode(codec, avg.to(torch.uint8), strategy), (h + 1) // 2,
            (w + 1) // 2)


def chain(codec: str, data: torch.Tensor, h: int, w: int,
          strategy: int = etc.SMALLER_ERROR) -> list:
    """The whole mip chain after level 0: [(payload, h, w), ...] down to
    1x1 or the first level the reference refuses."""
    out = []
    for _ in chain_extents(h, w):
        data, h, w = downsample(codec, data, h, w, strategy)
        out.append((data, h, w))
    return out
