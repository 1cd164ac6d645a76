"""Image-level ETC1 ops: CUDA kernels with their plain twins.

Each kernel in ``texcomp_torch/csrc/etc.cu`` has a wrapper here
(``*_cuda``) and a plain PyTorch version of the same function beside it
(``*_plain``), built from ``blocks`` and ``codecs.etc``. The image ops pick
by the device of the tensor they are given: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. No path falls back
from one to the other.

The HQ search (``quality="high"``) takes (N, 16) int32 packed pixels
(r | g << 8 | b << 16) and (K, 2, N) int32 packed candidate words
(``codecs.etc.pack_q_word``), or None for the 40 candidates of
``codecs.etc.hq_candidate_words``, which the kernel then fits itself and
the twin makes :data:`codecs.etc.ENCODE_CHUNK` blocks at a time; one flip
per call, one launch, returning the (hi, lo, err) of each block's winner.
:func:`etc1_hq_encode_blocks` is the one HQ encode on every device: two
such searches with no candidates and the flip choice, the search the only
step that differs by device.

Encode takes an (h, w, 3 | 4) uint8 image (a fourth channel is ignored)
and a block grid at least that large; pixels beyond the image replicate
its edge. Decode returns the (4 * block_rows, 4 * block_cols, 4) uint8
RGBX image, X = 0, on every device, as the DXTC decode does. Blocks are 8
bytes in ETC1 hardware order (big-endian hi word, then big-endian lo).
"""

from __future__ import annotations

import torch

from texcomp_torch.blocks import extract_blocks, scatter_blocks
from texcomp_torch.codecs import etc
from texcomp_torch.ops import dxt_cuda
from texcomp_torch.ops._launch import check as _check
from texcomp_torch.ops._launch import decode_grid as _decode_grid
from texcomp_torch.ops._launch import downsample_grid as _downsample_grid
from texcomp_torch.ops._launch import encode_grid as _encode_grid
from texcomp_torch.ops._launch import launch as _launch
from texcomp_torch.ops._launch import pick as _pick
from texcomp_torch.utils.profiling import span

_STRATEGIES = (etc.SPLIT_HORIZONTALLY, etc.SPLIT_VERTICALLY,
               etc.SMALLER_ERROR, etc.HEURISTIC)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device).
# ---------------------------------------------------------------------------


def etc1_encode_plain(image: torch.Tensor, grid_height: int, grid_width: int,
                      strategy: int = etc.SMALLER_ERROR) -> torch.Tensor:
    """(h, w, 3|4) uint8 -> (N, 8) uint8 ETC1 blocks over the grid."""
    h, w = image.shape[:2]
    blocks = extract_blocks(image, height=h, width=w, grid_height=grid_height,
                            grid_width=grid_width)[:, :, :3]
    return etc.encode_etc1_blocks(blocks, strategy)


def etc1_decode_plain(data: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """(N, 8) uint8 ETC1 blocks -> (height, width, 4) uint8 RGBX."""
    px = etc.decode_etc1_blocks(data)
    px = torch.cat([px, torch.zeros_like(px[:, :, :1])], dim=-1)
    return scatter_blocks(px, height=height, width=width)


def etc1_downsample_plain(data: torch.Tensor, nby: int, nbx: int,
                          strategy: int = etc.SMALLER_ERROR) -> torch.Tensor:
    """(nby * nbx, 8) uint8 payload on an (nby, nbx) block grid, both even
    -> the (nby * nbx / 4, 8) payload of the next mip level: decode, 2x2
    truncating average, encode under ``strategy``."""
    h, w = 4 * nby, 4 * nbx
    avg = dxt_cuda.average_2x2(etc1_decode_plain(data, h, w)[:, :, :3])
    return etc1_encode_plain(avg, h // 2, w // 2, strategy)


def pack_pixels(rgb: torch.Tensor) -> torch.Tensor:
    """(N, 16, 3) int blocks -> (N, 16) int32 packed pixels."""
    rgb = rgb.to(torch.int32)
    return (rgb[:, :, 0] | (rgb[:, :, 1] << 8) | (rgb[:, :, 2] << 16)).contiguous()


def etc1_hq_search_plain(pixels: torch.Tensor, cands: torch.Tensor | None,
                         flip: bool):
    """(N, 16) int32 packed pixels, (K, 2, N) int32 candidate words ->
    (hi, lo, err) (N,) int32: ``codecs.etc.hq_search``. With ``cands``
    None the candidates are ``codecs.etc.hq_candidate_words``, made
    :data:`codecs.etc.ENCODE_CHUNK` blocks at a time."""
    rgb = torch.stack([pixels & 255, (pixels >> 8) & 255,
                       (pixels >> 16) & 255], dim=-1)
    if cands is not None:
        return etc.hq_search(rgb, cands, flip)
    parts = [etc.hq_search(c, etc.hq_candidate_words(c, flip), flip)
             for c in rgb.split(etc.ENCODE_CHUNK)]
    return tuple(torch.cat(w) for w in zip(*parts))


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only).
# ---------------------------------------------------------------------------


def _strategy(strategy: int) -> int:
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown ETC1 strategy {strategy!r}")
    return int(strategy)


def etc1_encode_cuda(image: torch.Tensor, grid_height: int, grid_width: int,
                     strategy: int = etc.SMALLER_ERROR) -> torch.Tensor:
    """Kernel version of :func:`etc1_encode_plain`."""
    _check(image, "etc1_encode", image.dim() == 3 and image.shape[2] in (3, 4),
           1)
    h, w, nbr, nbc = _encode_grid(image, grid_height, grid_width)
    out = torch.empty((nbr * nbc, 8), dtype=torch.uint8, device=image.device)
    _launch("etc1_encode", image.device, "texcomp_etc1_encode",
            image.data_ptr(), image.shape[2], h, w, nbr, nbc, out.data_ptr(),
            _strategy(strategy))
    return out


def etc1_decode_cuda(data: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """Kernel version of :func:`etc1_decode_plain`."""
    _check(data, "etc1_decode", data.dim() == 2 and data.shape[1] == 8, 8)
    nbr, nbc = _decode_grid(data, height, width)
    out = torch.empty((height, width, 4), dtype=torch.uint8, device=data.device)
    _launch("etc1_decode", data.device, "texcomp_etc1_decode",
            data.data_ptr(), nbr, nbc, out.data_ptr())
    return out


def etc1_downsample_cuda(data: torch.Tensor, nby: int, nbx: int,
                         strategy: int = etc.SMALLER_ERROR) -> torch.Tensor:
    """Kernel version of :func:`etc1_downsample_plain`."""
    _check(data, "etc1_downsample", data.dim() == 2 and data.shape[1] == 8, 8)
    _downsample_grid(data, nby, nbx)
    out = torch.empty((nby * nbx // 4, 8), dtype=torch.uint8,
                      device=data.device)
    _launch("etc1_downsample", data.device, "texcomp_etc1_downsample",
            data.data_ptr(), nby, nbx, out.data_ptr(), _strategy(strategy))
    return out


def etc1_hq_search_cuda(pixels: torch.Tensor, cands: torch.Tensor | None,
                        flip: bool):
    """Kernel version of :func:`etc1_hq_search_plain`: one launch, of the
    search over ``cands``, or with ``cands`` None of the search that fits
    its candidates in the kernel (counted as ``etc1_hq_fit_search``)."""
    _check(pixels, "etc1_hq_search", pixels.dim() == 2
           and pixels.shape[1] == 16, 4, torch.int32)
    n = pixels.shape[0]
    if cands is not None:
        _check(cands, "etc1_hq_search", cands.dim() == 3
               and tuple(cands.shape[1:]) == (2, n), 4, torch.int32)
    out = torch.empty((3, n), dtype=torch.int32, device=pixels.device)
    if n and cands is None:
        _launch("etc1_hq_fit_search", pixels.device,
                "texcomp_etc1_hq_fit_search", pixels.data_ptr(), n, int(flip),
                out.data_ptr())
    elif n:
        _launch("etc1_hq_search", pixels.device, "texcomp_etc1_hq_search",
                pixels.data_ptr(), n, cands.data_ptr(), cands.shape[0],
                int(flip), out.data_ptr())
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# Image ops: dispatch by the tensor's device.
# ---------------------------------------------------------------------------


def etc1_hq_search(pixels: torch.Tensor, cands: torch.Tensor | None,
                   flip: bool):
    """One flip of the HQ search on the pixels' device."""
    fn = _pick(pixels, etc1_hq_search_plain, etc1_hq_search_cuda)
    return fn(pixels, cands, flip)


def etc1_hq_encode_blocks(rgb: torch.Tensor) -> torch.Tensor:
    """(N, 16, 3) int blocks -> (N, 8) uint8 HQ ETC1 blocks on the blocks'
    device, never worse than the reference's SMALLER_ERROR (its truncated
    bases are the first candidate): the pixels packed once, then per flip
    one :func:`etc1_hq_search` over every block with no candidates (on the
    card one launch that fits them and searches them), and the flip
    choice."""
    if rgb.shape[0] == 0:
        return torch.empty((0, 8), dtype=torch.uint8, device=rgb.device)
    pixels = pack_pixels(rgb)
    flips = []
    for flip in (False, True):
        with span("texcomp.etc1.hq.search"):
            flips.append(etc1_hq_search(pixels, None, flip))
    return etc.hq_pick_flip(*flips)


def etc1_hq_encode_padded_image(image: torch.Tensor, grid_height: int,
                                grid_width: int) -> torch.Tensor:
    """The HQ compress route: the (h, w, 3|4) image, edge-padded to the
    block grid, HQ-encoded. Returns (N, 8) uint8."""
    with span("texcomp.etc1.hq.encode"):
        h, w = image.shape[:2]
        blocks = extract_blocks(image, height=h, width=w,
                                grid_height=grid_height,
                                grid_width=grid_width)[:, :, :3]
        return etc1_hq_encode_blocks(blocks)


def etc1_encode_padded_image(image: torch.Tensor, grid_height: int,
                             grid_width: int,
                             strategy: int = etc.SMALLER_ERROR) -> torch.Tensor:
    """The API's compress route: the (h, w, 3) valid image, edge-padded to
    the block grid and encoded, in one call. Returns (N, 8) uint8."""
    fn = _pick(image, etc1_encode_plain, etc1_encode_cuda)
    return fn(image, grid_height, grid_width, strategy)


def etc1_encode_image(image: torch.Tensor,
                      strategy: int = etc.SMALLER_ERROR) -> torch.Tensor:
    """(H, W, 3) uint8 (multiples of 4) -> (N, 8) uint8 ETC1 blocks."""
    h, w = image.shape[:2]
    return etc1_encode_padded_image(image, h, w, strategy)


def etc1_decode_image(data: torch.Tensor, *, height: int,
                      width: int) -> torch.Tensor:
    """(N, 8) uint8 ETC1 blocks -> (height, width, 4) uint8 RGBX image;
    height, width span the whole block grid."""
    return _pick(data, etc1_decode_plain, etc1_decode_cuda)(data, height, width)


def etc1_downsample_encode(data: torch.Tensor, *, nby: int, nbx: int,
                           strategy: int = etc.SMALLER_ERROR) -> torch.Tensor:
    """One fused mip level: the (N_src, 8) payload on an (nby, nbx) block
    grid (both even) -> the (N_src / 4, 8) payload of the 2x downsampled
    level, equal to decode -> 2x2 truncating average -> encode."""
    fn = _pick(data, etc1_downsample_plain, etc1_downsample_cuda)
    return fn(data, nby, nbx, strategy)


def transcode_dxt1_to_etc1_blocks(data: torch.Tensor,
                                  quality: str = "reference") -> torch.Tensor:
    """(N, 8) uint8 DXT1 blocks -> (N, 8) uint8 ETC1 blocks in the same
    order (TranscodeDxt1ToEtc1, dxtc_to_etc_transcoder.cc:29-40): the DXT1
    decode over a 1 x N block row, then the ETC1 encode of that (4, 4N, 4)
    image with the heuristic strategy, or with the HQ search for
    ``quality="high"``."""
    n = data.shape[0]
    if n == 0:
        return data.clone()
    decode = _pick(data, dxt_cuda.dxt1_decode_plain, dxt_cuda.dxt1_decode_cuda)
    image = decode(data, 4, 4 * n)
    if quality == "high":
        return etc1_hq_encode_padded_image(image, 4, 4 * n)
    encode = _pick(data, etc1_encode_plain, etc1_encode_cuda)
    return encode(image, 4, 4 * n, etc.HEURISTIC)


# ---------------------------------------------------------------------------
# Pad blocks (etc_compressor.cc:645-698) through the image ops.
# ---------------------------------------------------------------------------


def etc1_edge_pad_blocks(data: torch.Tensor, take: str,
                         strategy: int) -> torch.Tensor:
    """(M, 8) uint8 blocks -> their column pad blocks (``take="column"``:
    the last column copied across the block) or row pad blocks
    (``"row"``), re-encoded under ``strategy``."""
    m = data.shape[0]
    image = etc1_decode_image(data, height=4, width=4 * m)[:, :, :3]
    if take == "column":
        image = image.reshape(4, m, 4, 3)[:, :, 3:4].expand(4, m, 4, 3)
    elif take == "row":
        image = image[3:4].expand(4, 4 * m, 3)
    else:
        raise ValueError(f"unknown pad {take!r}")
    return etc1_encode_image(image.reshape(4, 4 * m, 3).contiguous(), strategy)


def etc1_corner_pad_blocks(data: torch.Tensor) -> torch.Tensor:
    """(M, 8) uint8 blocks -> the solid block of each one's decoded corner
    pixel (3, 3) (EtcGetCornerPadBlock)."""
    m = data.shape[0]
    image = etc1_decode_image(data, height=4, width=4 * m).to(torch.int32)
    corner = image.reshape(4, m, 4, 4)[3, :, 3]
    return etc.words_to_bytes(*etc.solid_block_words(
        corner[:, 0], corner[:, 1], corner[:, 2]))
