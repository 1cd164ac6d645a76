"""DXT1 -> ETC1 in-place transcoding.

TranscodeDxt1ToEtc1 (image_compression/internal/dxtc_to_etc_transcoder.cc:
29-40): every 8-byte DXT1 block of the payload is decoded and re-encoded
as an 8-byte ETC1 block with the heuristic strategy, in place; texcomp's
``quality="high"`` re-encodes with the HQ ETC1 search instead. On the
device the decode and the encode are kernels with the decoded image
between them in device memory (ops/etc_cuda.transcode_dxt1_to_etc1_blocks).
"""

from __future__ import annotations

import numpy as np
import torch

from texcomp_torch.api.container import CompressedImage
from texcomp_torch.ops import etc_cuda


def transcode_dxt1_to_etc1(image: CompressedImage, quality: str = "reference",
                           *, device="cuda") -> None:
    """Re-encode every 8-byte DXT1 block of ``image`` as ETC1, in place.

    Like the reference, this rewrites the payload only: the metadata,
    compressor_name included, stays as it is (dxtc_to_etc_transcoder.h:
    20-24). ``device`` is the card unless the caller passes "cpu"; a CUDA
    device on a machine without one raises. ``quality="high"`` re-encodes
    with the HQ ETC1 search: never worse than the heuristic against the
    decoded DXT1 pixels."""
    if quality not in ("reference", "high"):
        raise ValueError(f"unknown quality {quality!r}")
    blocks = image.get_mutable_data().reshape(-1, 8)
    data = torch.from_numpy(np.ascontiguousarray(blocks)).to(torch.device(device))
    blocks[:] = etc_cuda.transcode_dxt1_to_etc1_blocks(data, quality).cpu().numpy()
