"""texcomp_torch: the PyTorch and CUDA port of texcomp.

A second package beside the JAX reference ``texcomp``, producing the same
bytes for the same input. It imports ``torch`` and never ``jax``.

  * ``texcomp_torch.core``   integer color math on torch integer tensors
  * ``texcomp_torch.blocks`` batched 4x4 block gather/scatter
  * ``texcomp_torch.codecs`` block codecs in plain PyTorch (the ground truth)
  * ``texcomp_torch.ops``    image ops: hand-written CUDA kernels for Hopper
    (``csrc/``, built with nvcc at first use) beside their plain twins
  * ``texcomp_torch.api``    the reference-compatible Compressor API
  * ``texcomp_torch.dist``   the batched asset pipeline, device meshes and
    the multi-process fleet split

It covers, in reference quality, DXT1/DXT5 (``DxtcCompressor``), ETC1 in
its four strategies (``EtcCompressor``), mip chains of both
(``downsample_chain``), the DXT1 -> ETC1 transcoder
(``transcode_dxt1_to_etc1``) and PVRTC v1: 2bpp encode
(``PvrtcCompressor``, and ``ops.pvrtc_cuda.pvrtc_encode_batched`` for a
batch of same-size images) with its decode extension
(``PvrtcCompressor.decompress_extension``), and the 4bpp extension
(``Pvrtc4bppCompressor``). DXT1/DXT5, ETC1, the transcoder and both
PVRTC compressors also take ``quality="high"``, texcomp's HQ encoders.
Every entry point runs on the
card unless the caller passes ``device="cpu"``.
"""

from texcomp_torch.api.compressor import Compressor
from texcomp_torch.api.container import CompressedImage, Format, Metadata
from texcomp_torch.api.dxtc import DxtcCompressor
from texcomp_torch.api.etc import CompressionStrategy, EtcCompressor
from texcomp_torch.api.pvrtc import Pvrtc4bppCompressor, PvrtcCompressor
from texcomp_torch.api.transcode import transcode_dxt1_to_etc1

__all__ = [
    "CompressedImage",
    "Format",
    "Metadata",
    "Compressor",
    "DxtcCompressor",
    "EtcCompressor",
    "CompressionStrategy",
    "PvrtcCompressor",
    "Pvrtc4bppCompressor",
    "transcode_dxt1_to_etc1",
]
