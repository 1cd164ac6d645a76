"""texcomp_torch: the PyTorch and CUDA port of texcomp.

A second package beside the JAX reference ``texcomp``, producing the same
bytes for the same input. It imports ``torch`` and never ``jax``.

  * ``texcomp_torch.core``   integer color math on torch integer tensors
  * ``texcomp_torch.blocks`` batched 4x4 block gather/scatter
  * ``texcomp_torch.codecs`` block codecs in plain PyTorch (the ground truth)
  * ``texcomp_torch.ops``    image ops: hand-written CUDA kernels for Hopper
    (``csrc/``, built with nvcc at first use) beside their plain twins
  * ``texcomp_torch.api``    the reference-compatible Compressor API

This first slice covers DXT1/DXT5 in reference quality (``DxtcCompressor``).
"""

from texcomp_torch.api.compressor import Compressor
from texcomp_torch.api.container import CompressedImage, Format, Metadata
from texcomp_torch.api.dxtc import DxtcCompressor

__all__ = [
    "CompressedImage",
    "Format",
    "Metadata",
    "Compressor",
    "DxtcCompressor",
]
