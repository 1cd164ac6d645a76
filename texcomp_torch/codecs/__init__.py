"""Codec block functions: encode/decode over an (N, 16, C) batch of blocks.

These plain PyTorch versions are the ground truth that the CUDA kernels in
``texcomp_torch.ops`` are held against.
"""
