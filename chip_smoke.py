#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (texcomp_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero before the last
line is printed:

  1. device     CUDA must be present; torch/CUDA versions, card name and
                power limit.
  2. build      the CUDA kernels of texcomp_torch/csrc, built with nvcc
                (one nvcc per source file, all at once), and the host
                runtime texcomp_torch/native/texcomp_host.cc, built with
                g++ (the compiler and the library's hashed name).
  3. kernels    each of the fifteen kernels, the two strip variants and
                the three HQ PVRTC fit kernels against its plain PyTorch
                twin
                on the card at 4096x4096 (1,048,576 4x4 blocks, 524,288
                PVRTC 8x4 blocks; the two HQ kernels at 1024x1024, the size
                of bench.py's HQ cells), bytes equal:
                DXT1/DXT5 encode of solid and near-solid regions, alpha
                bands, both swap values, always4 and a ragged 4087x4083
                image on a 4096x4096 grid, of blocks whose luminance ends
                and alphas tie (dxt_tie_blocks), of 1x1, 3x5 and 13x7
                images on their own and on 16x24 grids, and of 1024x1024
                views 4 and 1 bytes past their allocation; DXT/ETC1 decode of random block
                bytes and of encoded payloads; ETC1 encode in all four
                strategies on RGB, RGBX, the ragged image and a 512x512
                image of solid, mirror-symmetric, two-colour and split
                blocks (ties); the fused DXT1/DXT5/ETC1 downsample of
                encoded and random payloads (ETC1 in all four strategies;
                random payloads hold malformed differential blocks, whose
                bases leave 0..255; DXT also of "edge words", blocks that
                take every palette and alpha-ramp branch); the PVRTC
                morph (single image, with its own and another fallback
                pixel), upscale + modulate and mode + pack of random
                pixels, all-zero and zero-alpha blocks, opaque and
                translucent and flat tiles, of "axis ties" and "zero axes"
                (pvrtc_tie_blocks: extremes shared by several pixels,
                equal lightness of different colours, equal spreads, a
                zero channel, black with alpha, all zero; with their own
                and another fallback pixel) and of "small grids" (8x8,
                16x16 and 32x32 images, one block wide at 8x8); upscale +
                modulate and mode + pack also of "modulation ties" (A == B,
                pixels equidistant from two candidates); mode + pack also
                of blocks at each mode threshold (pvrtc_mode_thresholds: 4
                and 5 intermediate pixels, counters of 10 and 11, one
                counter twice the other and one above it, both over 10) on
                the 4096x4096 grid, one 8x8 image, and stacks of 64 8x8,
                32 16x16 and 16 64x64 images;
                the batched morph, upscale + modulate and mode + pack of a
                fleet of 192 images of 512x512 and of 1024 of 64x64, of
                the tie images' 128x128 quarters and of 64 8x8 images; the
                strip variants (upscale + modulate with halo rows, mode +
                pack of a strip) on the strips of the 8192x8192 atlas over
                4 (2048 x 8192, timed) and of the 4096x4096 random image
                over 1, 2, 8 and 1,024 shards (33 of the one-row strips),
                with the rows their neighbours would send, on a strip
                whose halo rows come from another image, and on the
                "modulation ties" and "mode thresholds" inputs cut into 8
                strips (the strip morph held to the whole image's); the
                HQ cluster-fit top 4 (its float payload compared bit for
                bit) of the 1024x1024 test image's blocks, of solid, tied,
                2-value and split blocks, of random prefix sums, with the
                table cut to 4 and to 13 rows, and of 65,541 blocks; the
                ETC1 HQ search of both flips of the same blocks, with 37
                and with 1 candidate, and of 65,541 blocks; the same
                search fitting its own candidates (etc1_hq_fit_search,
                cands None) on the image's, the special, the fit's tie
                blocks (etc_hq_tie_blocks) and the 65,541 blocks, both
                flips, held to its twin and to the search kernel given
                hq_candidate_words; the HQ PVRTC fit's normal operator
                (both forms), dot and blend-weight choice on what the
                encodes give them at 1024x1024 (4x4 and 4x8 blocks, t of
                each value), on random texels, images and weights at sides
                8 to 256, and dots of 1 to 2^20 values, float bits equal
                (pvrtc_hq_fit_cases). First the
                rates of csrc/etc.cu's micro-kernels (the packed kernels'
                operation bound) and the SASS of the search's inner loop;
                then each kernel's CUDA-event median time against its
                twin's, and its bound; for the two HQ kernels, the DXT and
                ETC1 encodes, the three fused levels and the four PVRTC
                kernels also their registers, shared memory and resident
                CTAs per SM, and for the DXT encodes, fused levels, PVRTC
                kernels and both HQ search variants their SASS instruction
                count.
  4. golden     the 32 reference-mode golden cases of
                tests/golden_vectors.py (21 DXTC, 7 ETC1, the DXT1->ETC1
                transcode, 3 PVRTC 2bpp) through the port on cuda, digests
                equal to tests/golden/expected.json, and the 3 self-pinned
                PVRTC extension cases (4bpp encode + decode, the 2bpp
                decode) equal to tests/golden/extensions.json, and the 14
                self-pinned quality="high" cases (DXTC in 4 formats at
                24x36 and 57x33, ETC1 at 28x20, the transcode at 24x16, a
                DXT5 downsample at 32x48, PVRTC 2bpp at 32x32 and 64x64,
                PVRTC 4bpp at 32x32) equal to tests/golden/hq_torch.json.
  5. main path  at 4096x4096, each path with the launch counts set to 0
                just before it and read just after, every result byte-equal
                to the plain path on the card:
                  DxtcCompressor(device="cuda") compress -> decompress of
                  an RGB and an RGBA image;
                  EtcCompressor(device="cuda") compress -> decompress of
                  the RGB image (SMALLER_ERROR);
                  DxtcCompressor.downsample_chain of the RGB and RGBA
                  payloads (12 levels: 10 fused, 2 level by level);
                  EtcCompressor.downsample_chain of the ETC1 payload;
                  transcode_dxt1_to_etc1 of the DXT1 payload;
                  PvrtcCompressor(device="cuda") compress x3 and its
                  decompress_extension (against the same code on the CPU);
                  pvrtc_encode_batched x3 of the 192 x 512x512 fleet;
                  Pvrtc4bppCompressor compress -> decompress at 1024x1024
                  (plain PyTorch on the card, against the CPU).
                Then quality="high" at 1024x1024, each result byte-equal to
                the same path with every kernel wrapper replaced by its
                plain twin on the card:
                  DxtcCompressor("high") compress of an RGB, an RGBA and a
                  BGR image; EtcCompressor(quality="high") compress;
                  transcode_dxt1_to_etc1(quality="high") of the DXT1
                  payload; DxtcCompressor("high").downsample_chain of the
                  RGBA payload (10 levels, level by level);
                  PvrtcCompressor("high") and Pvrtc4bppCompressor("high")
                  compress of the RGBA image, each also byte-equal to the
                  same call with device="cpu" (the HQ PVRTC float sums
                  have one order on every device), with the arm the
                  best-of took and the PSNR of both arms.
                Every kernel must be launched by the paths that use it.
                Then both HQ PVRTC encoders once more under
                torch.cuda.set_sync_debug_mode("error"): no op of theirs
                waits on the device; and both on a smooth 1024x1024 image,
                on the card and on the CPU, bytes equal. Then the stage
                split of one 4096x4096 PVRTC compress(), and the device
                time of one 1024x1024 HQ DXT1, ETC1 and PVRTC 2bpp
                compress under torch.profiler.
  6. pipeline   texcomp_torch.dist on BASELINE config 5 (bench.py's
                _FLEET_DIST x {DXT1 RGB, ETC1 RGB, DXT5 RGBA, PVRTC RGBA}:
                9,984 assets of 64x64 to 2048x2048, 1.31 Gpix, 4-image
                pools per size class), each path with the launch counts
                set to 0 just before it and read just after:
                  AssetPipeline(batch_size=32).run warm, then timed
                  (wall, Mpix/s; each encode kernel launched once a
                  batch, and nothing else), then split by stage (host
                  stacking, host->device, kernels by CUDA events,
                  device->host, container packing); every payload and
                  metadata equal to the same run on the plain twins, and
                  one asset per (codec, size) to the per-asset compress;
                  run(mipmaps=True) equal to the plain path;
                  a fleet of the 64x64-256x256 classes with 10%
                  quality="high", equal to the plain path.
                Then a mesh of four cuda:0 entries (encode_group and
                encode_atlas_sharded equal to one device), two gloo
                processes on cuda:0 (the pod fleet with mip chains, the
                union equal to one process, both fleet PSNRs equal to
                quality_report), and quality_report of five codecs on the
                card equal to the CPU's.
  7. atlas      the PVRTC atlases, with the launch counts set to 0 just
                before each and read just after: the 8192x8192 2bpp atlas
                (2,097,152 blocks) over 4 strips on a mesh of four cuda:0
                entries and on a (data 4, block 2) mesh, each strip
                launching the morph and both variants once, byte-equal to
                pvrtc_encode_image on the card; the 4096x4096 4bpp atlas
                byte-equal to encode_pvrtc_4bpp on the card; each atlas's
                wall against the single device's (host clock, median of 5)
                and each halo exchange's CUDA-event time.
  8. cli        python -m texcomp_torch encode (DXT1), info, decode,
                mipmap and transcode-dxt1-etc1 of a 1024x1024 image in a
                temporary directory, each archive entry equal to the API's
                result on the card.

main() does not run the probes: pvrtc_pack_probe(gpu, library) times the
three designs of mode + pack, or a parent commit's kernel from its built
library, against a copy_ of the same bytes.

Before the last line it prints one JSON line with each kernel's launches
in phases 5, 6 and 7, its largest difference from its twin, its time, its twin's
time and its bound, then the card's name and power limit as nvidia-smi
gives them. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from texcomp_torch import (
    CompressedImage,
    CompressionStrategy,
    DxtcCompressor,
    EtcCompressor,
    Format,
    Pvrtc4bppCompressor,
    PvrtcCompressor,
    transcode_dxt1_to_etc1,
)
from texcomp_torch.api import helper4x4 as h4
from texcomp_torch.blocks import full_outside_mask, image_to_blocks
from texcomp_torch.codecs import dxt_hq, etc, pvrtc, pvrtc4, pvrtc_hq
from texcomp_torch.dist._multihost_worker import (launch_two_process_demo,
                                                  pod_fleet, quality_batch)
from texcomp_torch import native
from texcomp_torch.dist import mesh as tmesh
from texcomp_torch.dist.mesh import (encode_atlas_sharded, make_mesh,
                                     pvrtc4_encode_atlas_sharded,
                                     pvrtc_encode_atlas_sharded)
from texcomp_torch.dist.pipeline import (AssetPipeline, StageTimes,
                                         TextureAsset, quality_report)
from texcomp_torch.ops import (
    _build,
    _launch,
    dxt_cuda,
    dxt_hq_cuda,
    etc_cuda,
    pvrtc_cuda,
    pvrtc_hq_cuda,
)
from texcomp_torch.ops.mipmap import num_chain_levels
from texcomp_torch.utils import load_archive
from texcomp_torch.utils.profiling import cuda_time_ms

ROOT = Path(__file__).resolve().parent
SIZE = 4096
PIXELS = SIZE * SIZE
DXT_SRC = "texcomp_torch/csrc/dxt.cu"
ETC_SRC = "texcomp_torch/csrc/etc.cu"
PVRTC_SRC = "texcomp_torch/csrc/pvrtc.cu"
DXT_HQ_SRC = "texcomp_torch/csrc/dxt_hq.cu"
PVRTC_HQ_SRC = "texcomp_torch/csrc/pvrtc_hq.cu"
#: What the HQ PVRTC fit's kernels replace: texcomp's HQ PVRTC is plain XLA.
NO_PALLAS = "replaces no Pallas site (texcomp/codecs/pvrtc_hq.py is XLA)"
#: The quality="high" paths run at bench.py's HQ size (bench_dxt1_hq_encode,
#: bench_etc1_hq_encode).
HQ_SIZE = 1024
#: The 512x512 group of bench.py's fleet distribution (_FLEET_DIST), and
#: its 64x64 group.
FLEET = (192, 512)
SMALL_FLEET = (1024, 64)

#: kernel name -> (TPU kernel it replaces, its source, plain twin, wrapper)
KERNELS = {
    "dxt1_encode": ("texcomp/ops/dxt_pallas.py:238", DXT_SRC,  # _dxt1_kernel
                    dxt_cuda.dxt1_encode_plain, dxt_cuda.dxt1_encode_cuda),
    "dxt5_encode": ("texcomp/ops/dxt_pallas.py:301", DXT_SRC,  # _dxt5_kernel
                    dxt_cuda.dxt5_encode_plain, dxt_cuda.dxt5_encode_cuda),
    "dxt1_decode": ("texcomp/ops/dxt_pallas.py:568", DXT_SRC,  # _dxt1_decode_kernel
                    dxt_cuda.dxt1_decode_plain, dxt_cuda.dxt1_decode_cuda),
    "dxt5_decode": ("texcomp/ops/dxt_pallas.py:613", DXT_SRC,  # _dxt5_decode_kernel
                    dxt_cuda.dxt5_decode_plain, dxt_cuda.dxt5_decode_cuda),
    "dxt1_downsample": ("texcomp/ops/dxt_pallas.py:781", DXT_SRC,  # _dxt1_down_kernel
                        dxt_cuda.dxtc_downsample_plain,
                        dxt_cuda.dxtc_downsample_cuda),
    "dxt5_downsample": ("texcomp/ops/dxt_pallas.py:797", DXT_SRC,  # _dxt5_down_kernel
                        dxt_cuda.dxtc_downsample_plain,
                        dxt_cuda.dxtc_downsample_cuda),
    "etc1_encode": ("texcomp/ops/etc_pallas.py:302", ETC_SRC,  # _etc1_kernel
                    etc_cuda.etc1_encode_plain, etc_cuda.etc1_encode_cuda),
    "etc1_decode": ("texcomp/ops/etc_pallas.py:386", ETC_SRC,  # _etc1_decode_kernel
                    etc_cuda.etc1_decode_plain, etc_cuda.etc1_decode_cuda),
    "etc1_downsample": ("texcomp/ops/etc_pallas.py:525", ETC_SRC,  # _etc1_down_kernel
                        etc_cuda.etc1_downsample_plain,
                        etc_cuda.etc1_downsample_cuda),
    "pvrtc_morph": ("texcomp/ops/pvrtc_fast.py:239", PVRTC_SRC,  # _morph_kernel
                    pvrtc_cuda.pvrtc_morph_plain, pvrtc_cuda.pvrtc_morph_cuda),
    "pvrtc_morph_batched": ("texcomp/ops/pvrtc_fast.py:774", PVRTC_SRC,  # _morph_kernel_rowp00
                            pvrtc_cuda.pvrtc_morph_batched_plain,
                            pvrtc_cuda.pvrtc_morph_batched_cuda),
    "pvrtc_upscale_modulate": ("texcomp/ops/pvrtc_fast.py:413", PVRTC_SRC,  # _upmod_kernel
                               pvrtc_cuda.pvrtc_upscale_modulate_plain,
                               pvrtc_cuda.pvrtc_upscale_modulate_cuda),
    "pvrtc_modes_pack": ("texcomp/ops/pvrtc_fast.py:453", PVRTC_SRC,  # _mpc_kernel
                         pvrtc_cuda.pvrtc_modes_pack_plain,
                         pvrtc_cuda.pvrtc_modes_pack_cuda),
    # The atlas's strip variants of the two kernels above (the halo paths
    # of _make_var_words and _mode_edges feeding the same Pallas kernels).
    "pvrtc_upscale_modulate_halo": ("texcomp/ops/pvrtc_fast.py:413", PVRTC_SRC,  # _upmod_kernel
                                    pvrtc_cuda.pvrtc_upscale_modulate_halo_plain,
                                    pvrtc_cuda.pvrtc_upscale_modulate_halo_cuda),
    "pvrtc_modes_pack_strip": ("texcomp/ops/pvrtc_fast.py:453", PVRTC_SRC,  # _mpc_kernel
                               pvrtc_cuda.pvrtc_modes_pack_strip_plain,
                               pvrtc_cuda.pvrtc_modes_pack_strip_cuda),
    "dxt_hq_cluster_topk4": ("texcomp/ops/dxt_pallas.py:917", DXT_HQ_SRC,  # _cf_topk_kernel
                             dxt_hq_cuda.cluster_topk4_plain,
                             dxt_hq_cuda.cluster_topk4_cuda),
    "etc1_hq_search": ("texcomp/ops/etc_pallas.py:672", ETC_SRC,  # _etc1_hq_kernel
                       etc_cuda.etc1_hq_search_plain,
                       etc_cuda.etc1_hq_search_cuda),
    # The same kernel with the candidates fitted inside it
    # (hq_search_kernel<flip, true>; texcomp fits them in XLA,
    # texcomp/codecs/etc.py _hq_base_candidates), called with cands None.
    "etc1_hq_fit_search": ("texcomp/ops/etc_pallas.py:672", ETC_SRC,  # _etc1_hq_kernel
                           etc_cuda.etc1_hq_search_plain,
                           etc_cuda.etc1_hq_search_cuda),
    # The HQ PVRTC A/B fit's full-resolution steps (ops/pvrtc_hq_cuda.py).
    "pvrtc_hq_normal": (NO_PALLAS, PVRTC_HQ_SRC,
                        pvrtc_hq_cuda.pvrtc_hq_normal_plain,
                        pvrtc_hq_cuda.pvrtc_hq_normal_cuda),
    "pvrtc_hq_dot": (NO_PALLAS, PVRTC_HQ_SRC,
                     pvrtc_hq_cuda.pvrtc_hq_dot_plain,
                     pvrtc_hq_cuda.pvrtc_hq_dot_cuda),
    "pvrtc_hq_choose": (NO_PALLAS, PVRTC_HQ_SRC,
                        pvrtc_hq_cuda.pvrtc_hq_choose_plain,
                        pvrtc_hq_cuda.pvrtc_hq_choose_cuda),
}

# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work.
# ---------------------------------------------------------------------------

#: H100 SXM peaks (NVIDIA's data sheet, at the full 700 W): HBM bytes/s,
#: and the CUDA cores' 67 T op/s (the sheet's float32 rate outside the
#: tensor cores; int32 operations issue no faster).
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

# int32 operations per block, counted from the kernels' sources and
# rounded: only the work every block does whatever its data (DXT's
# constant-color and palette paths are not counted), a multiply-add as
# two. ETC1: one pixel's error against one candidate is 8 (3 subtracts, a
# multiply and two multiply-adds); a codeword of the exhaustive search is
# 36 for its 4 candidate colors plus, for each of 8 pixels, 4 errors, 3
# mins and an add: 326; the pixel indices under the chosen codeword are
# 412; a flip is 2 subblocks x (8 codewords + indices) plus 123 for bases
# and packing; the heuristic's codeword is 95 a subblock instead of the
# search, and its flip choice 74.
_ETC_FLIP_SEARCH = 2 * (8 * 326 + 412) + 123
_ETC_FLIP_HEURISTIC = 2 * (95 + 412) + 123
_ETC_ENCODE_OPS = {0: _ETC_FLIP_SEARCH, 1: _ETC_FLIP_SEARCH,
                   2: 2 * _ETC_FLIP_SEARCH + 2, 3: _ETC_FLIP_HEURISTIC + 74}
_DXT1_ENCODE_OPS = 250     # luminance, first min/max scan, 565 quantize
_DXT5_ENCODE_OPS = 920     # + alpha counts, ramp, 8-way nearest per pixel
_DXT1_DECODE_OPS = 168     # palette, 16 index selects
_DXT5_DECODE_OPS = 486     # + alpha ramp and 16 alpha selects
_ETC_DECODE_OPS = 412      # bases, codewords, 16 modified pixels
_DXT1_DOWN_OPS = 4 * 312 + 48 + _DXT1_ENCODE_OPS  # 4 decodes + sums, avg
_DXT5_DOWN_OPS = 4 * 614 + 64 + _DXT5_ENCODE_OPS
_ETC_DOWN_DECODE_OPS = 4 * 412 + 48
# PVRTC, per 8x4 block of 32 pixels. The morph and upscale + modulate
# work on 16-bit lane pairs, (r, b) and (g, a) (csrc/pvrtc.cu); these are
# the operations that form issues, a multiply-add, a 3-input min or max, a
# __dp4a and a byte SAD as two. Morph: per pixel the shared-memory store 1,
# the two lightness keys in one word 5 (a __dp4a, a shift, a multiply-add),
# the lane pairs 3, four channel keys 8 (a multiply-add each) and half of
# five 3-input 16x2 min / max, 5: 22; per axis the key fields and scan
# positions 5, the two words by index 4, the origin fallback 2, the byte-SAD
# spread 2 and the best-axis update 4: 17; the swap 7 (two __dp4a channel
# sums), the two reductions and packs 76, indexing 20. Upscale + modulate:
# per pixel the horizontal sums of four lane pairs 20 (a multiply, a
# multiply-add, a shift and a mask each), the two blended candidates' four
# lane pairs 20, four byte words 8, four byte SADs 8, the early exit 7 and
# the byte store 2: 65; per pixel row the vertical sums of 3 columns x 4
# lane pairs, 36; per block 84 for the 3x3 neighborhood (wrapped indices,
# addresses, lane pairs) and indexing 20. The same work as scalar code
# (the count these two kernels were held to before they moved to lanes,
# kept in kernel_bound's note): morph per pixel the lightness 12 and a
# strict min and max update on each of five axes, 50; per axis the
# fallback, the four-channel spread and the pair update 35; the swap 25,
# reductions 76, indexing 20. Upscale + modulate per pixel 8 for its
# channels, 64 for two 4-corner weighted sums of 4 channels, 32 for the two
# blended candidates, 48 for four L1 distances, 8 for the early exit and
# the store; per block 126 for the neighborhood. Mode + pack works four
# pixels a word and computes both modulation words: per block row two
# __byte_perm and four byte SADs with their adds 14, the 1bpp product 4 (two
# shifts, a mask, a multiply) and the 2bpp one 2 (a __byte_perm, a
# multiply); per block the intermediate count 21 (two packed words 12, two
# xor-shift-masks, two popcounts, an add), the two top-byte gathers 6, the
# mode and the flags 16, the neighbours' indices, loads and column 0 16,
# the color word 40, indexing, loads and the store 41. Its scalar
# count (kept in kernel_bound's note): 64 to unpack 32 bytes, per pixel 10
# for the three counters, 72 for the edges, mode, colors, Z-order slot and
# indexing; then 96 for a 1bpp word (3 a pixel) or 52 for a 2bpp one (16
# stored pixels and the two flags), as each block's mode in this run's
# output says.
_PVRTC_MORPH_OPS = 32 * 22 + 5 * 17 + 7 + 76 + 20
_PVRTC_UPMOD_OPS = 32 * 65 + 4 * 36 + 84 + 20
_PVRTC_PACK_OPS = 4 * (14 + 4 + 2) + 21 + 6 + 16 + 16 + 40 + 41
_PVRTC_SCALAR_OPS = {
    "pvrtc_morph": 32 * 50 + 5 * 35 + 25 + 76 + 20,
    "pvrtc_morph_batched": 32 * 50 + 5 * 35 + 25 + 76 + 20,
    "pvrtc_upscale_modulate": 32 * (8 + 64 + 32 + 48 + 8) + 126,
}
_PVRTC_PACK_SCALAR_OPS = 64 + 32 * 10 + 72
_PVRTC_PACK_1BPP_OPS, _PVRTC_PACK_2BPP_OPS = 96, 52
# HQ cluster-fit top 4, per partition: 3 to scale the cuts, 6 adds for u,
# 10 for A and B, 17 for each of the two split terms (a conversion, two
# bf16 roundings of 5, a subtract, 3 multiplies, 2 adds), 5 for the third
# (its split is the block's), 2 adds and the insertion test: 60. Per block
# 100 for the prefix sums, T and the payloads.
_CF_PARTITION_OPS, _CF_BLOCK_OPS = 60, 100
# ETC1 HQ search, per block: each step is a flip's exhaustive search
# (_ETC_FLIP_SEARCH; unpacking the candidate replaces the averages), a
# refit 2 x 174 (8 modifiers looked up and subtracted, 3 rounded means,
# quantized and packed), a probe 15.
_ETC_HQ_REFIT_OPS, _ETC_HQ_PROBE_OPS = 348, 15
# The HQ candidate fit inside the search (hq_fit), per block of 8 lanes,
# each lane: both subblocks' sums, means, sorted luminances and prefix sums
# 2 x 190; per subblock and cut the closed-form error and the top-2 update
# 10, and in the re-solve the penalty of 3 channels, the error and the
# update 34; per seed of the alternating fit 2 rounds of 16 pixels x (4
# modifiers x 3 channels x 5 for the clamped difference and its square,
# and 12 for the first least and the residual sums), the last bases' 16 x
# (60 + 3) and the 15 adds; the merges, words and stores some 300.
_ETC_HQ_CANDIDATES = 40  # codecs/etc._hq_base_candidates, a flip
_ETC_HQ_FIT_OPS = 8 * (2 * 190 + 2 * 165 * (10 + 34)
                       + 3 * (2 * 16 * 72 + 16 * 63 + 15) + 300)

# The packed kernels (csrc/etc.cu: the ETC1 encode, its fused level and the
# HQ search) do not issue the scalar operations counted above: per (pixel,
# colour) pair of their search they issue one __dp4a and one multiply-add,
# and per 32 pairs (one codeword's 4 colours against a subblock's 8 pixels)
# 4 more __dp4a for the colours' |c|^2, all on one pipe (rate kinds 0, 1
# and 4 run at one rate; kind 5 shows the min and add pipe apart). Their
# operation bound is therefore these instructions over that pipe's rate,
# measured on the card by rate kind 4 (:func:`measure_rates`); phase 3
# prints the SASS of the inner loop beside it. Pairs per block: a flip's
# search is 2 subblocks x 8 codewords x 8 pixels x 4 colours; the indices
# of the chosen flip 16 x 4; an HQ step is a flip's search, a refit one
# codeword per lane in both subblocks (8 lanes), the index word 16 x 4,
# three times.
PACKED_PER_PAIR = 17 / 8
_ETC_FLIP_PAIRS, _ETC_INDEX_PAIRS = 2 * 8 * 8 * 4, 16 * 4
_ETC_ENCODE_PAIRS = {0: _ETC_FLIP_PAIRS + _ETC_INDEX_PAIRS,
                     1: _ETC_FLIP_PAIRS + _ETC_INDEX_PAIRS,
                     2: 2 * _ETC_FLIP_PAIRS + _ETC_INDEX_PAIRS,
                     3: _ETC_INDEX_PAIRS}
_ETC_HQ_REFIT_PAIRS = 8 * 2 * 8 * 4
#: Rate micro-kernels of csrc/etc.cu: kind -> (what, instructions (kind 3:
#: pairs) a thread issues per iteration).
RATE_KINDS = {0: ("__dp4a", 128), 1: ("multiply-add", 128),
              2: ("min + max", 256), 3: ("search inner loop, pairs", 512),
              4: ("__dp4a + multiply-add", 128),
              5: ("__dp4a + min + max", 192)}
#: Set by :func:`measure_rates`: kind -> per second on this card.
RATES: dict = {}


def pvrtc_hq_fit_ops(name: str, args: tuple) -> int:
    """Float operations of one call of an HQ PVRTC fit kernel, as its twin
    computes them (each pixel and texel once; the normal operator's wrap
    halo recomputes some 41% more at 4x4). Per channel of an (h, w) image over
    (nby, nbx) texels, an upscale is its x pass (3 an (nby, w) point), y
    pass and division (4 a pixel) per leaf, and its transpose the same
    with the group adds. The normal operator: the forward upscale, the
    residual (3) and the weighted g (4) a pixel, the transpose, the ridge
    (2 a texel); the image form skips the forward and the residual; 1 - t
    once a pixel. The dot: a multiply and an add a value. The choice: the
    forward upscale of 4 channels, d and e (8), s and q (14) and the chain
    (12) a pixel."""
    if name == "pvrtc_hq_dot":
        return 2 * args[0].numel()
    if name == "pvrtc_hq_choose":
        img, ab = args
        h, w = img.shape[:2]
        return 4 * 2 * (3 * ab.shape[1] * w + 4 * h * w) + 34 * h * w
    x, t, img = args
    h, w = t.shape
    nby = x.shape[1]
    upscale = 2 * (3 * nby * w + 4 * h * w)
    per_channel = upscale + 4 * h * w + 2 * x[0, ..., 0].numel()
    if img is None:
        per_channel += upscale + 3 * h * w
    return 4 * per_channel + h * w


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _pvrtc_scalar_ops(name: str, out: torch.Tensor):
    """The scalar count of a PVRTC kernel's call, the one it was held to
    before its redesign (None for the other kernels); for mode + pack from
    the records ``out``, whose 1bpp blocks have bit 0 of the color word
    (byte 4) clear."""
    if name == "pvrtc_modes_pack":
        n = out.shape[0]
        n1 = int(((out[:, 4] & 1) == 0).sum())
        return (n * _PVRTC_PACK_SCALAR_OPS + n1 * _PVRTC_PACK_1BPP_OPS
                + (n - n1) * _PVRTC_PACK_2BPP_OPS)
    if name in _PVRTC_SCALAR_OPS:
        return out.shape[0] * _PVRTC_SCALAR_OPS[name]
    return None


def _hq_candidates(args: tuple) -> int:
    """Candidates a block of an HQ search call scores: those given, or
    with none the 40 that the kernel fits."""
    return _ETC_HQ_CANDIDATES if args[1] is None else args[1].shape[0]


def packed_pairs(name: str, args: tuple, out):
    """(pixel, colour) pairs of a packed kernel's call (None for the other
    kernels): what its blocks' searches need."""
    if name == "etc1_encode":
        return out.shape[0] * _ETC_ENCODE_PAIRS[args[3]]
    if name == "etc1_downsample":
        return out.shape[0] * _ETC_ENCODE_PAIRS[args[3]]
    if name in ("etc1_hq_search", "etc1_hq_fit_search"):
        steps = _hq_candidates(args) + etc.HQ_PROBES
        return args[0].shape[0] * (steps * _ETC_FLIP_PAIRS
                                   + etc.HQ_REFITS * _ETC_HQ_REFIT_PAIRS
                                   + (etc.HQ_REFITS + 1) * _ETC_INDEX_PAIRS)
    return None


def kernel_work(name: str, args: tuple, out):
    """(bytes, operations) of one call: each input read once, each output
    written once, and the int32 operations this call's blocks need (for
    csrc/etc.cu's packed kernels, the count they had as scalar code)."""
    data = args[0]
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = _nbytes(*(a for a in args if isinstance(a, torch.Tensor)), *outs)
    if name in ("dxt1_encode", "dxt5_encode", "dxt1_downsample",
                "dxt5_downsample"):
        nbytes += 256 * 8  # the const-color table
    n_out = outs[0].shape[0] if outs[0].dim() == 2 else outs[0].numel() // 64
    n_in = data.shape[0]
    per_block = {
        "dxt1_encode": _DXT1_ENCODE_OPS, "dxt5_encode": _DXT5_ENCODE_OPS,
        "dxt1_decode": _DXT1_DECODE_OPS, "dxt5_decode": _DXT5_DECODE_OPS,
        "dxt1_downsample": _DXT1_DOWN_OPS, "dxt5_downsample": _DXT5_DOWN_OPS,
        "etc1_decode": _ETC_DECODE_OPS,
    }
    if name == "dxt_hq_cluster_topk4":
        ops = n_in * (args[1].shape[0] * _CF_PARTITION_OPS + _CF_BLOCK_OPS)
    elif name in ("etc1_hq_search", "etc1_hq_fit_search"):
        steps = _hq_candidates(args) + etc.HQ_REFITS + etc.HQ_PROBES
        ops = n_in * (steps * _ETC_FLIP_SEARCH
                      + etc.HQ_REFITS * _ETC_HQ_REFIT_OPS
                      + etc.HQ_PROBES * _ETC_HQ_PROBE_OPS)
        if args[1] is None:
            ops += n_in * _ETC_HQ_FIT_OPS
    elif name.startswith("pvrtc_hq"):
        ops = pvrtc_hq_fit_ops(name, args)
    elif name in ("pvrtc_morph", "pvrtc_morph_batched"):
        ops = out.shape[0] * _PVRTC_MORPH_OPS
    elif name in ("pvrtc_upscale_modulate", "pvrtc_upscale_modulate_halo"):
        ops = out.shape[0] * _PVRTC_UPMOD_OPS
    elif name in ("pvrtc_modes_pack", "pvrtc_modes_pack_strip"):
        ops = out.shape[0] * _PVRTC_PACK_OPS
    elif name == "etc1_encode":
        ops = n_out * _ETC_ENCODE_OPS[args[3]]
    elif name == "etc1_downsample":
        ops = n_out * (_ETC_DOWN_DECODE_OPS + _ETC_ENCODE_OPS[args[3]])
    elif name.endswith("decode"):
        ops = n_in * per_block[name]
    else:
        ops = n_out * per_block[name]
    return nbytes, ops


def bound(nbytes: int, ops: int, pairs=None):
    """(bound_ms, bound_by): the larger of the byte and operation times.
    For a packed kernel (``pairs`` given) the operations are its search's
    instructions on the __dp4a pipe at the rate measured on the card, and,
    for the fused level, its decode's scalar operations (``ops``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    if pairs is not None:
        t_pairs = pairs * PACKED_PER_PAIR / RATES[4] * 1e3
        t_ops = max(t_pairs, t_ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound(name: str, args: tuple, out):
    """(bound_ms, bound_by, note) of one call: the packed bound for the
    packed kernels (csrc/etc.cu's and the four PVRTC kernels), with their
    scalar-count bound in the note; the scalar-count bound for the
    others."""
    nbytes, ops = kernel_work(name, args, out)
    pairs = packed_pairs(name, args, out)
    if pairs is None:
        note = f"{nbytes / 2**20:.1f} MiB, {ops / 1e9:.3f} G int ops"
        scalar = _pvrtc_scalar_ops(name, out)
        if scalar is not None:
            scalar_ms, scalar_by = bound(nbytes, scalar)
            note += f"; the scalar-count bound {scalar_ms:.4f} ms by {scalar_by}"
        return (*bound(nbytes, ops), note)
    decode = out.shape[0] * _ETC_DOWN_DECODE_OPS if name == "etc1_downsample" else 0
    ms, by = bound(nbytes, decode, pairs)
    if name == "etc1_hq_fit_search":
        # The fit's float and integer operations issue through the same
        # schedulers as the search's __dp4a-pipe instructions: the times add.
        ms += args[0].shape[0] * _ETC_HQ_FIT_OPS / CUDA_CORE_OPS_PER_S * 1e3
        by = "operations"
    scalar_ms, scalar_by = bound(nbytes, ops)
    return ms, by, (f"{nbytes / 2**20:.1f} MiB, {pairs / 1e9:.3f} G (pixel, "
                    f"colour) pairs; the scalar-count bound {scalar_ms:.4f} ms "
                    f"by {scalar_by}")


# ---------------------------------------------------------------------------
# Inputs and golden cases.
# ---------------------------------------------------------------------------


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"{what} returned False")


def make_image(seed: int, h: int, w: int, c: int) -> np.ndarray:
    """Four horizontal bands: solid 32x32 tiles, the same tiles with +-2
    noise, a gradient with a checkerboard, and noise. With c == 4 the
    first three bands carry alpha 0, 255 and a gradient in column thirds."""
    rng = np.random.default_rng(seed)
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    tiles = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1, c), dtype=np.uint8)
    solid = tiles[y // 32, x // 32]
    near = np.clip(solid + rng.integers(-2, 3, (h, w, c), dtype=np.int16),
                   0, 255)
    grad = np.zeros((h, w, c), dtype=np.int16)
    grad[..., 0] = x * 255 // max(1, w - 1)
    grad[..., 1] = y * 255 // max(1, h - 1)
    grad[..., 2] = (x + y) % 2 * 255
    noise = rng.integers(0, 256, (h, w, c), dtype=np.int16)
    band = (y * 4 // h)[..., None]
    img = np.select([band == 0, band == 1, band == 2], [solid, near, grad],
                    noise)
    if c == 4:
        third = x * 3 // w
        alpha = np.select([third == 0, third == 1], [0, 255],
                          x * 255 // max(1, w - 1))
        img[..., 3] = np.where(band[..., 0] == 3, noise[..., 3], alpha)
    return img.astype(np.uint8)


def golden_compressor(case: dict, device, quality: str = "reference"):
    """The compressor a golden case runs through."""
    if case["codec"] == "etc":
        return EtcCompressor(CompressionStrategy(case["strategy"]),
                             quality=quality, device=device)
    if case["codec"] == "pvrtc":
        return PvrtcCompressor(quality, device=device)
    if case["codec"] == "pvrtc4":
        return Pvrtc4bppCompressor(quality, device=device)
    return DxtcCompressor(quality, device=device)


def golden_outputs(case: dict, gv, device, quality: str = "reference") -> dict:
    """The digests of one golden case (``gv`` is tests/golden_vectors.py)
    through the port on ``device``, keyed as in
    tests/golden/expected.json. With ``quality="high"`` every encode is
    HQ; a transcode case still starts from the reference DXT1 payload."""
    comp = golden_compressor(case, device, quality)
    fmt = Format(case["fmt"])
    h, w = case["h"], case["w"]
    kind = case["kind"]
    if kind == "solid":
        ci = CompressedImage()
        _require(comp.create_solid_image(
            fmt, h, w, np.array(case["color"], dtype=np.uint8), ci),
            "create_solid_image")
        return {"out": gv.digest(ci.get_data())}
    img = gv.golden_image(case["seed"], h, w, case["comps"])
    ci = CompressedImage()
    if kind == "transcode":
        comp = DxtcCompressor(device=device)
    _require(comp.compress(fmt, h, w, 0, img.tobytes(), ci), "compress")
    out = CompressedImage()
    if kind == "encode":
        if case["codec"] == "pvrtc":  # the reference cannot decode PVRTC
            return {"out": gv.digest(ci.get_data())}
        buf = bytearray()
        _require(comp.decompress(ci, buf), "decompress")
        return {"out": gv.digest(ci.get_data()), "decoded": gv.digest(bytes(buf))}
    if kind == "transcode":
        transcode_dxt1_to_etc1(ci, quality, device=device)
        return {"out": gv.digest(ci.get_data())}
    if kind == "downsample":
        _require(comp.downsample(ci, out), "downsample")
    elif kind == "pad":
        _require(comp.pad(ci, case["ph"], case["pw"], out), "pad")
    elif kind == "compress_and_pad":
        _require(comp.compress_and_pad(fmt, h, w, case["ph"], case["pw"], 0,
                                       img.tobytes(), out), "compress_and_pad")
    elif kind == "subimage":
        _require(comp.copy_subimage(ci, case["r0"], case["c0"], case["sh"],
                                    case["sw"], out), "copy_subimage")
    else:
        raise ValueError(f"unknown golden kind {kind!r}")
    return {"out": gv.digest(out.get_data())}


def extension_golden_outputs(case: dict, gv, device) -> dict:
    """The digests of one self-pinned extension case (PVRTC 4bpp encode +
    decode, or the PVRTC 2bpp decode extension) through the port on
    ``device``, keyed as in tests/golden/extensions.json."""
    h, w = case["h"], case["w"]
    img = gv.golden_image(case["seed"], h, w, 4)
    ci = CompressedImage()
    buf = bytearray()
    if case["kind"] == "encode4":
        comp = Pvrtc4bppCompressor(device=device)
        _require(comp.compress(Format.RGBA, h, w, 0, img.tobytes(), ci),
                 "compress")
        _require(comp.decompress(ci, buf), "decompress")
    elif case["kind"] == "decode2":
        comp = PvrtcCompressor(device=device)
        _require(comp.compress(Format.RGBA, h, w, 0, img.tobytes(), ci),
                 "compress")
        _require(comp.decompress_extension(ci, buf), "decompress_extension")
    else:
        raise ValueError(f"unknown extension kind {case['kind']!r}")
    return {"out": gv.digest(ci.get_data()), "decoded": gv.digest(bytes(buf))}


#: The self-pinned quality="high" cases of tests/golden/hq_torch.json: the
#: digests texcomp gives on the CPU through :func:`golden_outputs`' steps
#: with quality="high" (tests/test_torch_golden.py checks texcomp still
#: gives them, and writes the file).
HQ_CASES = (
    [dict(name=f"hq_enc_dxtc_f{fmt}_{h}x{w}", kind="encode", codec="dxtc",
          fmt=fmt, comps=3 if fmt < 2 else 4, h=h, w=w, seed=h * 1000 + w,
          strategy=2)
     for fmt in range(4) for h, w in ((24, 36), (57, 33))]
    + [dict(name="hq_enc_etc_28x20", kind="encode", codec="etc", fmt=0,
            comps=3, h=28, w=20, seed=779, strategy=2),
       dict(name="hq_transcode_24x16", kind="transcode", codec="dxtc", fmt=0,
            comps=3, h=24, w=16, seed=11, strategy=2),
       dict(name="hq_down_dxtc_f2_32x48", kind="downsample", codec="dxtc",
            fmt=2, comps=4, h=32, w=48, seed=5, strategy=2)]
    + [dict(name=f"hq_enc_{codec}_{side}", kind="encode", codec=codec, fmt=2,
            comps=4, h=side, w=side, seed=side * 1000 + side, strategy=2)
       for codec, side in (("pvrtc", 32), ("pvrtc", 64), ("pvrtc4", 32))])


def dxtc_golden_cases(gv) -> list[dict]:
    return [c for c in gv.CASES
            if c["codec"] == "dxtc" and c["kind"] != "transcode"]


def reference_golden_cases(gv) -> list[dict]:
    """Every reference-mode case: DXTC, ETC1, the DXT1 -> ETC1 transcode
    and PVRTC 2bpp."""
    return [c for c in gv.CASES if c["codec"] in ("dxtc", "etc", "pvrtc")]


def _load_golden_vectors():
    path = ROOT / "tests" / "golden_vectors.py"
    spec = importlib.util.spec_from_file_location("golden_vectors", path)
    gv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gv)
    return gv


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    gpu = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()} | nvidia-smi: {gpu}", flush=True)
    return gpu


def phase_build() -> None:
    t0 = time.perf_counter()
    existed = _build.library_path().exists()
    _build.load()
    print(f"[build] {_build.library_path().name} "
          f"{'(already built)' if existed else 'built'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    existed = native.library_path().exists()
    native.load()
    version = subprocess.run([native.compiler(), "--version"],
                             capture_output=True, text=True).stdout
    print(f"[build] host runtime {native.library_path().name} "
          f"{'(already built)' if existed else 'built'} by "
          f"{native.compiler()} ({version.splitlines()[0]}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def pvrtc_images(rgba: torch.Tensor) -> dict:
    """The PVRTC inputs on the card: a 4096^2 image of random pixels; the
    RGBA test image (solid 32x32 tiles with alpha 0, 255 or a gradient,
    near-solid tiles, gradient, noise) with every 7th 8x4 block all zero
    and every 11th block's alpha zero ("tiles"); the fleet of 192 images of
    512^2 (its 64 crops and 128 random images) and 1024 of 64^2 (every
    fourth 64^2 crop of it)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    tiles = rgba.clone()
    blocks = tiles.view(SIZE // 4, 4, SIZE // 8, 8, 4)
    blocks[::7, :, ::7] = 0
    blocks[3::11, :, 5::11, :, 3] = 0

    def crops(side):
        k = SIZE // side
        return tiles.reshape(k, side, k, side, 4).permute(0, 2, 1, 3, 4).reshape(
            k * k, side, side, 4)

    def random(*shape):
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8,
                             device="cuda")

    n, side = FLEET
    fleet = torch.cat([crops(side), random(n - 64, side, side, 4)])
    n_small, small = SMALL_FLEET
    return {"random": random(SIZE, SIZE, 4), "tiles": tiles, "fleet": fleet,
            "small fleet": crops(small)[::4][:n_small].contiguous()}


def special_blocks(m: int = 4096) -> torch.Tensor:
    """(4m, 16, 3) int32 blocks on the card: m solid, m tied (p(y, x) ==
    p(x, y), so both flips and many projections tie), m of two colours and
    m split into a dark left and a bright right half (bases far outside the
    ETC1 differential window)."""
    g = torch.Generator(device="cuda").manual_seed(17)

    def rand(*shape, lo=0, hi=256):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32,
                             device="cuda")

    solid = rand(m, 1, 3).expand(m, 16, 3)
    base = rand(m, 4, 4, 3)
    upper = torch.ones(4, 4, dtype=torch.bool, device="cuda").triu()
    tied = torch.where(upper[None, :, :, None], base, base.transpose(1, 2))
    two = torch.where(rand(m, 16, 1, hi=2) == 1, rand(m, 1, 3), rand(m, 1, 3))
    left = (torch.arange(16, device="cuda") % 4 < 2)[None, :, None]
    split = torch.where(left, rand(m, 1, 3, hi=48), rand(m, 1, 3, lo=208))
    return torch.cat([solid, tied.reshape(m, 16, 3), two, split])


def edge_words(is_dxt1: bool) -> np.ndarray:
    """(K, 8 | 16) uint8 DXT1 / DXT5 blocks that take every branch of the
    fused level's decode, each combination once: color words with c0 > c1,
    c0 < c1 and c0 == c1 under index words of all 3s and other row
    patterns; for DXT5 also alpha endpoints with a0 > a1, a0 < a1 and
    a0 == a1 under code fields of all 6s, all 7s, 6 and 7 in every row, and
    codes 0-7 across the rows (pixel 5's code straddles the block's first
    4-byte boundary)."""
    colors = [(0xF81F, 0x07E0), (0x07E0, 0xF81F), (0x7BEF, 0x7BEF),
              (0xFFFF, 0x0000), (0x0000, 0xFFFF), (0x0000, 0x0000),
              (0x8411, 0x8410), (0x8410, 0x8411)]
    indices = [0xFFFFFFFF, 0xAAAAAAAA, 0x55555555, 0x00000000, 0xE4E4E4E4,
               0x1B1B1B1B, 0xFFAA5500]
    color = np.array([c0 | c1 << 16 | iw << 32 for c0, c1 in colors
                      for iw in indices], dtype="<u8")
    color = color.view(np.uint8).reshape(-1, 8)
    if is_dxt1:
        return color
    ends = [(200, 17), (17, 200), (128, 128), (255, 0), (0, 255), (0, 0),
            (255, 255)]
    codes = [[6] * 16, [7] * 16, [6, 7, 6, 7, 7, 6, 7, 6] * 2,
             [n % 8 for n in range(16)], [7 - n % 8 for n in range(16)]]
    fields = [sum(c << 3 * n for n, c in enumerate(cs)) for cs in codes]
    alpha = np.array([a0 | a1 << 8 | f << 16 for a0, a1 in ends
                      for f in fields], dtype="<u8")
    alpha = alpha.view(np.uint8).reshape(-1, 8)
    return np.concatenate([np.repeat(alpha, len(color), axis=0),
                           np.tile(color, (len(alpha), 1))], axis=1)


def dxt_tie_blocks(seed: int = 23, m: int = 256) -> np.ndarray:
    """(6m, 16, 4) uint8 RGBA blocks (scan order y*4+x) on which the DXT
    encode's searches tie, m of each kind: two pixels of equal luminance
    and different colour at the block's least and at its greatest
    luminance, in random positions ((r, g, b) and (r - 2k, g + k, b) or
    (r + k, g, b - 4k), equal in 4r + 8g + b only; in odd blocks (r, g, b)
    and (r + 8t, g - 5t, b + 8t), equal with r and b swapped too); alphas equidistant between two ramp entries (6-interpolant
    mode, and the explicit 0/255 mode through two 0s); alphas of only 0s
    and 255s; exactly one 0 or exactly one 255 among mid alphas; all 16
    alphas equal (0 and 255 among them); and solid blocks (the
    constant-colour path)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(m)[:, None]

    def mid(*shape):
        return rng.integers(64, 192, shape)

    # Luminance ties at both ends; mid pixels have lum 832..2483, the low
    # pair at most 309 and the high pair at least 2924.
    ties = mid(m, 16, 4)
    pos = rng.permuted(np.tile(np.arange(16), (m, 1)), axis=1)[:, :4]
    k = rng.integers(1, 5, (m, 1))
    both = (rows % 2 == 1) * np.where(k > 2, 2, 1) * np.array([8, -5, 8])
    lo = np.concatenate([rng.integers(10, 18, (m, 1)), rng.integers(12, 20, (m, 1)),
                         rng.integers(2, 10, (m, 1))], 1)
    hi = np.concatenate([rng.integers(224, 236, (m, 1)),
                         rng.integers(236, 256, (m, 1)),
                         rng.integers(236, 240, (m, 1))], 1)
    one_way = rows % 2 == 0
    lo2 = lo + np.where(one_way, k * np.array([-2, 1, 0]), both)
    hi2 = hi + np.where(one_way, k * np.array([1, 0, -4]), both)
    for j, c in enumerate((lo, lo2, hi, hi2)):
        ties[rows, pos[:, j:j + 1], :3] = c[:, None]

    # Alphas equidistant between two entries of the block's ramp.
    equi = mid(m, 16, 4)
    for n in range(m):
        explicit = n % 2 == 1
        low = int(rng.integers(1, 120))
        high = int(rng.integers(low + 7, 255))
        if explicit:  # a0 = low <= a1 = high: 4 interpolants, 0, 255
            ramp = [low, high] + [((5 - j) * low + j * high) // 5 for j in range(1, 5)]
        else:  # a0 = high > a1 = low: 6 interpolants
            ramp = [high, low] + [((7 - j) * high + j * low) // 7 for j in range(1, 7)]
        e = np.unique(ramp)
        halves = [(x + y) // 2 for x, y in zip(e, e[1:]) if (x + y) % 2 == 0]
        fill = rng.choice(halves or list(e), 14)
        alpha = np.concatenate([[low, high], fill])
        if explicit:
            alpha[2:4] = 0
        equi[n, :, 3] = rng.permutation(alpha)

    binary = mid(m, 16, 4)
    binary[:, :, 3] = rng.integers(0, 2, (m, 16)) * 255
    one = mid(m, 16, 4)
    one[rows, rng.integers(0, 16, (m, 1)), 3] = np.where(rows % 2 == 0, 0, 255)
    flat = mid(m, 16, 4)
    flat[:, :, 3] = np.concatenate([[0, 255], rng.integers(0, 256, m - 2)])[:, None]
    solid = np.repeat(rng.integers(0, 256, (m, 1, 4)), 16, axis=1)
    return np.concatenate([ties, equi, binary, one, flat, solid]).astype(np.uint8)


def dxt_tie_image(cols: int = 64, m: int = 1024) -> np.ndarray:
    """:func:`dxt_tie_blocks` laid out as an RGBA image, ``cols`` blocks a
    row."""
    blocks = dxt_tie_blocks(m=m)
    nby = len(blocks) // cols
    return blocks.reshape(nby, cols, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(
        4 * nby, 4 * cols, 4)


def _misaligned(img: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``img`` that starts ``offset`` bytes past the
    start of its allocation."""
    buf = torch.empty(img.numel() + 16, dtype=torch.uint8, device=img.device)
    view = buf[offset:offset + img.numel()].view(img.shape)
    view.copy_(img)
    return view


def dxt_encode_cases(rgb: torch.Tensor, rgba: torch.Tensor) -> list:
    """The DXT encodes' cases beyond the 4096^2 image, each as (label,
    [(format, image, swap)] in the order rgb, bgr, rgba, bgra, grid): the
    :func:`dxt_tie_image` blocks; images of 1x1, 3x5 and 13x7 pixels on
    their own grids and on larger ones (has_one_pixel blocks); and 1024^2
    views that start 4 and 1 bytes past their allocation (the vector loads'
    alignment tests)."""
    ties = torch.from_numpy(dxt_tie_image()).cuda()
    sets = [("lum and alpha ties", ties, tuple(ties.shape[:2]))]
    for h, w in ((1, 1), (3, 5), (13, 7)):
        sets.append((f"small {h}x{w}", rgba[:h, :w], (h, w)))
        sets.append((f"small {h}x{w} on 16x24", rgba[:h, :w], (16, 24)))
    side = 1024
    out = []
    for label, img, grid in sets:
        out.append((label, [("rgb", img[..., :3].contiguous(), False),
                            ("bgr", img[..., :3].contiguous(), True),
                            ("rgba", img.contiguous(), False),
                            ("bgra", img.contiguous(), True)], grid))
    for offset in (4, 1):
        rgb_view = _misaligned(rgb[:side, :side].contiguous(), offset)
        rgba_view = _misaligned(rgba[:side, :side].contiguous(), offset)
        out.append((f"misaligned base +{offset}",
                    [("rgb", rgb_view, False), ("bgr", rgb_view, True),
                     ("rgba", rgba_view, False), ("bgra", rgba_view, True)],
                    (side, side)))
    return out


def _enum_errors(px: np.ndarray, members: np.ndarray) -> np.ndarray:
    """(N, 165 * 8) float32: the HQ ETC1 exhaustive fit's closed-form error
    of each (cut, codeword) for the subblock ``members`` of (N, 16, 3)
    blocks, as ``codecs.etc._cluster_fit_enum_bases`` computes it."""
    parts, _, const, coef13, coef2 = etc._enum_tables()
    sub = px[:, members].astype(np.float32)
    t = (sub - sub.sum(axis=1, keepdims=True) / np.float32(8)).sum(axis=2)
    cum = np.concatenate([np.zeros((len(px), 1), np.float32),
                          np.cumsum(np.sort(t, axis=1), axis=1,
                                    dtype=np.float32)], axis=1)
    tm = ((cum[:, parts[:, 0]] + cum[:, parts[:, 2]])[:, :, None] * coef13
          + cum[:, parts[:, 1]][:, :, None] * coef2)
    return const[None] - np.float32(2) * tm.reshape(len(px), -1)


def etc_hq_tie_blocks(m: int = 512, seed: int = 23) -> np.ndarray:
    """(6m, 16, 3) int32 blocks on which the HQ ETC1 candidate fit breaks
    ties: m solid (every codeword's all-one-modifier cuts tie at 0), m of
    two colours, m within +-1 and m within +-2 of one colour (least errors
    shared by codewords and cuts, in both fits), m mirror-symmetric (the
    flips tie), and m within +-5 of one colour whose least exhaustive-fit
    error some subblock shares between two codewords."""
    rng = np.random.default_rng(seed)

    def near(r, k):
        return rng.integers(0, 256, (k, 1, 3)) + rng.integers(-r, r + 1,
                                                              (k, 16, 3))

    solid = np.repeat(rng.integers(0, 256, (m, 1, 3)), 16, axis=1)
    two = np.where(rng.integers(0, 2, (m, 16, 1)) == 1,
                   rng.integers(0, 256, (m, 1, 3)),
                   rng.integers(0, 256, (m, 1, 3)))
    sym = rng.integers(0, 256, (m, 4, 4, 3))
    upper = np.triu(np.ones((4, 4), bool))[None, :, :, None]
    sym = np.where(upper, sym, sym.transpose(0, 2, 1, 3)).reshape(m, 16, 3)
    pool = np.clip(near(5, 16 * m), 0, 255)
    tied = np.zeros(len(pool), bool)
    x, y = np.arange(16) % 4, np.arange(16) // 4
    for members in (x < 2, x >= 2, y < 2, y >= 2):
        e = _enum_errors(pool, np.where(members)[0])
        at = (e == e.min(axis=1, keepdims=True)).reshape(len(pool), 165, 8)
        tied |= at.any(axis=1).sum(axis=1) > 1
    out = np.concatenate([solid, two, near(1, m), near(2, m), sym,
                          pool[tied][:m]])
    return np.clip(out, 0, 255).astype(np.int32)


def tie_image() -> torch.Tensor:
    """A 512x512 RGB image on the card made of :func:`special_blocks`'
    16,384 blocks in block order: solid, mirror-symmetric, two-colour and
    split blocks, on which flips, codewords and modifiers tie."""
    blocks = special_blocks().to(torch.uint8)
    return blocks.reshape(128, 128, 4, 4, 3).permute(0, 2, 1, 3, 4).reshape(
        512, 512, 3).contiguous()


PVRTC_TIE_VALUES = (0, 1, 127, 128, 254, 255)


def _lightness(px: np.ndarray) -> np.ndarray:
    """GetExtremesFast's lightness (77 r + 150 g + 28 b) >> 8 of (..., 4)
    pixels."""
    px = px.astype(np.int64)
    return (77 * px[..., 0] + 150 * px[..., 1] + 28 * px[..., 2]) >> 8


def _axis_pairs(blocks: np.ndarray):
    """(lo, hi, spread): each axis's first-occurrence min and max pixels
    (N, 5, 4) and their L1 spread (N, 5), of (N, 32, 4) blocks that have
    no all-zero axis."""
    px = blocks.astype(np.int64)
    rows = np.arange(len(px))[:, None]
    axes = np.concatenate([_lightness(px)[..., None], px], axis=-1)
    lo = px[rows, axes.argmin(axis=1)]
    hi = px[rows, axes.argmax(axis=1)]
    return lo, hi, np.abs(hi - lo).sum(axis=-1)


def pvrtc_tie_blocks(seed: int = 29, m: int = 256) -> dict:
    """The morph's tie cases, by label, each (m, 32, 4) uint8 blocks in
    scan order py * 8 + px:

      axis ties       2-4 colours a block, channels from PVRTC_TIE_VALUES,
                      at random scan positions: every axis's min and max
                      shared by several pixels that differ elsewhere;
      lightness ties  16 pixels each of two lightnesses, equal after the
                      >> 8 and of different colours;
      equal spreads   few-valued blocks on which two axes reach the
                      largest spread with different pairs (strict '>'
                      keeps the earlier axis);
      zero axes       one channel 0 throughout; r, g and b 0 with alpha
                      set; and all-zero blocks (the origin fallback).
    """
    rng = np.random.default_rng(seed)
    rows = np.arange(m)[:, None]
    values = np.array(PVRTC_TIE_VALUES)

    def palette_blocks(n, vals, colours=(2, 5)):
        k = rng.integers(*colours, (n, 1))
        pal = vals[rng.integers(0, len(vals), (n, 4, 4))]
        pick = rng.integers(0, 1 << 20, (n, 32)) % k
        return pal[np.arange(n)[:, None], pick]

    ties = palette_blocks(m, values)

    # Lightness ties: colours grouped by lightness, two groups a block.
    pool = rng.integers(0, 256, (1 << 16, 4))
    order = np.argsort(_lightness(pool), kind="stable")
    pool = pool[order]
    _, start, count = np.unique(_lightness(pool), return_index=True,
                                return_counts=True)
    big = np.flatnonzero(count >= 8)
    groups = big[rng.integers(0, len(big), (m, 2))]
    which = rng.permuted(np.tile(np.arange(32) % 2, (m, 1)), axis=1)
    g = groups[rows, which]
    light = pool[start[g] + rng.integers(0, 1 << 20, (m, 32)) % count[g]]

    # Equal spreads: a pool of few-valued blocks, kept where the largest
    # spread is reached by two axes whose pairs differ.
    cand = palette_blocks(64 * m, np.array([0, 64, 128, 192, 255]), (2, 4))
    cand[..., 3] = np.maximum(cand[..., 3], 1)  # no all-zero axis
    nz = (cand[..., :3].max(axis=1) > 0).all(axis=-1)
    cand = cand[nz]
    lo, hi, spreads = _axis_pairs(cand)
    top = spreads == spreads.max(axis=1, keepdims=True)
    first = top.argmax(axis=1)[:, None]
    n_cand = np.arange(len(cand))[:, None]
    other = ((lo != lo[n_cand, first]) | (hi != hi[n_cand, first])).any(axis=-1)
    equal = cand[(top & other).any(axis=1)][:m]
    if len(equal) < m:
        raise RuntimeError(f"only {len(equal)} equal-spread blocks")

    # Zero axes: a random channel 0, black with alpha, all zero.
    zero = rng.integers(0, 256, (m, 32, 4))
    third = m // 3
    zero[rows[:third], :, rng.integers(0, 4, (third, 1))] = 0
    zero[third:2 * third, :, :3] = 0
    zero[third:2 * third, :, 3] = rng.integers(1, 256, (third, 32))
    zero[2 * third:] = 0
    return {label: b.astype(np.uint8) for label, b in
            (("axis ties", ties), ("lightness ties", light),
             ("equal spreads", equal), ("zero axes", zero))}


def pvrtc_block_image(blocks: np.ndarray, side: int, seed: int = 31):
    """A (side, side, 4) uint8 image of ``blocks`` (K, 32, 4) in row-major
    block order, random blocks after them; its block 0 is random, so the
    image's pixel (0, 0) lies in no tie block."""
    rng = np.random.default_rng(seed)
    nby, nbx = side // 4, side // 8
    fill = rng.integers(0, 256, (nby * nbx, 32, 4), dtype=np.uint8)
    k = min(len(blocks), nby * nbx - 1)
    fill[1:1 + k] = blocks[:k]
    return np.ascontiguousarray(fill.reshape(nby, nbx, 4, 8, 4).transpose(
        0, 2, 1, 3, 4).reshape(side, side, 4))


def pvrtc_modulation_ties(side: int = 256, seed: int = 37):
    """An upscale + modulate input on which the candidates' distances tie:
    (1, side, side, 4) uint8 pixels with channels in 0, 4, .., 28 and
    (NB, 2) int32 low-res colours with channels in 0, 8, .., 32, A == B in
    the block rows by with by & 4 == 0 (so in the whole neighbourhood of
    rows 1 and 2 of every 8)."""
    rng = np.random.default_rng(seed)
    nby, nbx = side // 4, side // 8
    images = (4 * rng.integers(0, 8, (1, side, side, 4))).astype(np.uint8)
    low = (8 * rng.integers(0, 5, (nby, nbx, 2, 4))).astype(np.uint8)
    band = (np.arange(nby) & 4) == 0
    low[band, :, 1] = low[band, :, 0]
    return images, low.view(np.int32).reshape(nby * nbx, 2)


def _relu(x):
    return np.maximum(x, 0)


#: The mode decision's thresholds (CalculateBlockModulationMode,
#: pvrtc_compressor.cc:395-447): label -> (a penalty of a block's
#: intermediate count i and crossed counters v (vertical_count, the deltas
#: to the right) and h (horizontal_count, the deltas below), 0 exactly when
#: the block is at the threshold; the mode it then takes: 0 1bpp, 1
#: average4, 2 vertical, 3 horizontal).
PVRTC_MODE_THRESHOLDS = {
    "4 intermediate": (
        lambda i, v, h: abs(i - 4) + _relu(11 - v) + _relu(2 * h + 1 - v), 0),
    "5 intermediate": (
        lambda i, v, h: abs(i - 5) + _relu(11 - v) + _relu(2 * h + 1 - v), 2),
    "vertical 10": (
        lambda i, v, h: _relu(5 - i) + abs(v - 10) + _relu(2 * h + 1 - v), 1),
    "vertical 11": (
        lambda i, v, h: _relu(5 - i) + abs(v - 11) + _relu(2 * h + 1 - v), 2),
    "horizontal 10": (
        lambda i, v, h: _relu(5 - i) + abs(h - 10) + _relu(2 * v + 1 - h), 1),
    "horizontal 11": (
        lambda i, v, h: _relu(5 - i) + abs(h - 11) + _relu(2 * v + 1 - h), 3),
    "vertical twice horizontal": (
        lambda i, v, h: _relu(5 - i) + _relu(11 - v) + abs(v - 2 * h), 1),
    "vertical above twice": (
        lambda i, v, h: _relu(5 - i) + _relu(11 - v) + abs(v - 2 * h - 1), 2),
    "horizontal twice vertical": (
        lambda i, v, h: _relu(5 - i) + _relu(11 - h) + abs(h - 2 * v), 1),
    "horizontal above twice": (
        lambda i, v, h: _relu(5 - i) + _relu(11 - h) + abs(h - 2 * v - 1), 3),
    "both over 10": (
        lambda i, v, h: _relu(5 - i) + _relu(11 - v) + _relu(11 - h)
        + _relu(v - 2 * h) + _relu(h - 2 * v), 1),
    "both over 10, vertical": (
        lambda i, v, h: _relu(5 - i) + _relu(11 - h) + _relu(2 * h + 1 - v), 2),
    "both over 10, horizontal": (
        lambda i, v, h: _relu(5 - i) + _relu(11 - v) + _relu(2 * v + 1 - h), 3),
}


def pvrtc_mode_counts(blocks: np.ndarray, right: np.ndarray,
                      below: np.ndarray):
    """(intermediate, vertical_count, horizontal_count) of (..., 4, 8)
    modulation blocks whose right neighbours' column 0 is ``right``
    (..., 4) and lower neighbours' row 0 is ``below`` (..., 8)."""
    nh = np.concatenate([blocks[..., 1:], right[..., None]], axis=-1)
    nv = np.concatenate([blocks[..., 1:, :], below[..., None, :]], axis=-2)
    return (((blocks == 1) | (blocks == 2)).sum((-2, -1)),
            np.abs(blocks - nh).sum((-2, -1)), np.abs(blocks - nv).sum((-2, -1)))


def pvrtc_mode_thresholds(side: int, batch: int = 1, seed: int = 41,
                          steps: int = 2000):
    """Modulation at the mode thresholds of :data:`PVRTC_MODE_THRESHOLDS`:
    (batch * NB, 32) uint8 values 0..3 of ``batch`` (side, side) images,
    blocks row-major, pixel (py, px) at py * 8 + px, and (batch * NB,) the
    index of the threshold each block is at, or -1.

    The blocks at even (by, bx) are each aimed at one threshold, in turn;
    the others are random, with row 0 and column 0 one random value a
    block. An aimed block's counters read its right neighbour's column 0
    and its lower neighbour's row 0, never an aimed block's, so each is
    aimed alone: a random walk from a block of even rows (for the
    horizontal thresholds, of even columns) changes one pixel a step and
    keeps a change that does not raise the block's penalty, or one in 50
    at random; a block not at its threshold after ``steps`` steps is
    labelled -1. On a one-block-wide grid a block is its own right
    neighbour."""
    rng = np.random.default_rng(seed)
    nby, nbx = side // 4, side // 8
    m = rng.integers(0, 4, (batch, nby, nbx, 4, 8))
    edge = np.zeros((4, 8), bool)
    edge[0] = edge[:, 0] = True
    m = np.where(edge, rng.integers(0, 4, (batch, nby, nbx, 1, 1)), m)
    by, bx = np.meshgrid(np.arange(nby), np.arange(nbx), indexing="ij")
    aimed = np.broadcast_to((by % 2 == 0) & (bx % 2 == 0), (batch, nby, nbx))
    labels = list(PVRTC_MODE_THRESHOLDS)
    target = np.arange(int(aimed.sum())) % len(labels)
    below = np.roll(m, -1, axis=1)[..., 0, :][aimed]
    right = np.roll(m, -1, axis=2)[..., :, 0][aimed] if nbx > 1 else None

    def penalty(blocks):
        counts = pvrtc_mode_counts(
            blocks, blocks[..., :, 0] if right is None else right, below)
        p = np.zeros(len(blocks), np.int64)
        for k, label in enumerate(labels):
            p = np.where(target == k, PVRTC_MODE_THRESHOLDS[label][0](*counts), p)
        return p

    horizontal = np.array([labels[k].startswith("horizontal") for k in target])
    cols = m[aimed][..., :, :1] if right is None else right[..., None]
    blocks = np.where(horizontal[:, None, None], np.repeat(cols, 8, axis=2),
                      np.repeat(below[:, None, :], 4, axis=1))
    pen = penalty(blocks)
    n = np.arange(len(blocks))
    for _ in range(steps):
        if not pen.any():
            break
        step = blocks.copy()
        step[n, rng.integers(0, 4, len(n)), rng.integers(0, 8, len(n))] = \
            rng.integers(0, 4, len(n))
        new = penalty(step)
        take = ((new <= pen) | (rng.random(len(n)) < 0.02)) & (pen > 0)
        blocks = np.where(take[:, None, None], step, blocks)
        pen = np.where(take, new, pen)
    m[aimed] = blocks
    label = np.full(aimed.shape, -1)
    label[aimed] = np.where(pen == 0, target, -1)
    return m.reshape(-1, 32).astype(np.uint8), label.reshape(-1)


def hq_kernel_cases(rgb_hq: torch.Tensor) -> dict:
    """The two HQ kernels' cases, at the inputs the HQ encoders give them:
    the prefix sums and the candidate words of the 1024^2 test image's
    blocks and of :func:`special_blocks`, and random prefix sums. Then the
    cases that test how the kernels split the work: the cluster-fit table
    cut to its first 4 and 13 rows (empty and short slices of the 8 warps),
    65,541 blocks (a ragged last CTA) for both kernels, and 37 candidates
    (a ragged last chunk of 8) and 1 candidate for the search. The fused
    fit's cases (no candidates) take the image's, the special and
    :func:`etc_hq_tie_blocks`' blocks and the 65,541, each flip."""
    cuts, qtab = dxt_hq._cf_device_tables(torch.device("cuda"))
    sets = {"image": image_to_blocks(rgb_hq), "special": special_blocks()}
    g = torch.Generator(device="cuda").manual_seed(19)
    random_prefix = torch.randint(0, 4081, (65536, 17, 3), generator=g,
                                  dtype=torch.int32, device="cuda")
    topk4, search = [], []
    prefix, pixels, words = {}, {}, {}
    for label, blocks in sets.items():
        prefix[label] = dxt_hq._prefix_sums(blocks,
                                            dxt_hq._pca_project(blocks)[2])
        topk4.append((label, (prefix[label], cuts, qtab)))
        pixels[label] = etc_cuda.pack_pixels(blocks)
        for flip in (False, True):
            words[label, flip] = etc.hq_candidate_words(blocks, flip)
            search.append((f"{label} flip {int(flip)}",
                           (pixels[label], words[label, flip], flip)))
    topk4.append(("random prefix sums", (random_prefix, cuts, qtab)))
    for rows in (4, 13):
        topk4.append((f"table cut to {rows} rows",
                      (prefix["image"], cuts[:rows].contiguous(),
                       qtab[:rows].contiguous())))
    n = 65536 + 5
    topk4.append((f"{n} blocks", (torch.cat([prefix["image"],
                                             prefix["special"][:5]]),
                                  cuts, qtab)))
    for k, flip in ((37, False), (1, True)):
        search.append((f"image flip {int(flip)}, {k} candidates",
                       (pixels["image"], words["image", flip][:k].contiguous(),
                        flip)))
    search.append((f"{n} blocks flip 0", (
        torch.cat([pixels["image"], pixels["special"][:5]]),
        torch.cat([words["image", False],
                   words["special", False][:, :, :5]], dim=2).contiguous(),
        False)))
    ties = etc_cuda.pack_pixels(torch.from_numpy(etc_hq_tie_blocks()).cuda())
    fit = [(f"{label} flip {int(flip)}", (px, None, flip))
           for label, px in (("image", pixels["image"]),
                             ("special", pixels["special"]), ("ties", ties),
                             (f"{n} blocks", torch.cat([pixels["image"],
                                                        pixels["special"][:5]])))
           for flip in (False, True)]
    return {"dxt_hq_cluster_topk4": topk4, "etc1_hq_search": search,
            "etc1_hq_fit_search": fit}


#: Kernels whose registers, shared memory and occupancy phase 3 prints:
#: name -> (C entry point, its argument values and their labels).
OCCUPANCY = {
    "dxt1_encode": ("texcomp_dxt_encode_info", ((0,), "")),
    "dxt5_encode": ("texcomp_dxt_encode_info", ((1,), "")),
    "dxt1_downsample": ("texcomp_dxt_downsample_info", ((0,), "")),
    "dxt5_downsample": ("texcomp_dxt_downsample_info", ((1,), "")),
    "dxt_hq_cluster_topk4": ("texcomp_dxt_hq_cluster_topk4_info", ((), "")),
    "etc1_hq_search": ("texcomp_etc1_hq_search_info", ((0, 1), "flip")),
    "etc1_hq_fit_search": ("texcomp_etc1_hq_fit_search_info", ((0, 1), "flip")),
    "etc1_encode": ("texcomp_etc1_encode_info", ((2, 0, 1, 3), "s")),
    "etc1_downsample": ("texcomp_etc1_downsample_info", ((2, 0, 1, 3), "s")),
    "pvrtc_morph": ("texcomp_pvrtc_info", ((0,), "")),
    "pvrtc_morph_batched": ("texcomp_pvrtc_info", ((1,), "")),
    "pvrtc_upscale_modulate": ("texcomp_pvrtc_info", ((2,), "")),
    "pvrtc_modes_pack": ("texcomp_pvrtc_info", ((3,), "")),
    "pvrtc_upscale_modulate_halo": ("texcomp_pvrtc_info", ((4,), "")),
    "pvrtc_modes_pack_strip": ("texcomp_pvrtc_info", ((5,), "")),
    # texcomp_pvrtc_hq_info's kernels: 0-3 the normal operator at 4x4 (J p,
    # image) and 4x8 (J p, image); 4-5 the choice at 4x4, 4x8; 6-7 a dot
    # pass (products, partials); 8-9 the dot's last pass at 64 values a
    # thread (products, partials), whose CTAs are of 512 threads.
    "pvrtc_hq_normal": ("texcomp_pvrtc_hq_info", ((0, 1, 2, 3), "kernel")),
    "pvrtc_hq_choose": ("texcomp_pvrtc_hq_info", ((4, 5), "kernel")),
    "pvrtc_hq_dot": ("texcomp_pvrtc_hq_info", ((6, 7, 8, 9), "kernel")),
}


def occupancy(name: str) -> str:
    """Registers per thread, static shared memory and resident CTAs per SM
    of kernel ``name`` (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor), as the card reports,
    for each variant (flip or strategy) it has; an entry without a label
    passes its values as they are."""
    lib = _build.load()
    entry, (values, label) = OCCUPANCY[name]

    def read(*args):
        buf = (ctypes.c_int * 3)()
        rc = getattr(lib, entry)(*args, ctypes.addressof(buf))
        if rc != 0:
            fail(f"{name} attributes: "
                 f"{lib.texcomp_cuda_error_string(rc).decode()}")
        return (f"{buf[0]} registers a thread, {buf[1]} B static shared "
                f"memory, {buf[2]} CTAs of 256 threads per SM")

    if not label:
        return read(*values)
    return "; ".join(f"{label} {v}: {read(v)}" for v in values)


def measure_rates() -> None:
    """Runs csrc/etc.cu's rate micro-kernels (:data:`RATE_KINDS`) on 16
    CTAs per SM and sets :data:`RATES`; prints each rate and the SASS of
    the search's inner loop (kind 3) as cuobjdump gives it."""
    lib = _build.load()
    ctas = 16 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 200
    out = torch.empty(ctas * 256, dtype=torch.int32, device="cuda")

    def launch(kind):
        rc = lib.texcomp_etc1_rate(kind, ctas, iters, out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"rate kernel {kind}: "
                 f"{lib.texcomp_cuda_error_string(rc).decode()}")

    parts = []
    for kind, (what, per) in RATE_KINDS.items():
        ms = cuda_time_ms(lambda: launch(kind), repeats=5)
        RATES[kind] = ctas * 256 * iters * per / (ms * 1e-3)
        parts.append(f"{kind} {what} {RATES[kind] / 1e12:.3f} T/s")
    print(f"[kernels] rates on the card (csrc/etc.cu rate kernels, {ctas} "
          f"CTAs of 256): {'; '.join(parts)}", flush=True)
    print(f"[kernels] search inner loop SASS (rate kind 3, 512 pairs an "
          f"iteration): {sass_opcodes('rate_kernelILi3E')}", flush=True)


#: Kernels whose SASS instruction count phase 3 prints: name -> a part of
#: the mangled name of their kernel.
SASS = {"dxt1_encode": "encode_kernelILb0E", "dxt5_encode": "encode_kernelILb1E",
        "dxt1_downsample": "downsample_kernelILb0E",
        "dxt5_downsample": "downsample_kernelILb1E",
        "pvrtc_morph": "morph_kernelILb0E",
        "pvrtc_morph_batched": "morph_kernelILb1E",
        "pvrtc_upscale_modulate": "upscale_modulate_kernel",
        "pvrtc_modes_pack": "modes_pack_kernelILi1E",
        "pvrtc_upscale_modulate_halo": "upscale_modulate_halo_kernel",
        "pvrtc_modes_pack_strip": "modes_pack_strip_kernel",
        "etc1_hq_search": "hq_search_kernelILb0ELb0E",
        "etc1_hq_fit_search": "hq_search_kernelILb0ELb1E",
        "pvrtc_hq_normal": "normal_kernelILi4ELi4ELb0E",
        "pvrtc_hq_choose": "choose_kernelILi4ELi4E",
        "pvrtc_hq_dot": "dot_pass_kernelILb1E"}


@functools.lru_cache(maxsize=None)
def _sass(library: str) -> str:
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return ""
    return subprocess.run([str(tool), "-sass", library], capture_output=True,
                          text=True, timeout=300).stdout


def library_occupancy(kernel: str, library: str) -> str:
    """Registers per thread and resident CTAs of 256 threads per SM of the
    first kernel whose mangled name holds ``kernel`` in ``library``, a build
    of this repository's sources that need not have the info entry points
    (an older commit's): its cubins, as cuobjdump extracts them, loaded
    with libcuda's module and occupancy calls."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    names = [fn.split("\n", 1)[0].strip()
             for fn in _sass(library).split("Function : ")[1:]]
    name = next((n for n in names if kernel in n), None)
    if not tool.is_file() or name is None:
        return f"{kernel}: not measured (no cuobjdump or no such kernel)"
    torch.zeros(1, device="cuda")  # a current context for libcuda
    cuda = ctypes.CDLL("libcuda.so.1")
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([str(tool), "-xelf", "all", str(Path(library).resolve())],
                       cwd=tmp, capture_output=True, check=True, timeout=300)
        for cubin in sorted(Path(tmp).glob("*.cubin")):
            module, fn = ctypes.c_void_p(), ctypes.c_void_p()
            if cuda.cuModuleLoad(ctypes.byref(module), str(cubin).encode()):
                continue
            if cuda.cuModuleGetFunction(ctypes.byref(fn), module,
                                        name.encode()) == 0:
                regs, ctas = ctypes.c_int(), ctypes.c_int()
                cuda.cuFuncGetAttribute(ctypes.byref(regs), 4, fn)  # NUM_REGS
                cuda.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                    ctypes.byref(ctas), fn, 256, ctypes.c_size_t(0))
                cuda.cuModuleUnload(module)
                return (f"{regs.value} registers a thread, {ctas.value} CTAs "
                        f"of 256 threads per SM")
            cuda.cuModuleUnload(module)
    return f"{kernel}: not measured (not found in the extracted cubins)"


def sass_opcodes(kernel: str, library=None) -> str:
    """The instruction count and the most frequent opcodes of the first
    kernel whose mangled name holds ``kernel``, in the SASS of ``library``
    (by default the built one) as cuobjdump gives it."""
    dump = _sass(str(library or _build.library_path()))
    if not dump:
        return "cuobjdump not found"
    for fn in dump.split("Function : ")[1:]:
        if kernel not in fn.split("\n", 1)[0]:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn))
        return f"{sum(ops.values())} instructions: " + ", ".join(
            f"{op} {n}" for op, n in ops.most_common(12))
    return f"{kernel} not found in the SASS"


def kernel_cases(rgb: torch.Tensor, rgba: torch.Tensor, pv: dict,
                 rgb_hq: torch.Tensor, atlas: torch.Tensor) -> dict:
    """kernel name -> [(label, args)]; the first case of each is timed.
    ``pv`` holds the PVRTC inputs (:func:`pvrtc_images`), ``rgb_hq`` the
    1024^2 image of the HQ kernels, ``atlas`` the 8192^2 PVRTC atlas."""
    g = torch.Generator().manual_seed(7)
    rand8 = torch.randint(0, 256, (PIXELS // 16, 8), generator=g,
                          dtype=torch.uint8).cuda()
    rand16 = torch.randint(0, 256, (PIXELS // 16, 16), generator=g,
                           dtype=torch.uint8).cuda()
    edge = {}  # every block of the 4096^2 grid drawn from edge_words' set
    for is_dxt1 in (True, False):
        words = torch.from_numpy(edge_words(is_dxt1))
        pick = torch.randint(0, len(words), (PIXELS // 16,), generator=g)
        edge[is_dxt1] = words[pick].cuda()
    rag_h, rag_w = SIZE - 9, SIZE - 13  # 4087 x 4083: 6 has_one_pixel blocks
    rgb_rag = rgb[:rag_h, :rag_w].contiguous()
    rgba_rag = rgba[:rag_h, :rag_w].contiguous()
    outside = full_outside_mask(rag_h, rag_w, SIZE, SIZE, device="cuda")
    if int(outside.sum()) != 6:
        fail(f"ragged grid has {int(outside.sum())} has_one_pixel blocks, want 6")
    dxt1_payload = dxt_cuda.dxt1_encode_cuda(rgb, SIZE, SIZE)
    dxt5_payload = dxt_cuda.dxt5_encode_cuda(rgba, SIZE, SIZE)
    etc_payload = etc_cuda.etc1_encode_cuda(rgb, SIZE, SIZE, etc.SMALLER_ERROR)
    ties = tie_image()
    nb = SIZE // 4
    strategies = [etc.SMALLER_ERROR, etc.SPLIT_HORIZONTALLY,
                  etc.SPLIT_VERTICALLY, etc.HEURISTIC]
    dxt_extra = dxt_encode_cases(rgb, rgba)
    return {
        "dxt1_encode": [
            ("rgb", (rgb, SIZE, SIZE, False, False)),
            ("bgr", (rgb, SIZE, SIZE, True, False)),
            ("rgb always4", (rgb, SIZE, SIZE, False, True)),
            ("bgr always4", (rgb, SIZE, SIZE, True, True)),
            ("rgbx input", (rgba, SIZE, SIZE, False, False)),
            ("ragged rgb", (rgb_rag, SIZE, SIZE, False, False)),
            ("ragged bgr", (rgb_rag, SIZE, SIZE, True, False)),
        ] + [(f"{label} {fmt}{' always4' * a4}", (img, *grid, swap, a4))
             for label, images, grid in dxt_extra
             for fmt, img, swap in images[:3] for a4 in (False, True)],
        "dxt5_encode": [
            ("rgba", (rgba, SIZE, SIZE, False)),
            ("bgra", (rgba, SIZE, SIZE, True)),
            ("ragged rgba", (rgba_rag, SIZE, SIZE, False)),
            ("ragged bgra", (rgba_rag, SIZE, SIZE, True)),
        ] + [(f"{label} {fmt}", (img, *grid, swap))
             for label, images, grid in dxt_extra
             for fmt, img, swap in images[2:]],
        "dxt1_decode": [
            ("random", (rand8, SIZE, SIZE, False, False)),
            ("random swap", (rand8, SIZE, SIZE, True, False)),
            ("random always4", (rand8, SIZE, SIZE, False, True)),
            ("random swap always4", (rand8, SIZE, SIZE, True, True)),
            ("encoded", (dxt1_payload, SIZE, SIZE, False, False)),
        ],
        "dxt5_decode": [
            ("random", (rand16, SIZE, SIZE, False)),
            ("random swap", (rand16, SIZE, SIZE, True)),
            ("encoded", (dxt5_payload, SIZE, SIZE, False)),
        ],
        "dxt1_downsample": [
            ("encoded", (dxt1_payload, nb, nb, True)),
            ("random", (rand8, nb, nb, True)),
            ("edge words", (edge[True], nb, nb, True)),
        ],
        "dxt5_downsample": [
            ("encoded", (dxt5_payload, nb, nb, False)),
            ("random", (rand16, nb, nb, False)),
            ("edge words", (edge[False], nb, nb, False)),
        ],
        "etc1_encode": [
            (f"{label} s{s}", (img, SIZE, SIZE, s))
            for label, img in (("rgb", rgb), ("rgbx input", rgba),
                               ("ragged rgb", rgb_rag))
            for s in strategies]
            + [(f"ties s{s}", (ties, 512, 512, s)) for s in strategies],
        "etc1_decode": [
            ("encoded", (etc_payload, SIZE, SIZE)),
            ("random", (rand8, SIZE, SIZE)),
        ],
        "etc1_downsample": [
            (f"{label} s{s}", (data, nb, nb, s))
            for label, data in (("encoded", etc_payload), ("random", rand8))
            for s in strategies],
        **pvrtc_kernel_cases(pv),
        **pvrtc_strip_cases(atlas, pv),
        **hq_kernel_cases(rgb_hq),
        **pvrtc_hq_fit_cases(pv["tiles"][:HQ_SIZE, :HQ_SIZE]),
    }


def pvrtc_hq_fit_cases(rgba_hq: torch.Tensor) -> dict:
    """The HQ PVRTC fit kernels' cases. First, timed, what the 4bpp encode
    of the 1024^2 RGBA image ``rgba_hq`` gives them: A/B from its raw block
    extremes, the blend weights chosen against them, the normal operator
    of A/B (the CG's most frequent call), the dot of A/B with it. Then the
    same at 4x8 blocks (2bpp), both forms of the normal operator, t of each
    single value of ``_T``, random A/B, images and weights at sides 8, 16,
    64 and 256, and dots of 1, 7, 4,097 and 2^20 random values."""
    g = torch.Generator(device="cuda").manual_seed(43)
    img_f = rgba_hq.to(torch.float32)
    normal, dot, choose = [], [], []
    for bh, bw in ((4, 4), (4, 8)):
        lo, hi = pvrtc._morph_extremes(rgba_hq.to(torch.int32), bh, bw)
        ab = torch.stack([lo, hi]).to(torch.float32)
        t = pvrtc_hq_cuda.pvrtc_hq_choose_plain(img_f, ab)
        shape = f"{HQ_SIZE}^2 {bh}x{bw}"
        normal += [(f"{shape} J p", (ab, t, None)),
                   (f"{shape} image", (ab, t, img_f))]
        hp = pvrtc_hq_cuda.pvrtc_hq_normal_plain(ab, t)
        dot.append((shape, (ab, hp)))
        choose.append((shape, (img_f, ab)))
        for tv in pvrtc_hq._T:
            normal.append((f"{shape} t = {tv}",
                           (ab, torch.full_like(t, tv), None)))
        for side in (8, 16, 64, 256):
            x = torch.rand((2, side // bh, side // bw, 4), generator=g,
                           device="cuda") * 340 - 40
            im = torch.randint(0, 256, (side, side, 4), generator=g,
                               device="cuda").to(torch.float32)
            pick = torch.randint(0, 4, (side, side), generator=g,
                                 device="cuda")
            tr = torch.tensor(pvrtc_hq._T, device="cuda")[pick]
            label = f"random {side}^2 {bh}x{bw}"
            normal += [(f"{label} J p", (x, tr, None)),
                       (f"{label} image", (x, tr, im))]
            choose.append((label, (im, x)))
    for n in (1, 7, 4097, 1 << 20):
        v = torch.randn((2, 2, n), generator=g, device="cuda")
        mag = torch.rand((2, 2, n), generator=g, device="cuda") * 8 - 4
        v = v * 10.0 ** mag
        dot.append((f"random {n} a leaf", (v[0], v[1])))
    return {"pvrtc_hq_normal": normal, "pvrtc_hq_dot": dot,
            "pvrtc_hq_choose": choose}


def pvrtc_case_inputs() -> dict:
    """The PVRTC kernels' cases beyond the 4096^2 images and the fleets, as
    (B, H, W, 4) uint8 stacks on the card: "axis ties" (a 256^2 image of
    :func:`pvrtc_tie_blocks`' axis, lightness and equal-spread ties, and a
    stack of its four 128^2 quarters), "zero axes" (the same of its
    zero-axis blocks), "small grids" (8^2, 16^2 and 32^2 images of tie
    blocks, one-block-wide at 8^2, and a stack of 64 such 8^2 images)."""
    ties = pvrtc_tie_blocks()
    axis = np.concatenate([ties["axis ties"], ties["lightness ties"],
                           ties["equal spreads"]])
    out = {}
    for label, blocks in (("axis ties", axis), ("zero axes", ties["zero axes"])):
        img = pvrtc_block_image(blocks, 256)
        out[label] = img[None]
        out[f"{label}, quarters"] = img.reshape(2, 128, 2, 128, 4).transpose(
            0, 2, 1, 3, 4).reshape(4, 128, 128, 4)
    every = np.concatenate([axis, ties["zero axes"]])
    for side in (8, 16, 32):
        out[f"small grids {side}x{side}"] = pvrtc_block_image(
            every[side:], side, seed=side)[None]
    out["small grids 64 x 8x8"] = np.stack(
        [pvrtc_block_image(every[k:], 8, seed=k) for k in range(64)])
    return {label: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for label, v in out.items()}


def pvrtc_kernel_cases(images: dict) -> dict:
    """The PVRTC kernels' cases; each stage's input comes from the kernel
    before it (which phase 3 holds to its twin on the same inputs), except
    the "modulation ties" input of upscale + modulate
    (:func:`pvrtc_modulation_ties`)."""
    image, tiles = images["random"], images["tiles"]
    other = torch.tensor([9, 200, 31, 77], dtype=torch.uint8, device="cuda")
    nby, nbx = SIZE // 4, SIZE // 8
    extra = pvrtc_case_inputs()
    single = ["axis ties", "zero axes", "small grids 8x8", "small grids 16x16",
              "small grids 32x32"]
    stacked = ["axis ties, quarters", "zero axes, quarters",
               "small grids 64 x 8x8"]
    stack = {"random": image[None], "tiles": tiles[None],
             f"fleet {FLEET[0]}x{FLEET[1]}": images["fleet"],
             f"fleet {SMALL_FLEET[0]}x{SMALL_FLEET[1]}": images["small fleet"],
             **extra}
    ab = {"random": pvrtc_cuda.pvrtc_morph_cuda(image, image[0, 0]),
          "tiles": pvrtc_cuda.pvrtc_morph_cuda(tiles, tiles[0, 0])}
    for label in single:
        ab[label] = pvrtc_cuda.pvrtc_morph_cuda(stack[label][0],
                                                stack[label][0, 0, 0])
    batched = list(stack)[2:4] + stacked
    for label in batched:
        ab[label] = pvrtc_cuda.pvrtc_morph_batched_cuda(stack[label])
    mod_images, mod_ab = pvrtc_modulation_ties()
    stack["modulation ties"] = torch.from_numpy(mod_images).cuda()
    ab["modulation ties"] = torch.from_numpy(mod_ab).cuda()
    mod = {label: pvrtc_cuda.pvrtc_upscale_modulate_cuda(stack[label], ab[label])
           for label in stack}
    g = torch.Generator(device="cuda").manual_seed(13)
    rand_mod = torch.randint(0, 4, (nby * nbx, 32), generator=g,
                             dtype=torch.uint8, device="cuda")
    grid = {label: (t.shape[1] // 4, t.shape[2] // 8)
            for label, t in stack.items()}
    return {
        "pvrtc_morph": [
            ("random", (image, image[0, 0])),
            ("tiles", (tiles, tiles[0, 0])),
            ("tiles, another fallback pixel", (tiles, other))]
            + [(label, (stack[label][0], stack[label][0, 0, 0]))
               for label in single]
            + [(f"{label}, another fallback pixel", (stack[label][0], other))
               for label in single[:2]],
        "pvrtc_morph_batched": [
            (label, (stack[label],)) for label in batched],
        "pvrtc_upscale_modulate": [
            (label, (stack[label], ab[label])) for label in stack],
        "pvrtc_modes_pack": [
            (label, (mod[label], ab[label], *grid[label])) for label in stack]
            + [("random modulation", (rand_mod, ab["random"], nby, nbx))]
            + pvrtc_threshold_cases(),
    }


def pvrtc_threshold_cases() -> list:
    """Mode + pack's cases at the mode thresholds
    (:func:`pvrtc_mode_thresholds`), as [(label, (mod, ab, nby, nbx))] on
    the card: a 256^2 image's blocks tiled over the 4096^2 grid (whose wrap
    is then the small image's), one 8^2 image (one block wide, 30 spare
    lanes in its warp), 64 8^2 images, 32 16^2 images (a warp spans four)
    and 16 64^2 images (a CTA spans two); ab random words, A and B opaque in
    every third block."""
    rng = np.random.default_rng(43)
    cases = []
    for label, side, batch in (("4096^2 grid", 256, 1), ("8x8", 8, 1),
                               ("64 x 8x8", 8, 64), ("32 x 16x16", 16, 32),
                               ("16 x 64x64", 64, 16)):
        mod, _ = pvrtc_mode_thresholds(side, batch)
        nby, nbx = side // 4, side // 8
        if side == 256:
            mod = np.tile(mod.reshape(nby, nbx, 32),
                          (SIZE // side, SIZE // side, 1)).reshape(-1, 32)
            nby, nbx = SIZE // 4, SIZE // 8
        ab = rng.integers(0, 1 << 32, (len(mod), 2), dtype=np.uint64).astype(np.uint32)
        ab[::3] |= 0xFF000000
        cases.append((f"mode thresholds, {label}",
                      (torch.from_numpy(mod).cuda(),
                       torch.from_numpy(ab.view(np.int32)).cuda(), nby, nbx)))
    return cases


#: The PVRTC atlas: one 8192^2 RGBA texture (256 MiB, 2,097,152 blocks),
#: the size at which texcomp sends the morph to Pallas at all
#: (pvrtc_fast.py:664-669), on ATLAS_DATA "data" devices; and the 4bpp
#: atlas at 4096^2.
ATLAS_SIZE = 8192
ATLAS_DATA = 4
ATLAS4_SIZE = 4096
#: The strip variants, launched only by the atlas (phase 7).
ATLAS_KERNELS = ("pvrtc_upscale_modulate_halo", "pvrtc_modes_pack_strip")


def atlas_image(pv: dict) -> torch.Tensor:
    """The 8192^2 RGBA atlas on the card: the "tiles" test image and the
    random image of :func:`pvrtc_images` in a 2x2 grid (flipped below), its
    first two block rows all zero (so the fallback pixel (0, 0) of every
    strip's all-zero axes is the whole image's) and rows correlated across
    the first strip boundary, as texcomp's atlas tests make them."""
    tiles, rand = pv["tiles"], pv["random"]
    img = torch.cat([torch.cat([tiles, rand], dim=1),
                     torch.cat([rand.flip(0), tiles.flip(1)], dim=1)])
    img = img.contiguous()
    img[:8] = 0
    edge = ATLAS_SIZE // ATLAS_DATA
    img[edge - 4:edge + 4] = img[4:12]
    return img


def _strip_inputs(image: torch.Tensor, shards: int, k: int, ab, mod):
    """The inputs strip ``k`` of ``image`` over ``shards`` has in an atlas:
    its pixels, its (A, B) words and the rows its neighbours send (the
    previous strip's last low-res row, the next one's first, and the next
    one's first modulation row group), sliced from the whole image's
    morph ``ab`` (nby, nbx, 2) and modulation ``mod`` (nby, nbx, 32)."""
    nby, nbx = ab.shape[:2]
    rows = nby // shards
    y0, y1 = k * rows, (k + 1) * rows
    strip = image[4 * y0:4 * y1]
    return (strip, ab[y0:y1].reshape(-1, 2), ab[y0 - 1].contiguous(),
            ab[y1 % nby].contiguous(), mod[y0:y1].reshape(-1, 32),
            mod[y1 % nby, :, :8].contiguous(), rows, nbx)


def pvrtc_strip_cases(atlas: torch.Tensor, pv: dict) -> dict:
    """The strip variants' cases, as an atlas's strips call them: the
    8192^2 atlas's first strip of 4 (2048 x 8192, the atlas's strip size;
    timed) and its other three; the 4096^2 random image over 1, 2, 8 and
    1,024 shards (every 32nd strip and the last of 1,024: one block row a
    strip, both halos foreign); a strip whose halo rows come from another
    image (the "tiles" image), so a kernel that ignored them would differ;
    the "modulation ties" input and the "mode thresholds" blocks (256^2)
    cut into 8 strips. The strip morph is held to its twin and to the whole
    image's morph on the way."""
    sources = {"atlas": atlas, "random": pv["random"], "tiles": pv["tiles"]}
    whole = {}
    for label, img in sources.items():
        nby, nbx = img.shape[0] // 4, img.shape[1] // 8
        ab = pvrtc_cuda.pvrtc_morph_cuda(img, img[0, 0])
        mod = pvrtc_cuda.pvrtc_upscale_modulate_cuda(img[None], ab)
        whole[label] = (ab.reshape(nby, nbx, 2), mod.reshape(nby, nbx, 32))
    picks = [("atlas", ATLAS_DATA, k) for k in range(ATLAS_DATA)]
    picks += [("random", 1, 0), ("random", 2, 0), ("random", 2, 1)]
    picks += [("random", 8, k) for k in range(8)]
    picks += [("random", 1024, k) for k in range(0, 1024, 32)] + [
        ("random", 1024, 1023)]
    up, pack = [], []
    for label, shards, k in picks:
        strip, ab, top, bot, mod, halo_v, rows, nbx = _strip_inputs(
            sources[label], shards, k, *whole[label])
        if k < 2 or shards == 1024 and k % 256 == 0:
            morph = pvrtc_cuda.pvrtc_morph_strip_cuda(strip,
                                                      sources[label][0, 0])
            plain = pvrtc_cuda.pvrtc_morph_strip_plain(strip,
                                                       sources[label][0, 0])
            if not (torch.equal(morph, ab) and torch.equal(plain, ab)):
                fail(f"the strip morph of {label} strip {k} of {shards} "
                     "differs from the whole image's")
        name = f"{label} strip {k} of {shards}"
        up.append((name, (strip, ab, top, bot)))
        pack.append((name, (mod, ab, halo_v, rows, nbx)))
    # Halo rows of another image: the tiles image's rows around strip 3 of
    # 8 in place of the random image's.
    strip, ab, _, _, mod, _, rows, nbx = _strip_inputs(
        sources["random"], 8, 3, *whole["random"])
    _, _, top, bot, _, halo_v, _, _ = _strip_inputs(
        sources["tiles"], 8, 3, *whole["tiles"])
    up.append(("random strip 3 of 8, tiles' halo rows", (strip, ab, top, bot)))
    pack.append(("random strip 3 of 8, tiles' modulation row",
                 (mod, ab, halo_v, rows, nbx)))
    # The modulation ties and the mode thresholds, in 8 strips.
    ties_img, ties_ab = pvrtc_modulation_ties()
    ties_img = torch.from_numpy(ties_img[0]).cuda()
    ties_ab = torch.from_numpy(ties_ab).cuda()
    nby, nbx = ties_img.shape[0] // 4, ties_img.shape[1] // 8
    ties_mod = pvrtc_cuda.pvrtc_upscale_modulate_cuda(ties_img[None], ties_ab)
    thr_mod, _ = pvrtc_mode_thresholds(256)
    thr_mod = torch.from_numpy(thr_mod).cuda().reshape(nby, nbx, 32)
    for k in range(8):
        strip, ab, top, bot, _, _, rows, _ = _strip_inputs(
            ties_img, 8, k, ties_ab.reshape(nby, nbx, 2),
            ties_mod.reshape(nby, nbx, 32))
        up.append((f"modulation ties strip {k} of 8", (strip, ab, top, bot)))
        _, _, _, _, mod, halo_v, _, _ = _strip_inputs(
            ties_img, 8, k, ties_ab.reshape(nby, nbx, 2), thr_mod)
        pack.append((f"mode thresholds strip {k} of 8",
                     (mod, ab, halo_v, rows, nbx)))
    return {"pvrtc_upscale_modulate_halo": up, "pvrtc_modes_pack_strip": pack}


def _unfused_level(name: str, args: tuple):
    """The level of ``name``'s fused downsample as decode kernel, torch
    average and encode kernel."""
    data, nby, nbx = args[:3]
    h, w = 4 * nby, 4 * nbx
    if name == "etc1_downsample":
        return lambda: etc_cuda.etc1_encode_cuda(dxt_cuda.average_2x2(
            etc_cuda.etc1_decode_cuda(data, h, w)[:, :, :3]), h // 2, w // 2,
            args[3])
    if name == "dxt1_downsample":
        return lambda: dxt_cuda.dxt1_encode_cuda(dxt_cuda.average_2x2(
            dxt_cuda.dxt1_decode_cuda(data, h, w)[:, :, :3]), h // 2, w // 2)
    return lambda: dxt_cuda.dxt5_encode_cuda(dxt_cuda.average_2x2(
        dxt_cuda.dxt5_decode_cuda(data, h, w)), h // 2, w // 2)


def _difference(got, want) -> float:
    """The largest absolute difference of two outputs (a tensor or a tuple
    of them): -1 on a shape mismatch, inf where float bits differ (the
    cluster-fit payload must equal its twin's bit for bit)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            return -1
        if a.is_floating_point():
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                return float("inf")
        elif a.numel():
            worst = max(worst, int((a.long() - b.long()).abs().max()))
    return worst


def fit_against_candidates(cases) -> None:
    """Each case of the fused fit equals the search kernel given the twin's
    candidates (``codecs.etc.hq_candidate_words``), word for word."""
    for label, (px, _, flip) in cases:
        rgb = torch.stack([px & 255, (px >> 8) & 255, (px >> 16) & 255], dim=-1)
        words = etc.hq_candidate_words(rgb, flip).contiguous()
        got = etc_cuda.etc1_hq_search_cuda(px, None, flip)
        want = etc_cuda.etc1_hq_search_cuda(px, words, flip)
        torch.cuda.synchronize()
        err = _difference(got, want)
        if err != 0:
            fail(f"etc1_hq_fit_search [{label}] differs from the search over "
                 f"hq_candidate_words: max abs err {err}")
    print(f"[kernels] etc1_hq_fit_search: {len(cases)} cases equal to "
          f"etc1_hq_search over hq_candidate_words", flush=True)


def phase_kernels(rgb: torch.Tensor, rgba: torch.Tensor, pv: dict,
                  rgb_hq: torch.Tensor, atlas: torch.Tensor) -> dict:
    """Kernel vs plain on the card; returns per-kernel results."""
    measure_rates()
    cases = kernel_cases(rgb, rgba, pv, rgb_hq, atlas)
    results = {}
    for name, (replaces, source, plain, kernel) in KERNELS.items():
        worst = 0
        for label, args in cases[name]:
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = _difference(got, want)
            worst = max(worst, err)
            if err != 0:
                fail(f"{name} [{label}] differs from its plain twin: "
                     f"max abs err {err} (-1: shapes differ, inf: float bits)")
        timed = cases[name][0][1]
        out = kernel(*timed)
        ms = cuda_time_ms(lambda: kernel(*timed), repeats=20)
        plain_ms = cuda_time_ms(lambda: plain(*timed), repeats=5)
        bound_ms, bound_by, note = kernel_bound(name, timed, out)
        results[name] = {"replaces": replaces, "source": source,
                         "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[kernels] {name}: {len(cases[name])} cases equal to plain "
              f"(max abs err {worst}); [{cases[name][0][0]}] kernel {ms:.4f} "
              f"ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({note}; {bound_ms / ms:.1%} of it)", flush=True)
        if name.endswith("downsample"):
            # The per-level route the fused kernel replaces: decode kernel,
            # 2x2 average in torch, encode kernel.
            unfused = _unfused_level(name, timed)
            t = cuda_time_ms(unfused, repeats=20)
            print(f"[kernels] {name}: decode + average + encode kernels "
                  f"{t:.4f} ms against fused {ms:.4f} ms", flush=True)
        if name.startswith("pvrtc"):
            # The fleets' times beside the timed case's.
            per = []
            for label, args in cases[name][1:]:
                if label.startswith("fleet"):
                    t = cuda_time_ms(lambda: kernel(*args), repeats=20)
                    b_ms, b_by, _ = kernel_bound(name, args, kernel(*args))
                    per.append(f"{label} {t:.4f} ms (bound {b_ms:.4f} by {b_by})")
            if per:
                print(f"[kernels] {name} on the fleets: {'; '.join(per)}",
                      flush=True)
        if name.startswith(("dxt_hq", "etc1_hq", "pvrtc_hq")):
            # The other inputs' times beside the timed case's, and the
            # kernel's registers and occupancy.
            per = []
            for label, args in cases[name][1:]:
                t = cuda_time_ms(lambda: kernel(*args), repeats=20)
                b_ms, b_by, _ = kernel_bound(name, args, kernel(*args))
                per.append(f"{label} {t:.4f} ms (bound {b_ms:.4f} by {b_by})")
            print(f"[kernels] {name} on its other inputs: {'; '.join(per)}",
                  flush=True)
        if name == "etc1_hq_fit_search":
            fit_against_candidates(cases[name])
        if name in ("etc1_encode", "etc1_downsample"):
            # Every strategy's time: the search differs by strategy.
            per = []
            for label, args in cases[name][1:4]:
                t = cuda_time_ms(lambda: kernel(*args), repeats=20)
                b_ms, b_by, _ = kernel_bound(name, args, out)
                per.append(f"{label} {t:.4f} ms (bound {b_ms:.4f} by {b_by})")
            print(f"[kernels] {name} by strategy: {'; '.join(per)}",
                  flush=True)
        if name in OCCUPANCY:
            print(f"[kernels] {name} on the card: {occupancy(name)}",
                  flush=True)
        if name in SASS:
            print(f"[kernels] {name} SASS: {sass_opcodes(SASS[name])}",
                  flush=True)
    return results


def phase_golden(gv) -> None:
    golden = ROOT / "tests" / "golden"
    expected = json.loads((golden / "expected.json").read_text())
    cases = reference_golden_cases(gv)
    for case in cases:
        got = golden_outputs(case, gv, "cuda")
        if got != expected[case["name"]]:
            fail(f"golden {case['name']}: {got} != {expected[case['name']]}")
    ext_expected = json.loads((golden / "extensions.json").read_text())
    for case in gv.EXT_CASES:
        got = extension_golden_outputs(case, gv, "cuda")
        if got != ext_expected[case["name"]]:
            fail(f"golden {case['name']}: {got} != {ext_expected[case['name']]}")
    hq_expected = json.loads((golden / "hq_torch.json").read_text())
    for case in HQ_CASES:
        got = golden_outputs(case, gv, "cuda", "high")
        if got != hq_expected[case["name"]]:
            fail(f"golden {case['name']}: {got} != {hq_expected[case['name']]}")
    print(f"[golden] {len(cases)} reference-mode golden digests "
          f"({len(dxtc_golden_cases(gv))} DXTC, ETC1, transcode, PVRTC), "
          f"{len(gv.EXT_CASES)} PVRTC extension digests and {len(HQ_CASES)} "
          f'quality="high" digests equal on cuda', flush=True)


class Launches:
    """The launch counts of the main path, summed over its phases; each
    phase must launch the kernels it names."""

    def __init__(self):
        self.total = {name: 0 for name in KERNELS}

    def run(self, what: str, kernels: tuple, fn):
        _launch.reset_launches()
        result = fn()
        counts = dict(_launch.LAUNCHES)
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            fail(f"{what} did not launch {missing}: {counts}")
        for k, n in counts.items():
            self.total[k] += n
        print(f"[main] {what}: launches {{"
              + ", ".join(f"{k}: {n}" for k, n in counts.items() if n)
              + "}", flush=True)
        return result


def _timed(fn, runs: int = 3):
    """fn() ``runs`` times; the last result and the wall times in s."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return result, times


def _wall(times) -> str:
    m = statistics.median(times)
    return (f"{m * 1e3:.1f} ms ({PIXELS / m / 1e6:.1f} Mpix/s; median of "
            f"{len(times)}, first {times[0] * 1e3:.1f} ms)")


def _round_trip(comp, fmt, img):
    ci = CompressedImage()
    t0 = time.perf_counter()
    _require(comp.compress(fmt, SIZE, SIZE, 0, img, ci), "compress")
    t1 = time.perf_counter()
    buf = bytearray()
    _require(comp.decompress(ci, buf), "decompress")
    return ci, buf, t1 - t0, time.perf_counter() - t1


def main_round_trips(images: dict, launches: Launches, gpu: str) -> dict:
    """compress -> decompress at 4096^2 through DxtcCompressor and
    EtcCompressor on cuda; returns the payloads."""
    payloads = {}
    runs = 3
    jobs = [("DXTC", DxtcCompressor(device="cuda"), Format.RGB,
             ("dxt1_encode", "dxt1_decode")),
            ("DXTC", DxtcCompressor(device="cuda"), Format.RGBA,
             ("dxt5_encode", "dxt5_decode")),
            ("ETC1", EtcCompressor(device="cuda"), Format.RGB,
             ("etc1_encode", "etc1_decode"))]
    for codec, comp, fmt, kernels in jobs:
        img = images[fmt]
        rounds = launches.run(
            f"{codec} {fmt.name} compress -> decompress x{runs}", kernels,
            lambda: [_round_trip(comp, fmt, img) for _ in range(runs)])
        ci, buf = rounds[-1][0], rounds[-1][1]
        dev = torch.from_numpy(img).cuda()
        if codec == "ETC1":
            payload = etc_cuda.etc1_encode_plain(dev, SIZE, SIZE,
                                                 etc.SMALLER_ERROR)
            decoded = etc_cuda.etc1_decode_plain(payload, SIZE, SIZE)[:, :, :3]
        elif fmt == Format.RGB:
            payload = dxt_cuda.dxt1_encode_plain(dev, SIZE, SIZE)
            decoded = dxt_cuda.dxt1_decode_plain(payload, SIZE, SIZE)[:, :, :3]
        else:
            payload = dxt_cuda.dxt5_encode_plain(dev, SIZE, SIZE)
            decoded = dxt_cuda.dxt5_decode_plain(payload, SIZE, SIZE)
        if not np.array_equal(ci.get_data(), payload.cpu().numpy().reshape(-1)):
            fail(f"{codec} {fmt.name}: payload differs from the plain path")
        if bytes(buf) != decoded.cpu().numpy().tobytes():
            fail(f"{codec} {fmt.name}: decoded bytes differ from the plain path")
        decoded_np = np.frombuffer(bytes(buf), np.uint8).reshape(img.shape)
        err = np.abs(decoded_np.astype(np.int16) - img).mean()
        tc = [r[2] for r in rounds]
        td = [r[3] for r in rounds]
        print(f"[main] {codec} {fmt.name} {SIZE}x{SIZE} on {gpu}: payload and "
              f"decoded bytes equal to plain; mean |decoded-input| {err:.2f}; "
              f"compress wall {_wall(tc)}, decompress wall {_wall(td)}, "
              f"incl. host<->device copies", flush=True)
        payloads[(codec, fmt)] = ci
    return payloads


def _plain_fns(codec: str, strategy: int):
    """encode_image_fn, decode_image_fn and downsample_fn of the Downsample
    route built from the plain twins, for the plain path on the card."""
    if codec == "etc1":
        return (lambda im, gh, gw: etc_cuda.etc1_encode_plain(im, gh, gw, strategy),
                etc_cuda.etc1_decode_plain,
                lambda d, by, bx: etc_cuda.etc1_downsample_plain(d, by, bx,
                                                                 strategy))
    if codec == "dxt1":
        return (dxt_cuda.dxt1_encode_plain, dxt_cuda.dxt1_decode_plain,
                lambda d, by, bx: dxt_cuda.dxtc_downsample_plain(d, by, bx, True))
    return (dxt_cuda.dxt5_encode_plain, dxt_cuda.dxt5_decode_plain,
            lambda d, by, bx: dxt_cuda.dxtc_downsample_plain(d, by, bx, False))


def plain_chain(image: CompressedImage, codec: str, block_size: int,
                strategy: int = etc.SMALLER_ERROR) -> list:
    """The mip chain by repeated Downsample on the plain twins, on cuda."""
    enc, dec, down = _plain_fns(codec, strategy)
    out, cur = [], image
    while max(cur.get_metadata().uncompressed_height,
              cur.get_metadata().uncompressed_width) > 1:
        nxt = CompressedImage()
        if not h4.downsample(enc, dec, down, cur, nxt, block_size,
                             torch.device("cuda")):
            break
        out.append(nxt)
        cur = nxt
    return out


def main_chains(payloads: dict, launches: Launches, gpu: str) -> None:
    """downsample_chain of the 4096^2 payloads, each level byte-equal to
    repeated Downsample on the plain twins on the card."""
    jobs = [("dxt1", DxtcCompressor(device="cuda"), payloads[("DXTC", Format.RGB)],
             8, ("dxt1_downsample", "dxt1_encode", "dxt1_decode")),
            ("dxt5", DxtcCompressor(device="cuda"), payloads[("DXTC", Format.RGBA)],
             16, ("dxt5_downsample", "dxt5_encode", "dxt5_decode")),
            ("etc1", EtcCompressor(device="cuda"), payloads[("ETC1", Format.RGB)],
             8, ("etc1_downsample", "etc1_encode", "etc1_decode"))]
    for codec, comp, ci, bs, kernels in jobs:
        chain, times = launches.run(
            f"{codec} downsample_chain x3", kernels,
            lambda: _timed(lambda: comp.downsample_chain(ci)))
        levels = SIZE.bit_length() - 1  # down to 1x1: 12 at 4096^2
        if len(chain) != levels:
            fail(f"{codec} chain has {len(chain)} levels, want {levels}")
        want = plain_chain(ci, codec, bs)
        if len(want) != len(chain):
            fail(f"{codec} chain: {len(chain)} levels, plain {len(want)}")
        for lvl, (got, ref) in enumerate(zip(chain, want), 1):
            if (got.get_metadata() != ref.get_metadata()
                    or not np.array_equal(got.get_data(), ref.get_data())):
                fail(f"{codec} chain level {lvl} differs from the plain path")
        print(f"[main] {codec} downsample_chain {SIZE}x{SIZE} -> 1x1 on {gpu}: "
              f"{levels} levels ({num_chain_levels(SIZE, SIZE)} fused), each "
              f"equal to plain; wall {_wall(times)}", flush=True)


def main_transcode(payloads: dict, launches: Launches, gpu: str) -> None:
    """transcode_dxt1_to_etc1 of the 4096^2 DXT1 payload on cuda."""
    src = payloads[("DXTC", Format.RGB)]

    def run():
        ci = CompressedImage()
        ci.duplicate(src)
        transcode_dxt1_to_etc1(ci, device="cuda")
        return ci

    ci, times = launches.run("transcode_dxt1_to_etc1 x3",
                             ("dxt1_decode", "etc1_encode"),
                             lambda: _timed(run))
    data = torch.from_numpy(src.get_data().reshape(-1, 8).copy()).cuda()
    n = data.shape[0]
    want = etc_cuda.etc1_encode_plain(dxt_cuda.dxt1_decode_plain(data, 4, 4 * n),
                                      4, 4 * n, etc.HEURISTIC)
    if not np.array_equal(ci.get_data(), want.cpu().numpy().reshape(-1)):
        fail("transcode differs from the plain path")
    if ci.get_metadata() != src.get_metadata():
        fail("transcode changed the metadata")
    print(f"[main] transcode_dxt1_to_etc1 {SIZE}x{SIZE} on {gpu}: equal to plain; "
          f"wall {_wall(times)}", flush=True)


def plain_pvrtc_encode(images: torch.Tensor) -> torch.Tensor:
    """The plain twins' PVRTC 2bpp encode of (B, H, W, 4) images, each
    falling back to its own pixel (0, 0): (B * NB, 8) records."""
    nby, nbx = images.shape[1] // 4, images.shape[2] // 8
    ab = pvrtc_cuda.pvrtc_morph_batched_plain(images)
    mod = pvrtc_cuda.pvrtc_upscale_modulate_plain(images, ab)
    return pvrtc_cuda.pvrtc_modes_pack_plain(mod, ab, nby, nbx)


def main_pvrtc(pv: dict, launches: Launches, gpu: str) -> np.ndarray:
    """PvrtcCompressor compress x3 and decompress_extension at 4096^2, the
    batched encode of the 192 x 512^2 fleet x3, and the 4bpp round trip at
    1024^2; returns the 4096^2 image."""
    runs = 3
    img = pv["tiles"].cpu().numpy()
    comp = PvrtcCompressor(device="cuda")

    def compress():
        ci = CompressedImage()
        _require(comp.compress(Format.RGBA, SIZE, SIZE, 0, img, ci), "compress")
        return ci

    ci, times = launches.run(
        f"PVRTC compress x{runs}",
        ("pvrtc_morph", "pvrtc_upscale_modulate", "pvrtc_modes_pack"),
        lambda: _timed(compress, runs))
    want = plain_pvrtc_encode(pv["tiles"][None])
    if not np.array_equal(ci.get_data(), want.cpu().numpy().reshape(-1)):
        fail("PVRTC payload differs from the plain path")
    buf, cpu_buf = bytearray(), bytearray()
    t0 = time.perf_counter()
    _require(comp.decompress_extension(ci, buf), "decompress_extension")
    t_dec = time.perf_counter() - t0
    _require(PvrtcCompressor(device="cpu").decompress_extension(ci, cpu_buf),
             "decompress_extension on the cpu")
    if buf != cpu_buf:
        fail("PVRTC decompress_extension on cuda differs from the cpu")
    decoded = np.frombuffer(bytes(buf), np.uint8).reshape(img.shape)
    err = np.abs(decoded.astype(np.int16) - img).mean()
    print(f"[main] PVRTC 2bpp {SIZE}x{SIZE} on {gpu}: payload equal to plain, "
          f"decompress_extension equal to the cpu; mean |decoded-input| "
          f"{err:.2f}; compress wall {_wall(times)}, decompress_extension "
          f"{t_dec * 1e3:.1f} ms, incl. host<->device copies", flush=True)

    fleet = pv["fleet"]
    n, side = FLEET
    out, times = launches.run(
        f"pvrtc_encode_batched x{runs} ({n} x {side}^2)",
        ("pvrtc_morph_batched", "pvrtc_upscale_modulate", "pvrtc_modes_pack"),
        lambda: _timed(lambda: pvrtc_cuda.pvrtc_encode_batched(fleet), runs))
    if not torch.equal(out.reshape(-1, 8), plain_pvrtc_encode(fleet)):
        fail("PVRTC batched encode differs from the plain path")
    for i in (0, n - 1):
        if not torch.equal(out[i], pvrtc_cuda.pvrtc_encode_image(fleet[i])):
            fail(f"PVRTC batched encode of image {i} differs from its "
                 "single-image encode")
    m = statistics.median(times)
    print(f"[main] pvrtc_encode_batched {n} x {side}x{side} on {gpu}: equal to "
          f"plain and to the single-image encode; device-resident wall "
          f"{m * 1e3:.2f} ms ({n * side * side / m / 1e6:.1f} Mpix/s; median "
          f"of {runs}, first {times[0] * 1e3:.2f} ms)", flush=True)

    side4 = SIZE // 4
    img4 = np.ascontiguousarray(img[::4, ::4])

    def round_trip4(device):
        comp4 = Pvrtc4bppCompressor(device=device)
        ci4, buf4 = CompressedImage(), bytearray()
        _require(comp4.compress(Format.RGBA, side4, side4, 0, img4, ci4),
                 "4bpp compress")
        _require(comp4.decompress(ci4, buf4), "4bpp decompress")
        return ci4, buf4

    (ci4, buf4), times = launches.run(
        "PVRTC 4bpp compress -> decompress (plain PyTorch)", (),
        lambda: _timed(lambda: round_trip4("cuda"), 1))
    cpu_ci4, cpu_buf4 = round_trip4("cpu")
    if not np.array_equal(ci4.get_data(), cpu_ci4.get_data()) or buf4 != cpu_buf4:
        fail("PVRTC 4bpp on cuda differs from the cpu")
    print(f"[main] PVRTC 4bpp {side4}x{side4} on {gpu}: payload and decoded "
          f"bytes equal to the cpu; compress + decompress wall "
          f"{times[0] * 1e3:.1f} ms", flush=True)
    return img


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain twin, so that a path runs
    plain PyTorch on the card: the reference the HQ paths are held to. The
    4bpp HQ encode gets an empty graph cache meanwhile, so that it runs its
    body on the twins and does not replay a graph captured with the
    kernels."""
    saved = [(pvrtc_hq, "_GRAPHS", pvrtc_hq._GRAPHS)]
    pvrtc_hq._GRAPHS = pvrtc_hq._GraphCache(pvrtc_hq._GRAPH_CAP)
    for _, _, plain, kernel in KERNELS.values():
        module = sys.modules[kernel.__module__]
        saved.append((module, kernel.__name__, getattr(module, kernel.__name__)))
        setattr(module, kernel.__name__, plain)
    try:
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def _psnr(decoded: torch.Tensor, image: torch.Tensor) -> float:
    """PSNR in dB of a decoded (H, W, 4) image over all four channels."""
    d = decoded.to(torch.float64) - image.to(torch.float64)
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def pvrtc_hq_arms(fmt_bits: int, image: np.ndarray, payload: np.ndarray) -> str:
    """Which arm of the HQ PVRTC best-of ``payload`` is, and the PSNR of
    each arm against ``image`` (on the card)."""
    img = torch.from_numpy(image).cuda()
    side = image.shape[0]
    if fmt_bits == 2:
        arms = {"HQ": pvrtc_hq._encode_hq(img),
                "reference": pvrtc_cuda.pvrtc_encode_image(img)}
        decode = pvrtc.decode_pvrtc_2bpp
    else:
        arms = {"HQ": pvrtc_hq._encode_hq4(img),
                "reference": pvrtc4.encode_pvrtc_4bpp(img)}
        decode = pvrtc4.decode_pvrtc_4bpp
    took = [k for k, v in arms.items()
            if np.array_equal(v.cpu().numpy().reshape(-1), payload)]
    if not took:
        fail(f"PVRTC {fmt_bits}bpp HQ payload is neither arm of its best-of")
    psnr = {k: _psnr(decode(v, side, side), img) for k, v in arms.items()}
    return (f"best-of took {' = '.join(took)}; PSNR HQ {psnr['HQ']:.3f} dB, "
            f"reference {psnr['reference']:.3f} dB (gain "
            f"{psnr['HQ'] - psnr['reference']:+.3f} dB)")


def main_hq(images: dict, launches: Launches, gpu: str) -> dict:
    """quality="high" at 1024^2 on cuda: DXTC compress of RGB, RGBA and BGR,
    ETC1 compress, the HQ transcode of the DXT1 payload, PVRTC 2bpp and
    4bpp compress and the DXT5 HQ mip chain, each byte-equal to the same
    path on the plain twins; the PVRTC payloads also to the same call on
    the CPU. Returns the PVRTC payloads by bits per pixel."""
    side = HQ_SIZE

    def compress(comp, fmt):
        def run():
            ci = CompressedImage()
            _require(comp.compress(fmt, side, side, 0, images[fmt], ci),
                     "compress")
            return ci
        return run

    def transcode(src):
        def run():
            ci = CompressedImage()
            ci.duplicate(src)
            transcode_dxt1_to_etc1(ci, "high", device="cuda")
            return ci
        return run

    dxt1_src = CompressedImage()
    _require(DxtcCompressor(device="cuda").compress(
        Format.RGB, side, side, 0, images[Format.RGB], dxt1_src), "compress")
    hq = DxtcCompressor("high", device="cuda")
    jobs = [
        ('DxtcCompressor("high") RGB compress', compress(hq, Format.RGB),
         ("dxt_hq_cluster_topk4", "dxt1_encode")),
        ('DxtcCompressor("high") RGBA compress', compress(hq, Format.RGBA),
         ("dxt_hq_cluster_topk4", "dxt5_encode")),
        ('DxtcCompressor("high") BGR compress', compress(hq, Format.BGR),
         ("dxt_hq_cluster_topk4", "dxt1_encode")),
        ('EtcCompressor(quality="high") compress',
         compress(EtcCompressor(quality="high", device="cuda"), Format.RGB),
         ("etc1_hq_fit_search",)),
        ('transcode_dxt1_to_etc1(quality="high")', transcode(dxt1_src),
         ("dxt1_decode", "etc1_hq_fit_search")),
        ('PvrtcCompressor("high") compress',
         compress(PvrtcCompressor("high", device="cuda"), Format.RGBA),
         ("pvrtc_morph", "pvrtc_upscale_modulate", "pvrtc_modes_pack",
          "pvrtc_hq_normal", "pvrtc_hq_dot", "pvrtc_hq_choose")),
        ('Pvrtc4bppCompressor("high") compress',
         compress(Pvrtc4bppCompressor("high", device="cuda"), Format.RGBA),
         ()),
    ]
    on_cpu = {'PvrtcCompressor("high") compress':
              (2, compress(PvrtcCompressor("high", device="cpu"), Format.RGBA)),
              'Pvrtc4bppCompressor("high") compress':
              (4, compress(Pvrtc4bppCompressor("high", device="cpu"),
                           Format.RGBA))}
    payloads = {}
    for what, run, kernels in jobs:
        ci, times = launches.run(what, kernels, lambda: _timed(run, 2))
        with plain_kernels():
            want, plain_times = _timed(run, 1)
        if (ci.get_metadata() != want.get_metadata()
                or not np.array_equal(ci.get_data(), want.get_data())):
            fail(f"{what} differs from the plain path on the card")
        payloads[what] = ci
        extra = ""
        if what in on_cpu:
            bits, cpu_run = on_cpu[what]
            t0 = time.perf_counter()
            cpu_ci = cpu_run()
            t_cpu = time.perf_counter() - t0
            if not np.array_equal(ci.get_data(), cpu_ci.get_data()):
                diff = (ci.get_data().reshape(-1, 8)
                        != cpu_ci.get_data().reshape(-1, 8)).any(-1).sum()
                fail(f"{what} on cuda differs from the cpu in {diff} blocks")
            extra = (f", equal to device=\"cpu\" ({t_cpu * 1e3:.1f} ms); "
                     + pvrtc_hq_arms(bits, images[Format.RGBA], ci.get_data()))
        print(f"[main] {what} {side}x{side} on {gpu}: equal to plain; wall "
              f"{statistics.median(times) * 1e3:.1f} ms (median of "
              f"{len(times)}, first {times[0] * 1e3:.1f}), plain twins "
              f"{plain_times[0] * 1e3:.1f} ms{extra}", flush=True)

    src = payloads['DxtcCompressor("high") RGBA compress']
    chain, times = launches.run(
        'DxtcCompressor("high") RGBA downsample_chain',
        ("dxt5_decode", "dxt_hq_cluster_topk4", "dxt5_encode"),
        lambda: _timed(lambda: hq.downsample_chain(src), 1))
    with plain_kernels():
        want = hq.downsample_chain(src)
    levels = side.bit_length() - 1
    if len(chain) != levels or len(want) != levels:
        fail(f"HQ chain: {len(chain)} levels, plain {len(want)}, want {levels}")
    for lvl, (got, ref) in enumerate(zip(chain, want), 1):
        if (got.get_metadata() != ref.get_metadata()
                or not np.array_equal(got.get_data(), ref.get_data())):
            fail(f"HQ chain level {lvl} differs from the plain path")
    print(f"[main] DxtcCompressor(\"high\") RGBA downsample_chain {side}x{side} "
          f"-> 1x1 on {gpu}: {levels} levels level by level, each equal to "
          f"plain; wall {times[0] * 1e3:.1f} ms", flush=True)
    return {2: payloads['PvrtcCompressor("high") compress'],
            4: payloads['Pvrtc4bppCompressor("high") compress']}


def photo_image(seed: int, side: int) -> np.ndarray:
    """A smooth (side, side, 4) image: colour gradients with sine structure
    and +-12 noise, alpha rising 40 -> 255 down the image (opaque in its
    last quarter)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    span = side - 1
    img = np.stack([xx * 255 // span, yy * 255 // span,
                    (xx + yy) * 255 // (2 * span),
                    np.minimum(255, 40 + yy * 287 // span)], axis=-1)
    img[..., 0] += (20 * np.sin(xx / 3.0)).astype(np.int64)
    img[..., 1] += (16 * np.cos(yy / 5.0)).astype(np.int64)
    img[..., :3] += rng.integers(-12, 13, (side, side, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def pvrtc_hq_photo(gpu: str) -> np.ndarray:
    """Both HQ PVRTC encoders on a smooth 1024^2 image (photo_image), on
    the card and on the CPU: bytes equal, and the arm and PSNR of each.
    Returns the CPU's 4bpp payload."""
    image = photo_image(5, HQ_SIZE)
    parts, on_cpu = [], {}
    for bits, encode in ((2, pvrtc_hq.encode_pvrtc_2bpp_hq),
                         (4, pvrtc_hq.encode_pvrtc_4bpp_hq)):
        got = encode(torch.from_numpy(image).cuda()).cpu().numpy().reshape(-1)
        want = encode(torch.from_numpy(image)).numpy().reshape(-1)
        on_cpu[bits] = want
        if not np.array_equal(got, want):
            fail(f"PVRTC {bits}bpp HQ of the smooth image: cuda differs from "
                 f"the cpu in {(got != want).reshape(-1, 8).any(-1).sum()} "
                 "blocks")
        parts.append(f"{bits}bpp {pvrtc_hq_arms(bits, image, got)}")
    print(f"[main] PVRTC HQ of a smooth {HQ_SIZE}x{HQ_SIZE} image on {gpu}: "
          f"2bpp and 4bpp payloads equal to the cpu's; " + "; ".join(parts),
          flush=True)
    return on_cpu[4]


def pvrtc_hq_replay(image: np.ndarray, payload: np.ndarray,
                    photo_payload: np.ndarray, gpu: str) -> None:
    """The 4bpp HQ encode's captured graph on new pixels: the smooth image,
    then ``image``, then the smooth image again, each replayed (no eager
    call, no capture) and held until all three are done, equal to its CPU
    payload (``payload`` and ``photo_payload``)."""
    photo = torch.from_numpy(photo_image(5, HQ_SIZE)).cuda()
    img = torch.from_numpy(image).cuda()
    before = dict(pvrtc_hq.GRAPH_STATS)
    held = [pvrtc_hq.encode_pvrtc_4bpp_hq(x) for x in (photo, img, photo)]
    stats = {k: v - before[k] for k, v in pvrtc_hq.GRAPH_STATS.items()}
    if stats != {"eager": 0, "captures": 0, "replays": 3}:
        fail(f"PVRTC 4bpp HQ at {HQ_SIZE}^2 did not replay its graph: {stats}")
    for got, want, what in zip(held, (photo_payload, payload, photo_payload),
                               ("smooth", "banded", "smooth again")):
        if not np.array_equal(got.cpu().numpy().reshape(-1), want):
            fail(f"PVRTC 4bpp HQ replay of the {what} image differs from the "
                 "cpu's payload")
    print(f"[main] encode_pvrtc_4bpp_hq {HQ_SIZE}x{HQ_SIZE} on {gpu}: three "
          f"replays of its CUDA graph (smooth, banded, smooth), held together, "
          f"each equal to the cpu's payload; GRAPH_STATS "
          f"{pvrtc_hq.GRAPH_STATS}", flush=True)


def pvrtc_hq_no_sync(image: np.ndarray, payloads: dict, gpu: str) -> None:
    """Both HQ PVRTC encoders on a device tensor under
    torch.cuda.set_sync_debug_mode("error"): an op that waits on the device
    (a host copy, ``.item()``, a data-dependent size) raises, and nothing
    here catches it. After a warm call (which caches the per-device
    tables), a path that passes can be captured by a CUDA graph: the 4bpp
    encode's op-by-op body is checked, and its entry point, which replays
    the graph that ``main_hq``'s calls captured."""
    img = torch.from_numpy(image).cuda()
    if pvrtc_hq._GRAPHS.entries.get(
            (image.shape[0], image.shape[1], img.device.index)) is None:
        fail(f"PVRTC 4bpp HQ at {image.shape[0]}^2: no captured graph after "
             f"main_hq's calls ({pvrtc_hq.GRAPH_STATS})")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # The control: a host-to-device copy must raise in this mode.
        try:
            torch.from_numpy(image[:1, :1]).to("cuda")
            caught = False
        except RuntimeError:
            caught = True
        if not caught:
            fail("set_sync_debug_mode(\"error\") let a host copy through")
        before = pvrtc_hq.GRAPH_STATS["replays"]
        out = {"2bpp": pvrtc_hq.encode_pvrtc_2bpp_hq(img),
               "4bpp op by op": pvrtc_hq._encode_pvrtc_4bpp_hq_eager(img),
               "4bpp replayed": pvrtc_hq.encode_pvrtc_4bpp_hq(img)}
        replayed = pvrtc_hq.GRAPH_STATS["replays"] - before
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if replayed != 1:
        fail(f"PVRTC 4bpp HQ under sync debug mode: {replayed} replays, not 1")
    for what, payload in out.items():
        want = payloads[2 if what == "2bpp" else 4].get_data()
        if not np.array_equal(payload.cpu().numpy().reshape(-1), want):
            fail(f"PVRTC {what} HQ under sync debug mode differs from "
                 "its compress()")
    print(f"[main] encode_pvrtc_2bpp_hq, the 4bpp HQ encode op by op and its "
          f"graph's replay {image.shape[0]}x{image.shape[1]} on {gpu} under "
          f'set_sync_debug_mode("error") (which raised on a host-to-device '
          f"copy): no synchronising op; payloads equal to compress()'s",
          flush=True)


def pvrtc_stage_split(img: np.ndarray, gpu: str, runs: int = 20) -> None:
    """Where a 4096^2 PvrtcCompressor.compress() spends its time: the steps
    it takes, on the host clock, synchronised after each device step; for
    each kernel step also the host time until its wrapper returns and the
    device time between CUDA events recorded around the call."""
    nby, nbx = SIZE // 4, SIZE // 8
    names = ("host->device copy of the image", "morph kernel",
             "upscale + modulate kernel", "mode + pack kernel",
             "device->host copy of the payload", "host store of the payload")
    times = {k: [] for k in names}
    returned = {k: [] for k in names[1:4]}
    device = {k: [] for k in names[1:4]}
    for _ in range(runs):
        t = [time.perf_counter()]
        events = []

        def step():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        def kernel(name, launch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = launch()
            end.record()
            returned[name].append(time.perf_counter() - t0)
            events.append((name, start, end))
            step()
            return out

        dev = h4._to_device(img, torch.device("cuda"))
        step()
        ab = kernel(names[1], lambda: pvrtc_cuda.pvrtc_morph_cuda(dev, dev[0, 0]))
        mod = kernel(names[2], lambda: pvrtc_cuda.pvrtc_upscale_modulate_cuda(
            dev[None], ab))
        rec = kernel(names[3], lambda: pvrtc_cuda.pvrtc_modes_pack_cuda(
            mod, ab, nby, nbx))
        host = rec.cpu().numpy()
        step()
        payload = np.empty(SIZE * SIZE // 4, np.uint8)
        payload[:] = host.reshape(-1)
        step()
        for k, a, b in zip(names, t, t[1:]):
            times[k].append(b - a)
        for k, start, end in events:
            device[k].append(start.elapsed_time(end) / 1e3)
    ms = lambda v: f"{statistics.median(v) * 1e3:.3f}"
    print(f"[main] PVRTC compress() {SIZE}x{SIZE} stages on {gpu} (host clock, "
          f"ms, median of {runs}): " + "; ".join(
              f"{k} {ms(v)}" for k, v in times.items())
          + "; of each kernel step, its wrapper's return on the host clock / "
          "its device time between CUDA events: " + "; ".join(
              f"{k} {ms(returned[k])} / {ms(device[k])}" for k in device),
          flush=True)


#: The designs of csrc/pvrtc.cu's mode + pack (PackDesign), as
#: texcomp_pvrtc_modes_pack_design numbers them.
PACK_DESIGNS = {0: "slot threads, shuffled neighbours",
                1: "slot threads, loaded neighbours",
                2: "row-major threads, loaded neighbours"}


def _profiled_ms(fn, kernel: str, runs: int) -> str:
    """The median device time torch.profiler reads for the kernels whose
    name holds ``kernel`` over ``runs`` calls of ``fn``, each after an L2
    flush as in cuda_time_ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    return f"{statistics.median(times):.4f} ms" if times else "not measured"


def pvrtc_pack_probe(gpu: str, library=None, runs: int = 20) -> None:
    """Times mode + pack as the library at ``library`` (by default this
    tree's build) has it, on the modulation and colors of the 4096^2 random
    image and of the 192 x 512^2 fleet (made by the plain twins): each of
    :data:`PACK_DESIGNS` where the library has texcomp_pvrtc_modes_pack_design
    (this tree's entry point launches design 1), else its
    texcomp_pvrtc_modes_pack. Prints for each the CUDA-event median (L2
    flushed, as phase 3 times), the device time torch.profiler reads, and
    the kernel's registers, CTAs and SASS count; every output must equal
    the twin's. To time a parent commit's kernel in the same process, build
    its library in its checkout (``texcomp_torch.ops._build.load()``) and
    pass that library's path."""
    path = str(library or _build.library_path())
    lib = ctypes.CDLL(path) if library else _build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "texcomp_pvrtc_modes_pack_design"):
        lib.texcomp_pvrtc_modes_pack_design.argtypes = [i, p, p, i, i, i, p, p]
        calls = [(f"design {d} ({what})", functools.partial(
            lib.texcomp_pvrtc_modes_pack_design, d), f"modes_pack_kernelILi{d}E")
            for d, what in PACK_DESIGNS.items()]
    else:
        lib.texcomp_pvrtc_modes_pack.argtypes = [p, p, i, i, i, p, p]
        calls = [("entry point", lib.texcomp_pvrtc_modes_pack,
                  "modes_pack_kernel")]
    pv = pvrtc_images(torch.from_numpy(make_image(2, SIZE, SIZE, 4)).cuda())
    stream = torch.cuda.current_stream().cuda_stream
    for label, images in ((f"{SIZE}x{SIZE} random", pv["random"][None]),
                          (f"fleet {FLEET[0]}x{FLEET[1]}", pv["fleet"])):
        ab = pvrtc_cuda.pvrtc_morph_batched_plain(images)
        mod = pvrtc_cuda.pvrtc_upscale_modulate_plain(images, ab)
        nby, nbx = images.shape[1] // 4, images.shape[2] // 8
        want = pvrtc_cuda.pvrtc_modes_pack_plain(mod, ab, nby, nbx)
        parts = []
        for what, fn, kernel in calls:
            out = torch.empty_like(want)

            def call():
                rc = fn(mod.data_ptr(), ab.data_ptr(), images.shape[0], nby,
                        nbx, out.data_ptr(), stream)
                if rc != 0:
                    fail(f"mode + pack probe, {what}: launch error {rc}")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                fail(f"mode + pack probe, {what} [{label}] differs from the twin")
            parts.append(f"{what} {cuda_time_ms(call, repeats=runs):.4f} ms "
                         f"(profiler {_profiled_ms(call, 'modes_pack', runs)})")
        # A yardstick: one copy_ that reads and writes as many bytes as the
        # call moves.
        src = torch.empty(_nbytes(mod, ab, want) // 2, dtype=torch.uint8,
                          device="cuda")
        dst = torch.empty_like(src)
        parts.append(f"copy_ of {src.numel() / 2**20:.1f} MiB "
                     f"{cuda_time_ms(lambda: dst.copy_(src), repeats=runs):.4f} "
                     f"ms (profiler "
                     f"{_profiled_ms(lambda: dst.copy_(src), 'Memcpy', runs)})")
        print(f"[probe] mode + pack [{label}] of {path} on {gpu}, equal to "
              f"the twin; CUDA-event median of {runs}: {'; '.join(parts)}",
              flush=True)
    for what, _, kernel in calls:
        print(f"[probe] {what}: {library_occupancy(kernel, path)}; SASS "
              f"{sass_opcodes(kernel, path)}", flush=True)


def hq_device_split(images: dict, gpu: str) -> None:
    """Where one 1024^2 HQ compress spends its time, under torch.profiler:
    its wall against the device time of the kernels it ran (the port's own
    kernels apart) and of its copies, the number of kernels, and the
    device's idle share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    side = HQ_SIZE
    jobs = (("DXT1", DxtcCompressor("high", device="cuda"), Format.RGB,
             ("cluster_topk4",)),
            ("ETC1", EtcCompressor(quality="high", device="cuda"), Format.RGB,
             ("hq_search_kernel",)),
            ("PVRTC 2bpp", PvrtcCompressor("high", device="cuda"), Format.RGBA,
             ("morph_kernel", "upscale_modulate_kernel", "modes_pack_kernel")))
    for what, comp, fmt, names in jobs:
        def run():
            ci = CompressedImage()
            _require(comp.compress(fmt, side, side, 0, images[fmt], ci),
                     "compress")

        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        on_device = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        is_copy = [e.name.startswith(("Memcpy", "Memset")) for e in on_device]
        copies = [e for e, c in zip(on_device, is_copy) if c]
        kernels = [e for e, c in zip(on_device, is_copy) if not c]
        ms = lambda evs: sum(e.time_range.elapsed_us() for e in evs) / 1e3
        hq = [e for e in kernels if any(n in e.name for n in names)]
        busy = ms(kernels) + ms(copies)
        print(f"[main] {what} quality=\"high\" compress {side}x{side} on {gpu} "
              f"under torch.profiler: wall {wall:.1f} ms; {len(kernels)} "
              f"kernels {ms(kernels):.3f} ms, of them {len(hq)} "
              f"{' / '.join(names)} {ms(hq):.3f} ms; copies "
              f"{ms(copies):.3f} ms; device idle "
              f"{100 * (1 - busy / wall):.1f}% of the wall" if on_device else
              f"[main] {what} HQ compress: torch.profiler saw no device "
              "events; device time not measured", flush=True)


# ---------------------------------------------------------------------------
# Phase 6: the asset pipeline.
# ---------------------------------------------------------------------------

#: bench.py's _FLEET_DIST, (side, assets per codec), and _FLEET_CODECS:
#: BASELINE config 5, 9,984 assets and 1.31 Gpix.
PIPELINE_DIST = ((64, 1024), (128, 768), (256, 384), (512, 192), (1024, 96),
                 (2048, 32))
PIPELINE_CODECS = (("dxt1", 3), ("etc1", 3), ("dxt5", 4), ("pvrtc", 4))
#: bench.py's pipeline batch (bench_pipeline_fleet_e2e).
PIPELINE_BATCH = 32
#: The kernels one reference-quality batch of a codec launches, once each.
BATCH_KERNELS = {"dxt1": ("dxt1_encode",), "etc1": ("etc1_encode",),
                 "dxt5": ("dxt5_encode",),
                 "pvrtc": ("pvrtc_morph_batched", "pvrtc_upscale_modulate",
                           "pvrtc_modes_pack")}


def pipeline_fleet(dist=None, hq: bool = False, seed: int = 0):
    """(assets, pixels, batches) of a config-5 fleet as bench.py builds it:
    per size class a pool of 4 images per codec (the first make_image's
    bands, the others uniform noise) and ``count`` assets of each codec
    drawing from it in turn. With ``hq``, the first count // 10 (at least
    one) of each (codec, size) are quality="high" (bench.py's
    bench_pipeline_fleet_hq). ``batches``: codec -> reference batches."""
    rng = np.random.default_rng(seed)
    dist = PIPELINE_DIST if dist is None else dist
    assets, pixels = [], 0
    batches = collections.Counter()
    for size, count in dist:
        n_hq = max(1, count // 10) if hq else 0
        for codec, ch in PIPELINE_CODECS:
            pool = [make_image(seed + size + ch, size, size, ch)]
            pool += [rng.integers(0, 256, (size, size, ch), dtype=np.uint8)
                     for _ in range(3)]
            for i in range(count):
                assets.append(TextureAsset(
                    f"{codec}_{size}_{i}", pool[i % 4], codec,
                    quality="high" if i < n_hq else "reference"))
            pixels += count * size * size
            batches[codec] += -(-(count - n_hq) // PIPELINE_BATCH)
    return assets, pixels, batches


def _fleet_run(pipe: AssetPipeline, assets, mipmaps: bool = False):
    """pipe.run() and its wall time in s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.run(assets, mipmaps=mipmaps)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_results(got: dict, want: dict, what: str) -> None:
    """Fail unless both runs hold the same entries, payloads and metadata."""
    if set(got) != set(want):
        fail(f"{what}: entries differ ({len(got)} against {len(want)})")
    bad = [k for k in got
           if got[k].get_metadata() != want[k].get_metadata()
           or not np.array_equal(got[k].get_data(), want[k].get_data())]
    if bad:
        fail(f"{what}: {len(bad)} of {len(got)} entries differ, e.g. {bad[:5]}")


def _plain_run(assets, mipmaps: bool = False) -> dict:
    with plain_kernels():
        return _fleet_run(AssetPipeline(batch_size=PIPELINE_BATCH), assets,
                          mipmaps)[0]


def pipeline_api_check(assets, got: dict) -> None:
    """The first asset of each (codec, size) against the per-asset API's
    compress on the card."""
    comps = {"dxt1": DxtcCompressor(device="cuda"),
             "dxt5": DxtcCompressor(device="cuda"),
             "etc1": EtcCompressor(device="cuda"),
             "pvrtc": PvrtcCompressor(device="cuda")}
    fmts = {"dxt1": Format.RGB, "etc1": Format.RGB, "dxt5": Format.RGBA,
            "pvrtc": Format.RGBA}
    seen = set()
    for a in assets:
        key = (a.codec, a.image.shape)
        if key in seen:
            continue
        seen.add(key)
        ci = CompressedImage()
        h, w = a.image.shape[:2]
        _require(comps[a.codec].compress(fmts[a.codec], h, w, 0, a.image, ci),
                 f"{a.name} compress")
        if (ci.get_metadata() != got[a.name].get_metadata()
                or not np.array_equal(ci.get_data(), got[a.name].get_data())):
            fail(f"pipeline {a.name} differs from the per-asset compress")
    print(f"[pipeline] {len(seen)} assets, one per (codec, size), equal to "
          "the per-asset compress on the card", flush=True)


def pipeline_fleet_runs(launches: Launches, gpu: str) -> None:
    """The config-5 fleet: warm, timed, by stage, against the plain path,
    against the API, and with mip chains."""
    assets, pixels, batches = pipeline_fleet()
    pipe = AssetPipeline(batch_size=PIPELINE_BATCH)
    _, warm = _fleet_run(pipe, assets)
    expected = {k: batches[c] for c, ks in BATCH_KERNELS.items() for k in ks}
    (got, wall) = launches.run(
        f"pipeline fleet ({len(assets)} assets)", tuple(expected),
        lambda: _fleet_run(pipe, assets))
    counts = dict(_launch.LAUNCHES)
    if {k: n for k, n in counts.items() if n} != expected:
        fail(f"fleet launches {counts}, expected one a batch: {expected}")
    print(f"[pipeline] fleet of {len(assets)} assets, {pixels / 1e9:.3f} Gpix, "
          f"batches of {PIPELINE_BATCH} on {gpu}: wall {wall:.3f} s "
          f"({pixels / wall / 1e6:.1f} Mpix/s; warm-up run {warm:.3f} s); "
          f"one launch of each kernel a batch: {expected}", flush=True)

    pipe.stage_times = StageTimes()
    _, staged = _fleet_run(pipe, assets)
    host = pipe.stage_times.host_s
    pipe.stage_times = None
    print(f"[pipeline] host stages of one fleet run (wall {staged:.3f} s): "
          f"host stacking {host['stack']:.3f} s, container packing "
          f"{host['pack']:.3f} s", flush=True)

    t0 = time.perf_counter()
    _same_results(got, _plain_run(assets), "pipeline fleet")
    print(f"[pipeline] all {len(got)} payloads and metadata equal to the "
          f"plain path on the card ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    pipeline_api_check(assets, got)
    del got

    mips, mip_wall = launches.run(
        "pipeline fleet, mipmaps=True",
        ("dxt1_downsample", "dxt5_downsample", "etc1_downsample"),
        lambda: _fleet_run(pipe, assets, mipmaps=True))
    _same_results(mips, _plain_run(assets, mipmaps=True),
                  "pipeline fleet with mip chains")
    print(f"[pipeline] run(mipmaps=True): {len(mips)} entries in "
          f"{mip_wall:.3f} s, equal to the plain path", flush=True)


def pipeline_mixed_quality(launches: Launches, gpu: str) -> None:
    """Sides 64-256 of the fleet with 10% quality="high", against the
    plain path."""
    assets, pixels, _ = pipeline_fleet(PIPELINE_DIST[:3], hq=True, seed=1)
    n_hq = sum(a.quality == "high" for a in assets)
    pipe = AssetPipeline(batch_size=PIPELINE_BATCH)
    got, wall = launches.run(
        f"pipeline mixed quality ({n_hq} of {len(assets)} high)",
        ("dxt_hq_cluster_topk4", "etc1_hq_fit_search", "pvrtc_morph",
         "pvrtc_morph_batched"),
        lambda: _fleet_run(pipe, assets))
    _same_results(got, _plain_run(assets), "pipeline mixed quality")
    print(f"[pipeline] mixed quality on {gpu}: {len(assets)} assets "
          f"({n_hq} high), {pixels / 1e6:.1f} Mpix, wall {wall:.3f} s "
          f"({pixels / wall / 1e6:.1f} Mpix/s), equal to the plain path",
          flush=True)


def pipeline_meshes() -> None:
    """A mesh of four cuda:0 entries against the one-device mesh."""
    cuda0 = torch.device("cuda", 0)
    one = make_mesh(1, devices=[cuda0])
    four = make_mesh(4, data=4, devices=[cuda0] * 4)
    rng = np.random.default_rng(5)
    for codec, ch in PIPELINE_CODECS:
        images = rng.integers(0, 256, (10, 256, 256, ch), dtype=np.uint8)
        a = AssetPipeline(one).encode_group(images, codec)
        b = AssetPipeline(four).encode_group(images, codec)
        if not np.array_equal(a, b):
            fail(f"encode_group {codec} on four cuda:0 entries differs")
    for codec, ch in (("dxt1", 3), ("dxt5", 4), ("etc1", 3)):
        img = torch.from_numpy(make_image(6, SIZE, SIZE, ch)).cuda()
        a = encode_atlas_sharded(img, one, codec)
        b = encode_atlas_sharded(img, four, codec)
        if not torch.equal(a, b):
            fail(f"encode_atlas_sharded {codec} on four cuda:0 entries differs")
    print("[pipeline] mesh of four cuda:0 entries: encode_group (4 codecs, "
          f"10 x 256x256) and encode_atlas_sharded (dxt1, dxt5, etc1 at "
          f"{SIZE}x{SIZE}) equal to one device", flush=True)


def pipeline_processes() -> None:
    """Two gloo processes on cuda:0 against one process; quality_report on
    the card against the CPU."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [f"{tmp}/pod_{p}.npz" for p in range(2)]
        shards = launch_two_process_demo(outs, str(ROOT), timeout=300.0,
                                         fleet="pod", mipmaps=True,
                                         device="cuda")
    psnrs = [float(s.pop("__psnr_dxt1__")) for s in shards]
    if set(shards[0]) & set(shards[1]):
        fail("the two processes' partitions overlap")
    single = AssetPipeline(batch_size=64).run(pod_fleet(), mipmaps=True)
    merged = {**shards[0], **shards[1]}
    if set(merged) != set(single) or any(
            not np.array_equal(v, single[k].get_data())
            for k, v in merged.items()):
        fail("the two processes' union differs from one process")
    ref = quality_report(AssetPipeline(), quality_batch(), "dxt1")
    if psnrs != [ref, ref]:
        fail(f"fleet PSNR {psnrs} against one process's {ref}")
    print(f"[pipeline] two gloo processes on cuda:0: {len(merged)} entries, "
          f"union equal to one process, both PSNR {ref:.6f} dB "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    rng = np.random.default_rng(9)
    for codec in ("dxt1", "dxt5", "etc1", "pvrtc", "pvrtc4"):
        ch = 3 if codec in ("dxt1", "etc1") else 4
        images = rng.integers(0, 256, (24, 64, 64, ch), dtype=np.uint8)
        on_card = quality_report(AssetPipeline(), images, codec)
        on_cpu = quality_report(AssetPipeline(device="cpu"), images, codec)
        if on_card != on_cpu:
            fail(f"quality_report {codec}: {on_card} on the card, {on_cpu} "
                 "on the cpu")
    print("[pipeline] quality_report of 5 codecs on the card equal to the "
          "cpu", flush=True)


def phase_pipeline(gpu: str) -> dict:
    """Phase 6; returns its launch counts, summed."""
    t0 = time.perf_counter()
    launches = Launches()
    pipeline_fleet_runs(launches, gpu)
    pipeline_mixed_quality(launches, gpu)
    pipeline_meshes()
    pipeline_processes()
    print(f"[pipeline] launches: {launches.total}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches.total


# ---------------------------------------------------------------------------
# Phase 7: the PVRTC atlases.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def exchange_times():
    """Times each halo exchange of the atlases (``dist.mesh._exchange``)
    between two CUDA events on the current stream: yields a list that
    collects (start, end) event pairs in call order."""
    pairs, exchange = [], tmesh._exchange

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = exchange(*args)
        end.record()
        pairs.append((start, end))
        return out

    tmesh._exchange = timed
    try:
        yield pairs
    finally:
        tmesh._exchange = exchange


def _atlas_walls(name: str, atlas_fn, single_fn, exchanges: tuple,
                 runs: int = 5) -> str:
    """The atlas's and the single-device encode's walls (host clock, median
    of ``runs``) and each exchange's CUDA-event median."""
    with exchange_times() as pairs:
        _, atlas_t = _timed(atlas_fn, runs)
    torch.cuda.synchronize()
    ms = [statistics.median(a.elapsed_time(b) for a, b in
                            pairs[i::len(exchanges)])
          for i in range(len(exchanges))]
    _, single_t = _timed(single_fn, runs)
    return (f"{name}: atlas {statistics.median(atlas_t) * 1e3:.3f} ms, "
            f"single device {statistics.median(single_t) * 1e3:.3f} ms (host "
            f"clock, median of {runs}); exchanges (CUDA events, median): "
            + ", ".join(f"{e} {t:.4f} ms" for e, t in zip(exchanges, ms)))


def phase_atlas(atlas: torch.Tensor, pv: dict, gpu: str) -> dict:
    """The 8192^2 PVRTC 2bpp atlas on a mesh of four cuda:0 entries and on
    a (data 4, block 2) mesh, byte-equal to pvrtc_encode_image on the card;
    the 4096^2 4bpp atlas, byte-equal to encode_pvrtc_4bpp on the card;
    their walls against the single device's and the halo exchanges' times.
    Returns the launch counts, summed."""
    t0 = time.perf_counter()
    launches = Launches()
    cuda0 = torch.device("cuda", 0)
    meshes = {"four cuda:0 entries": make_mesh(ATLAS_DATA, devices=[cuda0] * 4),
              "a (data 4, block 2) mesh": make_mesh(
                  2 * ATLAS_DATA, data=ATLAS_DATA, block=2,
                  devices=[cuda0] * 8)}
    single = pvrtc_cuda.pvrtc_encode_image(atlas)
    path = ("pvrtc_morph",) + ATLAS_KERNELS
    for label, mesh in meshes.items():
        got = launches.run(
            f"PVRTC 2bpp atlas {ATLAS_SIZE}^2 on {label}", path,
            lambda: pvrtc_encode_atlas_sharded(atlas, mesh))
        counts = {k: n for k, n in _launch.LAUNCHES.items() if n}
        if counts != {k: ATLAS_DATA for k in path}:
            fail(f"the atlas launched {counts}, expected each kernel once a "
                 f"strip ({ATLAS_DATA})")
        if not torch.equal(got, single):
            fail(f"the 2bpp atlas on {label} differs from pvrtc_encode_image")
    print(f"[atlas] 2bpp {ATLAS_SIZE}^2 ({atlas.shape[0] * atlas.shape[1] // 32:,}"
          f" blocks) on both meshes equal to pvrtc_encode_image on {gpu}",
          flush=True)
    print("[atlas] " + _atlas_walls(
        f"2bpp {ATLAS_SIZE}^2 over {ATLAS_DATA} strips",
        lambda: pvrtc_encode_atlas_sharded(atlas, meshes["four cuda:0 entries"]),
        lambda: pvrtc_cuda.pvrtc_encode_image(atlas),
        ("A+B last rows", "A+B first rows", "first modulation rows")),
        flush=True)

    atlas4 = pv["tiles"].clone()
    atlas4[:4] = 0
    got = launches.run(
        f"PVRTC 4bpp atlas {ATLAS4_SIZE}^2 on four cuda:0 entries", (),
        lambda: pvrtc4_encode_atlas_sharded(atlas4,
                                            meshes["four cuda:0 entries"]))
    if not torch.equal(got, pvrtc4.encode_pvrtc_4bpp(atlas4)):
        fail("the 4bpp atlas differs from encode_pvrtc_4bpp")
    print(f"[atlas] 4bpp {ATLAS4_SIZE}^2 equal to encode_pvrtc_4bpp on {gpu}",
          flush=True)
    print("[atlas] " + _atlas_walls(
        f"4bpp {ATLAS4_SIZE}^2 over {ATLAS_DATA} strips",
        lambda: pvrtc4_encode_atlas_sharded(atlas4,
                                            meshes["four cuda:0 entries"]),
        lambda: pvrtc4.encode_pvrtc_4bpp(atlas4),
        ("A+B last rows", "A+B first rows")), flush=True)
    print(f"[atlas] launches: {launches.total}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches.total


# ---------------------------------------------------------------------------
# Phase 8: the CLI.
# ---------------------------------------------------------------------------

CLI_SIZE = 1024


def _cli(*argv: str) -> str:
    """``python -m texcomp_torch`` with ``argv`` from the repository root;
    its standard output, or a failure with its error output."""
    proc = subprocess.run([sys.executable, "-m", "texcomp_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        fail(f"python -m texcomp_torch {' '.join(argv)} exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout.strip()


def _same_entry(got: CompressedImage, want: CompressedImage, what: str):
    if (got.get_metadata() != want.get_metadata()
            or not np.array_equal(got.get_data(), want.get_data())):
        fail(f"CLI {what}: the archive's entry differs from the API's")


def phase_cli(gpu: str) -> None:
    """A round trip through ``python -m texcomp_torch`` on the card in a
    temporary directory: encode (DXT1), info, decode, mipmap and
    transcode-dxt1-etc1 of a 1024^2 image, each archive entry equal to the
    API's result on the card."""
    t0 = time.perf_counter()
    img = make_image(12, CLI_SIZE, CLI_SIZE, 3)
    comp = DxtcCompressor(device="cuda")
    want = CompressedImage()
    _require(comp.compress(Format.RGB, CLI_SIZE, CLI_SIZE, 0, img, want),
             "compress")
    with tempfile.TemporaryDirectory() as tmp:
        src, archive = f"{tmp}/img.npy", f"{tmp}/a.txc"
        np.save(src, img)
        lines = [_cli("encode", "--codec", "dxt1", "--input", src,
                      "--archive", archive)]
        _same_entry(load_archive(archive)["img"], want, "encode")
        lines.append(_cli("info", "--archive", archive))
        lines.append(_cli("decode", "--archive", archive, "--name", "img",
                          "--output", f"{tmp}/dec.npy"))
        buf = bytearray()
        _require(comp.decompress(want, buf), "decompress")
        if not np.array_equal(np.load(f"{tmp}/dec.npy").reshape(-1),
                              np.frombuffer(bytes(buf), np.uint8)):
            fail("CLI decode differs from the API's decompress")
        lines.append(_cli("mipmap", "--archive", archive, "--name", "img"))
        chain = comp.downsample_chain(want)
        entries = load_archive(archive)
        for i, mip in enumerate(chain, start=1):
            _same_entry(entries[f"img_mip{i}"], mip, f"mipmap level {i}")
        lines.append(_cli("transcode-dxt1-etc1", "--archive", archive,
                          "--name", "img"))
        transcode_dxt1_to_etc1(want, device="cuda")
        want.get_metadata().compressor_name = "etc"  # as the CLI renames it
        _same_entry(load_archive(archive)["img"], want, "transcode")
    said = " | ".join(line.splitlines()[0] for line in lines)
    print(f"[cli] python -m texcomp_torch encode, info, decode, mipmap "
          f"({len(chain)} levels) and transcode-dxt1-etc1 of a "
          f"{CLI_SIZE}^2 image on {gpu}: every entry equal to the API's "
          f"({time.perf_counter() - t0:.1f} s): {said}", flush=True)


def phase_main_path(images: dict, pv: dict, hq_images: dict, gpu: str) -> dict:
    """The main paths at 4096^2, and quality="high" at 1024^2; returns the
    launch counts, summed."""
    launches = Launches()
    payloads = main_round_trips(images, launches, gpu)
    main_chains(payloads, launches, gpu)
    main_transcode(payloads, launches, gpu)
    pvrtc_img = main_pvrtc(pv, launches, gpu)
    pvrtc_hq_payloads = main_hq(hq_images, launches, gpu)
    # The atlas variants run in phase 7; the HQ search over given candidates
    # in phase 3 only, since the card's HQ encode fits its own.
    missing = [k for k, n in launches.total.items()
               if n == 0 and k not in ATLAS_KERNELS + ("etc1_hq_search",)]
    if missing:
        fail(f"main path did not launch {missing}: {launches.total}")
    print(f"[main] launches during the main path: {launches.total}", flush=True)
    pvrtc_hq_no_sync(hq_images[Format.RGBA], pvrtc_hq_payloads, gpu)
    photo_payload = pvrtc_hq_photo(gpu)
    pvrtc_hq_replay(hq_images[Format.RGBA],
                    pvrtc_hq_payloads[4].get_data(), photo_payload, gpu)
    pvrtc_stage_split(pvrtc_img, gpu)
    hq_device_split(hq_images, gpu)
    return launches.total


def main() -> int:
    gpu = phase_device()
    phase_build()
    gv = _load_golden_vectors()
    rgb_np = make_image(1, SIZE, SIZE, 3)
    rgba_np = make_image(2, SIZE, SIZE, 4)
    rgba = torch.from_numpy(rgba_np).cuda()
    pv = pvrtc_images(rgba)
    hq_images = {Format.RGB: make_image(3, HQ_SIZE, HQ_SIZE, 3),
                 Format.RGBA: make_image(4, HQ_SIZE, HQ_SIZE, 4)}
    hq_images[Format.BGR] = np.ascontiguousarray(hq_images[Format.RGB][..., ::-1])
    atlas = atlas_image(pv)
    kernels = phase_kernels(torch.from_numpy(rgb_np).cuda(), rgba, pv,
                            torch.from_numpy(hq_images[Format.RGB]).cuda(),
                            atlas)
    phase_golden(gv)
    launches = phase_main_path({Format.RGB: rgb_np, Format.RGBA: rgba_np}, pv,
                               hq_images, gpu)
    for name, n in phase_pipeline(gpu).items():
        launches[name] += n
    for name, n in phase_atlas(atlas, pv, gpu).items():
        launches[name] += n
    phase_cli(gpu)

    report = [{"name": name, "route": "cuda", "source": r["source"],
               "replaces": r["replaces"], "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None}
              for name, r in kernels.items()]
    print(json.dumps({"kernels": report}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
