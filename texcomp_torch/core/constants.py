"""Codec constant tables.

The DXTC constant-color endpoint table is regenerated at import time from
the generator algorithm documented in the reference
(image_compression/internal/dxtc_const_color_table.cc:22-58): for each
8-bit value and each (channel bit depth, interpolation weight) pair, an
exhaustive search finds the endpoint pair whose interpolated value best
matches value/255. Ties break toward the lexicographically-first (i, j),
matching the strict `err < minErr` update rule.

The ETC1 codebook and heuristic thresholds are the reference's tables.
"""

from __future__ import annotations

import numpy as np


def _find_endpoints(channel_bits: int, t: float) -> np.ndarray:
    """All-values version of findEndpoints (dxtc_const_color_table.cc:33-44).

    Returns an array of shape (256, 2): the best (i, j) endpoint pair per
    8-bit input value, minimizing |v/255 - ((1-t)*i + t*j)/(max-1)| with
    first-in-scan-order tie-breaking (i major, j minor).
    """
    max_value = 1 << channel_bits
    i = np.arange(max_value, dtype=np.float64)[:, None]
    j = np.arange(max_value, dtype=np.float64)[None, :]
    interp = ((1.0 - t) * i + t * j) / (max_value - 1.0)  # (max, max)
    v = np.arange(256, dtype=np.float64) / 255.0  # (256,)
    err = np.abs(v[:, None, None] - interp[None, :, :])  # (256, max, max)
    best = err.reshape(256, -1).argmin(axis=1)  # first occurrence == scan order
    return np.stack([best // max_value, best % max_value], axis=1).astype(np.uint8)


def _build_dxtc_const_color_table() -> np.ndarray:
    """256x8 uint8 table, column layout per dxtc_const_color_table.cc:23-26:
    [r/b 1/3 pair, r/b 1/2 pair, g 1/3 pair, g 1/2 pair]."""
    rb_thirds = _find_endpoints(5, 1.0 / 3.0)
    rb_halves = _find_endpoints(5, 1.0 / 2.0)
    g_thirds = _find_endpoints(6, 1.0 / 3.0)
    g_halves = _find_endpoints(6, 1.0 / 2.0)
    return np.concatenate([rb_thirds, rb_halves, g_thirds, g_halves], axis=1)


#: 256x8 uint8: optimal 5/6-bit endpoint pairs for constant-color DXT blocks.
DXTC_CONST_COLOR_TABLE: np.ndarray = _build_dxtc_const_color_table()

#: ETC1 modifier codebook, 8 codewords x 4 pixel indices, from the
#: OES_compressed_ETC1_RGB8_texture spec (etc_compressor.cc:101-110). Each
#: row is [a, b, -a, -b].
ETC1_CODEBOOK: np.ndarray = np.array(
    [
        [2, 8, -2, -8],
        [5, 17, -5, -17],
        [9, 29, -9, -29],
        [13, 42, -13, -42],
        [18, 60, -18, -60],
        [24, 80, -24, -80],
        [33, 106, -33, -106],
        [47, 183, -47, -183],
    ],
    dtype=np.int32,
)

#: Thresholds mapping the max absolute deviation to a codeword for the ETC
#: heuristic strategy (etc_compressor.cc:435-451): the codeword is the
#: number of thresholds the deviation exceeds.
ETC1_HEURISTIC_THRESHOLDS: np.ndarray = np.array(
    [12, 23, 35, 51, 70, 93, 144], dtype=np.int32
)
