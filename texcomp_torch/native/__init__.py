"""Host-side block-grid byte movement: a C++ library and its numpy twins.

The byte shuffles of the compressed-domain operations: assembling a padded
block grid, copying a block sub-rectangle, replicating a solid block,
copying rows between strided buffers, the PVRTC Z-order permutation and
reordering whole records by a permutation.

Each public function calls ``texcomp_host.cc`` (this package's own copy of
texcomp's host runtime), which ``g++`` builds at first use into
``texcomp_torch/_build/`` under a name that carries a hash of the source
and the flags; the build is written to a temporary file and renamed into
place, so processes that build at once never load a half-written library.
A failed build raises with the compiler's message: nothing falls back.
The numpy functions of the same names with ``_plain`` appended compute
the same bytes; the tests hold the library to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "texcomp_host.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_P = ctypes.c_void_p
_U = ctypes.c_uint32
#: argtypes of each C entry point; each returns nothing.
SIGNATURES = {
    "th_pad_block_grid": [_P, _U, _U, _U, _U, _U, _P, _P, _P, _P],
    "th_copy_subgrid": [_P, _U, _U, _U, _U, _U, _U, _P],
    "th_fill_blocks": [_P, _U, _P, _U],
    "th_strided_copy_rows": [_P, _P, _U, _U, _U, _U],
    "th_zorder_perm": [_P, _U, _U],
    "th_permute_records": [_P, _P, _U, _U, _P],
}

_lib: ctypes.CDLL | None = None


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH)")
    return cxx


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtexcomp_host_{h.hexdigest()[:16]}.so"


def build(path: Path) -> None:
    """Compile the source into ``path``, written atomically; raise with the
    compiler's output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / path.name
        cmd = [compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(out, path)


def load() -> ctypes.CDLL:
    """The host library, built on first use."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------------------
# The library's functions.
# ---------------------------------------------------------------------------


def pad_block_grid(src: np.ndarray, pbr: int, pbc: int, col_pad: np.ndarray,
                   row_pad: np.ndarray, corner_pad: np.ndarray) -> np.ndarray:
    """Assemble a padded block grid (Compressor4x4Helper::Pad's byte
    movement, compressor4x4_helper.h:420-474).

    src: (nbr, nbc, bs) uint8; col_pad: (nbr, bs); row_pad: (nbc, bs);
    corner_pad: (bs,). Returns (pbr, pbc, bs) uint8.
    """
    nbr, nbc, bs = src.shape
    src, col_pad, row_pad, corner_pad = (
        np.ascontiguousarray(a, dtype=np.uint8)
        for a in (src, col_pad, row_pad, corner_pad))
    dst = np.empty((pbr, pbc, bs), dtype=np.uint8)
    load().th_pad_block_grid(_ptr(src), nbr, nbc, pbr, pbc, bs,
                             _ptr(col_pad), _ptr(row_pad), _ptr(corner_pad),
                             _ptr(dst))
    return dst


def copy_subgrid(src: np.ndarray, r0: int, c0: int, nbr: int,
                 nbc: int) -> np.ndarray:
    """(src_nbr, src_nbc, bs) -> (nbr, nbc, bs) block sub-rectangle."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    bs = src.shape[2]
    dst = np.empty((nbr, nbc, bs), dtype=np.uint8)
    load().th_copy_subgrid(_ptr(src), src.shape[1], bs, r0, c0, nbr, nbc,
                           _ptr(dst))
    return dst


def fill_blocks(n: int, block: np.ndarray) -> np.ndarray:
    """Replicate one block n times -> (n, bs) uint8."""
    block = np.ascontiguousarray(block, dtype=np.uint8).reshape(-1)
    dst = np.empty((n, block.size), dtype=np.uint8)
    load().th_fill_blocks(_ptr(dst), n, _ptr(block), block.size)
    return dst


def strided_copy_rows(src: np.ndarray, rows: int, row_bytes: int,
                      src_stride: int, dst_stride: int,
                      dst_size: int) -> np.ndarray:
    """Row-strided byte copy (image buffer <-> padded row buffer)."""
    src = np.ascontiguousarray(src.reshape(-1).view(np.uint8))
    dst = np.zeros(dst_size, dtype=np.uint8)
    load().th_strided_copy_rows(_ptr(src), _ptr(dst), rows, row_bytes,
                                src_stride, dst_stride)
    return dst


def zorder_perm(nbx: int, nby: int) -> np.ndarray:
    """Z-order block permutation (FromZOrder, pvrtc_compressor.cc:80-86):
    perm[i] is the row-major block index of Z-order slot i, where x takes
    the odd bits of i and y the even bits. (nbx * nby,) int32."""
    out = np.empty(nbx * nby, dtype=np.int32)
    load().th_zorder_perm(_ptr(out), nbx, nby)
    return out


def permute_records(src: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """dst[i] = src[perm[i]] over (N, record_bytes) uint8: host-side block
    reordering (Z-order packing of records already on the host)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    dst = np.empty_like(src)
    load().th_permute_records(_ptr(src), _ptr(perm), src.shape[0],
                              src.shape[1], _ptr(dst))
    return dst


# ---------------------------------------------------------------------------
# Plain numpy twins.
# ---------------------------------------------------------------------------


def pad_block_grid_plain(src: np.ndarray, pbr: int, pbc: int,
                         col_pad: np.ndarray, row_pad: np.ndarray,
                         corner_pad: np.ndarray) -> np.ndarray:
    """numpy version of :func:`pad_block_grid`."""
    nbr, nbc, bs = src.shape
    dst = np.empty((pbr, pbc, bs), dtype=np.uint8)
    dst[:nbr, :nbc] = src
    if pbc > nbc:
        dst[:nbr, nbc:] = col_pad[:, None, :]
    if pbr > nbr:
        dst[nbr:, :nbc] = row_pad[None, :, :]
        if pbc > nbc:
            dst[nbr:, nbc:] = corner_pad[None, None, :]
    return dst


def copy_subgrid_plain(src: np.ndarray, r0: int, c0: int, nbr: int,
                       nbc: int) -> np.ndarray:
    """numpy version of :func:`copy_subgrid`."""
    return np.ascontiguousarray(src[r0 : r0 + nbr, c0 : c0 + nbc])


def fill_blocks_plain(n: int, block: np.ndarray) -> np.ndarray:
    """numpy version of :func:`fill_blocks`."""
    block = np.ascontiguousarray(block, dtype=np.uint8).reshape(-1)
    return np.broadcast_to(block, (n, block.size)).copy()


def strided_copy_rows_plain(src: np.ndarray, rows: int, row_bytes: int,
                            src_stride: int, dst_stride: int,
                            dst_size: int) -> np.ndarray:
    """numpy version of :func:`strided_copy_rows`."""
    src = np.ascontiguousarray(src.reshape(-1).view(np.uint8))
    dst = np.zeros(dst_size, dtype=np.uint8)
    for r in range(rows):
        dst[r * dst_stride : r * dst_stride + row_bytes] = src[
            r * src_stride : r * src_stride + row_bytes]
    return dst


def zorder_perm_plain(nbx: int, nby: int) -> np.ndarray:
    """numpy version of :func:`zorder_perm`."""
    n = nbx * nby
    i = np.arange(n, dtype=np.uint64)
    x = np.zeros(n, dtype=np.uint64)
    y = np.zeros(n, dtype=np.uint64)
    for j in range(16):
        x |= ((i >> np.uint64(j * 2 + 1)) & np.uint64(1)) << np.uint64(j)
        y |= ((i >> np.uint64(j * 2)) & np.uint64(1)) << np.uint64(j)
    return (y * nbx + x).astype(np.int32)


def permute_records_plain(src: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """numpy version of :func:`permute_records`."""
    return np.ascontiguousarray(src)[perm]
