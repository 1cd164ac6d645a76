"""Build the CUDA sources under ``texcomp_torch/csrc`` and load them.

At first use ``nvcc`` compiles each ``csrc/*.cu`` file into an object, all
of them at once in parallel, and links the objects into one shared library
with a plain C interface, which is then loaded with ``ctypes``. The library
goes into ``texcomp_torch/_build/`` under a name that carries a hash of
every source file under ``csrc/`` (headers included) and of the flags, so
a stale build is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-shared",)
#: Files whose bytes go into the library's hash.
SOURCE_SUFFIXES = (".cu", ".cuh", ".h")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of each C entry point in csrc/*.cu; each returns a cudaError_t.
SIGNATURES = {
    # csrc/dxt.cu
    "texcomp_dxt1_encode": [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P],
    "texcomp_dxt5_encode": [_P, _I, _I, _I, _I, _P, _P, _I, _P],
    "texcomp_dxt1_decode": [_P, _I, _I, _P, _I, _I, _P],
    "texcomp_dxt5_decode": [_P, _I, _I, _P, _I, _P],
    "texcomp_dxt1_downsample": [_P, _I, _I, _P, _P, _P],
    "texcomp_dxt5_downsample": [_P, _I, _I, _P, _P, _P],
    "texcomp_dxt_downsample_info": [_I, _P],
    "texcomp_dxt_encode_info": [_I, _P],
    # csrc/dxt_hq.cu
    "texcomp_dxt_hq_cluster_topk4": [_P, _I, _P, _P, _I, _P, _P],
    "texcomp_dxt_hq_cluster_topk4_info": [_P],
    # csrc/etc.cu
    "texcomp_etc1_encode": [_P, _I, _I, _I, _I, _I, _P, _I, _P],
    "texcomp_etc1_decode": [_P, _I, _I, _P, _P],
    "texcomp_etc1_downsample": [_P, _I, _I, _P, _I, _P],
    "texcomp_etc1_hq_search": [_P, _I, _P, _I, _I, _P, _P],
    "texcomp_etc1_hq_search_info": [_I, _P],
    "texcomp_etc1_hq_fit_search": [_P, _I, _I, _P, _P],
    "texcomp_etc1_hq_fit_search_info": [_I, _P],
    "texcomp_etc1_encode_info": [_I, _P],
    "texcomp_etc1_downsample_info": [_I, _P],
    "texcomp_etc1_rate": [_I, _I, _I, _P, _P],
    # csrc/pvrtc.cu
    "texcomp_pvrtc_morph": [_P, _I, _I, _P, _P, _P],
    "texcomp_pvrtc_morph_batched": [_P, _I, _I, _I, _P, _P],
    "texcomp_pvrtc_upscale_modulate": [_P, _P, _I, _I, _I, _P, _P],
    "texcomp_pvrtc_modes_pack": [_P, _P, _I, _I, _I, _P, _P],
    "texcomp_pvrtc_upscale_modulate_halo": [_P, _P, _P, _P, _I, _I, _P, _P],
    "texcomp_pvrtc_modes_pack_strip": [_P, _P, _P, _I, _I, _P, _P],
    "texcomp_pvrtc_modes_pack_design": [_I, _P, _P, _I, _I, _I, _P, _P],
    "texcomp_pvrtc_info": [_I, _P],
    # csrc/pvrtc_hq.cu
    "texcomp_pvrtc_hq_normal": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "texcomp_pvrtc_hq_dot": [_P, _P, _I, _P, _I, _P, _P],
    "texcomp_pvrtc_hq_choose": [_P, _P, _I, _I, _I, _I, _P, _P],
    "texcomp_pvrtc_hq_info": [_I, _P],
}

_lib: ctypes.CDLL | None = None


def _sources(csrc_dir: Path = CSRC_DIR) -> list[Path]:
    """Every file the build depends on: the .cu files and their headers."""
    return sorted(p for p in csrc_dir.iterdir()
                  if p.is_file() and p.suffix in SOURCE_SUFFIXES)


def library_path(csrc_dir: Path = CSRC_DIR) -> Path:
    """Where the library for the sources in ``csrc_dir`` and the flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources(csrc_dir):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtexcomp_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    nvcc = cuda_home / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build(path: Path) -> None:
    """Compile the sources into ``path`` (written atomically): one nvcc per
    .cu file, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [s for s in _sources() if s.suffix == ".cu"]
        objs = [Path(tmp) / f"{s.stem}.o" for s in units]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(s),
                   "-o", str(o)] for s, o in zip(units, objs)])
        lib = Path(tmp) / path.name
        _run_all([[nvcc, *NVCC_FLAGS, *LINK_FLAGS, "-o", str(lib),
                   *map(str, objs)]])
        os.replace(lib, path)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.texcomp_cuda_error_string.argtypes = [_I]
        lib.texcomp_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
