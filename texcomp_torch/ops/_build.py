"""Build the CUDA sources under ``texcomp_torch/csrc`` and load them.

At first use ``nvcc`` compiles every ``csrc/*.cu`` file into one shared
library with a plain C interface, which is then loaded with ``ctypes``. The
library goes into ``texcomp_torch/_build/`` under a name that carries a
hash of the sources and the flags, so a stale build is never loaded.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of each C entry point in csrc/dxt.cu; each returns a cudaError_t.
SIGNATURES = {
    "texcomp_dxt1_encode": [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P],
    "texcomp_dxt5_encode": [_P, _I, _I, _I, _I, _P, _P, _I, _P],
    "texcomp_dxt1_decode": [_P, _I, _I, _P, _I, _I, _P],
    "texcomp_dxt5_decode": [_P, _I, _I, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
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


def build(path: Path) -> None:
    """Compile the sources into ``path`` (written atomically)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


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
