#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (texcomp_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero before the last
line is printed:

  1. device     CUDA must be present; torch/CUDA versions, card name and
                power limit.
  2. build      the CUDA kernels of texcomp_torch/csrc, built with nvcc
                (one nvcc per source file, all at once).
  3. kernels    each of the nine kernels against its plain PyTorch twin on
                the card at 4096x4096 (1,048,576 blocks), bytes equal:
                DXT1/DXT5 encode of solid and near-solid regions, alpha
                bands, both swap values, always4 and a ragged 4087x4083
                image on a 4096x4096 grid; DXT/ETC1 decode of random block
                bytes and of encoded payloads; ETC1 encode in all four
                strategies on RGB, RGBX and the ragged image; the fused
                DXT1/DXT5/ETC1 downsample of encoded and random payloads
                (ETC1 in all four strategies). Then each kernel's CUDA-event
                median time against its twin's, and its bound.
  4. golden     the 29 reference-mode golden cases of
                tests/golden_vectors.py (21 DXTC, 7 ETC1, the DXT1->ETC1
                transcode) through the port on cuda, digests equal to
                tests/golden/expected.json.
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
                  transcode_dxt1_to_etc1 of the DXT1 payload.
                Every kernel must be launched by the paths that use it.

Before the last line it prints one JSON line with each kernel's launches
in phase 5, its largest difference from its twin, its time, its twin's
time and its bound, then the card's name and power limit as nvidia-smi
gives them. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
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
    transcode_dxt1_to_etc1,
)
from texcomp_torch.api import helper4x4 as h4
from texcomp_torch.blocks import full_outside_mask
from texcomp_torch.codecs import etc
from texcomp_torch.ops import _build, _launch, dxt_cuda, etc_cuda
from texcomp_torch.ops.mipmap import num_chain_levels
from texcomp_torch.utils.profiling import cuda_time_ms

ROOT = Path(__file__).resolve().parent
SIZE = 4096
PIXELS = SIZE * SIZE
DXT_SRC = "texcomp_torch/csrc/dxt.cu"
ETC_SRC = "texcomp_torch/csrc/etc.cu"

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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_work(name: str, args: tuple, out: torch.Tensor):
    """(bytes, operations) of one call: each input read once, each output
    written once, and the operations this call's blocks need."""
    data = args[0]
    nbytes = _nbytes(data, out)
    if name in ("dxt1_encode", "dxt5_encode", "dxt1_downsample",
                "dxt5_downsample"):
        nbytes += 256 * 8  # the const-color table
    n_out = out.shape[0] if out.dim() == 2 else out.numel() // 64
    n_in = data.shape[0]
    per_block = {
        "dxt1_encode": _DXT1_ENCODE_OPS, "dxt5_encode": _DXT5_ENCODE_OPS,
        "dxt1_decode": _DXT1_DECODE_OPS, "dxt5_decode": _DXT5_DECODE_OPS,
        "dxt1_downsample": _DXT1_DOWN_OPS, "dxt5_downsample": _DXT5_DOWN_OPS,
        "etc1_decode": _ETC_DECODE_OPS,
    }
    if name == "etc1_encode":
        ops = n_out * _ETC_ENCODE_OPS[args[3]]
    elif name == "etc1_downsample":
        ops = n_out * (_ETC_DOWN_DECODE_OPS + _ETC_ENCODE_OPS[args[3]])
    elif name.endswith("decode"):
        ops = n_in * per_block[name]
    else:
        ops = n_out * per_block[name]
    return nbytes, ops


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def golden_compressor(case: dict, device):
    """The compressor a golden case runs through."""
    if case["codec"] == "etc":
        return EtcCompressor(CompressionStrategy(case["strategy"]),
                             device=device)
    return DxtcCompressor(device=device)


def golden_outputs(case: dict, gv, device) -> dict:
    """The digests of one golden case (``gv`` is tests/golden_vectors.py)
    through the port on ``device``, keyed as in
    tests/golden/expected.json."""
    comp = golden_compressor(case, device)
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
    _require(comp.compress(fmt, h, w, 0, img.tobytes(), ci), "compress")
    out = CompressedImage()
    if kind == "encode":
        buf = bytearray()
        _require(comp.decompress(ci, buf), "decompress")
        return {"out": gv.digest(ci.get_data()), "decoded": gv.digest(bytes(buf))}
    if kind == "transcode":
        transcode_dxt1_to_etc1(ci, device=device)
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


def dxtc_golden_cases(gv) -> list[dict]:
    return [c for c in gv.CASES
            if c["codec"] == "dxtc" and c["kind"] != "transcode"]


def reference_golden_cases(gv) -> list[dict]:
    """Every reference-mode case the port covers: DXTC, ETC1 and the
    DXT1 -> ETC1 transcode (PVRTC is not ported yet)."""
    return [c for c in gv.CASES if c["codec"] in ("dxtc", "etc")]


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


def kernel_cases(rgb: torch.Tensor, rgba: torch.Tensor) -> dict:
    """kernel name -> [(label, args)]; the first case of each is timed."""
    g = torch.Generator().manual_seed(7)
    rand8 = torch.randint(0, 256, (PIXELS // 16, 8), generator=g,
                          dtype=torch.uint8).cuda()
    rand16 = torch.randint(0, 256, (PIXELS // 16, 16), generator=g,
                           dtype=torch.uint8).cuda()
    rag_h, rag_w = SIZE - 9, SIZE - 13  # 4087 x 4083: 6 has_one_pixel blocks
    rgb_rag = rgb[:rag_h, :rag_w].contiguous()
    rgba_rag = rgba[:rag_h, :rag_w].contiguous()
    outside = full_outside_mask(rag_h, rag_w, SIZE, SIZE, device="cuda")
    if int(outside.sum()) != 6:
        fail(f"ragged grid has {int(outside.sum())} has_one_pixel blocks, want 6")
    dxt1_payload = dxt_cuda.dxt1_encode_cuda(rgb, SIZE, SIZE)
    dxt5_payload = dxt_cuda.dxt5_encode_cuda(rgba, SIZE, SIZE)
    etc_payload = etc_cuda.etc1_encode_cuda(rgb, SIZE, SIZE, etc.SMALLER_ERROR)
    nb = SIZE // 4
    strategies = [etc.SMALLER_ERROR, etc.SPLIT_HORIZONTALLY,
                  etc.SPLIT_VERTICALLY, etc.HEURISTIC]
    return {
        "dxt1_encode": [
            ("rgb", (rgb, SIZE, SIZE, False, False)),
            ("bgr", (rgb, SIZE, SIZE, True, False)),
            ("rgb always4", (rgb, SIZE, SIZE, False, True)),
            ("bgr always4", (rgb, SIZE, SIZE, True, True)),
            ("rgbx input", (rgba, SIZE, SIZE, False, False)),
            ("ragged rgb", (rgb_rag, SIZE, SIZE, False, False)),
            ("ragged bgr", (rgb_rag, SIZE, SIZE, True, False)),
        ],
        "dxt5_encode": [
            ("rgba", (rgba, SIZE, SIZE, False)),
            ("bgra", (rgba, SIZE, SIZE, True)),
            ("ragged rgba", (rgba_rag, SIZE, SIZE, False)),
            ("ragged bgra", (rgba_rag, SIZE, SIZE, True)),
        ],
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
        ],
        "dxt5_downsample": [
            ("encoded", (dxt5_payload, nb, nb, False)),
            ("random", (rand16, nb, nb, False)),
        ],
        "etc1_encode": [
            (f"{label} s{s}", (img, SIZE, SIZE, s))
            for label, img in (("rgb", rgb), ("rgbx input", rgba),
                               ("ragged rgb", rgb_rag))
            for s in strategies],
        "etc1_decode": [
            ("encoded", (etc_payload, SIZE, SIZE)),
            ("random", (rand8, SIZE, SIZE)),
        ],
        "etc1_downsample": [
            (f"encoded s{s}", (etc_payload, nb, nb, s)) for s in strategies],
    }


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


def phase_kernels(rgb: torch.Tensor, rgba: torch.Tensor) -> dict:
    """Kernel vs plain on the card; returns per-kernel results."""
    cases = kernel_cases(rgb, rgba)
    results = {}
    for name, (replaces, source, plain, kernel) in KERNELS.items():
        worst = 0
        for label, args in cases[name]:
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = (int((got.int() - want.int()).abs().max())
                   if got.shape == want.shape else -1)
            worst = max(worst, err)
            if err != 0:
                fail(f"{name} [{label}] differs from its plain twin: "
                     f"shapes {tuple(got.shape)} vs {tuple(want.shape)}, "
                     f"max abs err {err}")
        timed = cases[name][0][1]
        out = kernel(*timed)
        ms = cuda_time_ms(lambda: kernel(*timed), repeats=20)
        plain_ms = cuda_time_ms(lambda: plain(*timed), repeats=5)
        nbytes, ops = kernel_work(name, timed, out)
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = {"replaces": replaces, "source": source,
                         "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[kernels] {name}: {len(cases[name])} cases equal to plain "
              f"(max abs err {worst}); [{cases[name][0][0]}] kernel {ms:.4f} "
              f"ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({nbytes / 2**20:.1f} MiB, {ops / 1e9:.3f} G int "
              f"ops; {bound_ms / ms:.1%} of it)", flush=True)
        if name.endswith("downsample"):
            # The per-level route the fused kernel replaces: decode kernel,
            # 2x2 average in torch, encode kernel.
            unfused = _unfused_level(name, timed)
            t = cuda_time_ms(unfused, repeats=20)
            print(f"[kernels] {name}: decode + average + encode kernels "
                  f"{t:.4f} ms against fused {ms:.4f} ms", flush=True)
        if name in ("etc1_encode", "etc1_downsample"):
            # Every strategy's time: the search differs by strategy.
            per = []
            for label, args in cases[name][1:4]:
                t = cuda_time_ms(lambda: kernel(*args), repeats=20)
                b_ms, b_by = bound(*kernel_work(name, args, out))
                per.append(f"{label} {t:.4f} ms (bound {b_ms:.4f} by {b_by})")
            print(f"[kernels] {name} by strategy: {'; '.join(per)}",
                  flush=True)
    return results


def phase_golden(gv) -> None:
    expected = json.loads((ROOT / "tests" / "golden" / "expected.json").read_text())
    cases = reference_golden_cases(gv)
    for case in cases:
        got = golden_outputs(case, gv, "cuda")
        if got != expected[case["name"]]:
            fail(f"golden {case['name']}: {got} != {expected[case['name']]}")
    print(f"[golden] {len(cases)} reference-mode golden digests "
          f"({len(dxtc_golden_cases(gv))} DXTC, ETC1, transcode) equal on cuda",
          flush=True)


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


def phase_main_path(images: dict, gpu: str) -> dict:
    """The main paths at 4096^2; returns the launch counts, summed."""
    launches = Launches()
    payloads = main_round_trips(images, launches, gpu)
    main_chains(payloads, launches, gpu)
    main_transcode(payloads, launches, gpu)
    missing = [k for k, n in launches.total.items() if n == 0]
    if missing:
        fail(f"main path did not launch {missing}: {launches.total}")
    print(f"[main] launches during the main path: {launches.total}", flush=True)
    return launches.total


def main() -> int:
    gpu = phase_device()
    phase_build()
    gv = _load_golden_vectors()
    rgb_np = make_image(1, SIZE, SIZE, 3)
    rgba_np = make_image(2, SIZE, SIZE, 4)
    kernels = phase_kernels(torch.from_numpy(rgb_np).cuda(),
                            torch.from_numpy(rgba_np).cuda())
    phase_golden(gv)
    launches = phase_main_path({Format.RGB: rgb_np, Format.RGBA: rgba_np}, gpu)

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
