#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (texcomp_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero before the last
line is printed:

  1. device     CUDA must be present; torch/CUDA versions, card name and
                power limit.
  2. build      the CUDA kernels of texcomp_torch/csrc, built with nvcc.
  3. kernels    each of the four kernels against its plain PyTorch twin on
                the card at 4096x4096 (1,048,576 blocks), bytes equal:
                solid and near-solid regions (the const-color path), alpha
                bands of 0, 255 and a gradient, both swap values, DXT1
                always4, a ragged 4087x4083 image on a 4096x4096 grid
                (edge replication and has_one_pixel blocks), and decode of
                random block bytes and of encoded payloads. Then each
                kernel's CUDA-event median time against its twin's.
  4. golden     the 21 DXTC golden cases (tests/golden_vectors.py) through
                DxtcCompressor(device="cuda"), digests equal to
                tests/golden/expected.json.
  5. main path  DxtcCompressor(device="cuda") compress -> decompress of a
                4096x4096 RGB and RGBA image: payload and decoded bytes
                equal to the plain path on the card, every kernel launched.

Before the last line it prints one JSON line with each kernel's launches
in phase 5, its largest difference from its twin and both times, then the
card's name and power limit as nvidia-smi gives them. The last line is
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

from texcomp_torch import CompressedImage, DxtcCompressor, Format
from texcomp_torch.blocks import full_outside_mask
from texcomp_torch.ops import _build, dxt_cuda
from texcomp_torch.utils.profiling import cuda_time_ms

ROOT = Path(__file__).resolve().parent
SIZE = 4096
PIXELS = SIZE * SIZE

#: kernel name -> (TPU kernel it replaces, plain twin, kernel wrapper)
KERNELS = {
    "dxt1_encode": ("texcomp/ops/dxt_pallas.py:238",  # _dxt1_kernel
                    dxt_cuda.dxt1_encode_plain, dxt_cuda.dxt1_encode_cuda),
    "dxt5_encode": ("texcomp/ops/dxt_pallas.py:301",  # _dxt5_kernel
                    dxt_cuda.dxt5_encode_plain, dxt_cuda.dxt5_encode_cuda),
    "dxt1_decode": ("texcomp/ops/dxt_pallas.py:568",  # _dxt1_decode_kernel
                    dxt_cuda.dxt1_decode_plain, dxt_cuda.dxt1_decode_cuda),
    "dxt5_decode": ("texcomp/ops/dxt_pallas.py:613",  # _dxt5_decode_kernel
                    dxt_cuda.dxt5_decode_plain, dxt_cuda.dxt5_decode_cuda),
}


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


def golden_outputs(comp, case: dict, gv) -> dict:
    """The digests of one golden case (``gv`` is tests/golden_vectors.py),
    keyed as in tests/golden/expected.json."""
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


def _load_golden_vectors():
    path = ROOT / "tests" / "golden_vectors.py"
    spec = importlib.util.spec_from_file_location("golden_vectors", path)
    gv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gv)
    return gv


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


def phase_kernels(rgb: torch.Tensor, rgba: torch.Tensor) -> dict:
    """Kernel vs plain on the card; returns per-kernel results."""
    g = torch.Generator().manual_seed(7)
    rand8 = torch.randint(0, 256, (PIXELS // 16, 8), generator=g,
                          dtype=torch.uint8).cuda()
    rand16 = torch.randint(0, 256, (PIXELS // 16, 16), generator=g,
                           dtype=torch.uint8).cuda()
    rag_h, rag_w = SIZE - 9, SIZE - 13  # 4087 x 4083: 6 has_one_pixel blocks
    rgb_rag = rgb[:rag_h, :rag_w].contiguous()
    rgba_rag = rgba[:rag_h, :rag_w].contiguous()
    dxt1_payload = dxt_cuda.dxt1_encode_cuda(rgb, SIZE, SIZE)
    dxt5_payload = dxt_cuda.dxt5_encode_cuda(rgba, SIZE, SIZE)

    cases = {
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
    }
    outside = full_outside_mask(rag_h, rag_w, SIZE, SIZE, device="cuda")
    if int(outside.sum()) != 6:
        fail(f"ragged grid has {int(outside.sum())} has_one_pixel blocks, want 6")

    results = {}
    for name, (replaces, plain, kernel) in KERNELS.items():
        worst = 0
        for label, args in cases[name]:
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            worst = max(worst, err)
            if got.shape != want.shape or err != 0:
                fail(f"{name} [{label}] differs from its plain twin: "
                     f"shapes {tuple(got.shape)} vs {tuple(want.shape)}, "
                     f"max abs err {err}")
        timed = cases[name][0][1]
        ms = cuda_time_ms(lambda: kernel(*timed), repeats=20)
        plain_ms = cuda_time_ms(lambda: plain(*timed), repeats=5)
        results[name] = {"replaces": replaces, "max_abs_err": worst,
                         "ms": ms, "plain_ms": plain_ms}
        print(f"[kernels] {name}: {len(cases[name])} cases equal to plain "
              f"(max abs err {worst}); 4096x4096 kernel {ms:.4f} ms "
              f"({PIXELS / ms / 1e3:.1f} Mpix/s), plain {plain_ms:.3f} ms "
              f"({PIXELS / plain_ms / 1e3:.1f} Mpix/s)", flush=True)
    return results


def phase_golden(gv) -> None:
    expected = json.loads((ROOT / "tests" / "golden" / "expected.json").read_text())
    comp = DxtcCompressor(device="cuda")
    cases = dxtc_golden_cases(gv)
    for case in cases:
        got = golden_outputs(comp, case, gv)
        if got != expected[case["name"]]:
            fail(f"golden {case['name']}: {got} != {expected[case['name']]}")
    print(f"[golden] {len(cases)} DXTC golden digests equal on cuda", flush=True)


def phase_main_path(images: dict, gpu: str) -> dict:
    """compress -> decompress at 4096^2 through DxtcCompressor(device="cuda").
    Returns the launch counts of this phase."""
    comp = DxtcCompressor(device="cuda")
    runs = 3
    dxt_cuda.reset_launches()
    results = {}
    for fmt, img in images.items():
        times_c, times_d = [], []
        for _ in range(runs):
            ci = CompressedImage()
            t0 = time.perf_counter()
            _require(comp.compress(fmt, SIZE, SIZE, 0, img, ci), "compress")
            t1 = time.perf_counter()
            buf = bytearray()
            _require(comp.decompress(ci, buf), "decompress")
            t2 = time.perf_counter()
            times_c.append(t1 - t0)
            times_d.append(t2 - t1)
        results[fmt] = (ci, buf, times_c, times_d)
    launches = dict(dxt_cuda.LAUNCHES)

    for fmt, (ci, buf, times_c, times_d) in results.items():
        img = images[fmt]
        dev = torch.from_numpy(img).cuda()
        if fmt == Format.RGB:
            payload = dxt_cuda.dxt1_encode_plain(dev, SIZE, SIZE)
            decoded = dxt_cuda.dxt1_decode_plain(payload, SIZE, SIZE)[:, :, :3]
        else:
            payload = dxt_cuda.dxt5_encode_plain(dev, SIZE, SIZE)
            decoded = dxt_cuda.dxt5_decode_plain(payload, SIZE, SIZE)
        if not np.array_equal(ci.get_data(), payload.cpu().numpy().reshape(-1)):
            fail(f"{fmt.name}: payload differs from the plain path")
        if bytes(buf) != decoded.cpu().numpy().tobytes():
            fail(f"{fmt.name}: decoded bytes differ from the plain path")
        decoded_np = np.frombuffer(bytes(buf), np.uint8).reshape(img.shape)
        err = np.abs(decoded_np.astype(np.int16) - img).mean()
        mc, md = statistics.median(times_c), statistics.median(times_d)
        print(f"[main] {fmt.name} 4096x4096 on {gpu}: payload and decoded "
              f"bytes equal to plain; mean |decoded-input| {err:.2f}; "
              f"compress wall {mc * 1e3:.1f} ms ({PIXELS / mc / 1e6:.1f} Mpix/s), "
              f"decompress wall {md * 1e3:.1f} ms ({PIXELS / md / 1e6:.1f} "
              f"Mpix/s), median of {runs} incl. host<->device copies; "
              f"first run {times_c[0] * 1e3:.1f} / {times_d[0] * 1e3:.1f} ms",
              flush=True)

    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"main path did not launch {missing}: {launches}")
    print(f"[main] launches during the main path: {launches}", flush=True)
    return launches


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

    report = [{"name": name, "route": "cuda",
               "source": "texcomp_torch/csrc/dxt.cu",
               "replaces": r["replaces"],
               "launches": launches[name], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"]}
              for name, r in kernels.items()]
    print(json.dumps({"kernels": report}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
