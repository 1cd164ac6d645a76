"""The roofline's byte counts against the calls' shapes, and its table
against the port's kernel wrappers."""

import importlib

import pytest
import torch

from texbench import roofline


def _wrappers(modname):
    mod = importlib.import_module(modname)
    return {n for n, f in vars(mod).items()
            if n.endswith("_cuda") and callable(f)}


def test_every_kernel_wrapper_of_the_port_has_a_count():
    found = set().union(*(_wrappers(m) for m in roofline.WRAPPER_MODULES))
    assert found == set(roofline.KERNELS_PER_CALL)


def test_an_encode_reads_its_image_and_writes_its_blocks():
    image = torch.zeros((64, 32, 3), dtype=torch.uint8)
    out = torch.zeros((128, 8), dtype=torch.uint8)
    assert roofline.call_bytes((image, 64, 32, 2), out) == 64 * 32 * 3 + 128 * 8


def test_the_hq_search_counts_pixels_candidates_and_three_result_rows():
    n, k = 1000, 41
    pixels = torch.zeros((n, 16), dtype=torch.int32)
    cands = torch.zeros((k, 2, n), dtype=torch.int32)
    out = torch.zeros((3, n), dtype=torch.int32)
    got = roofline.call_bytes((pixels, cands, True), (out[0], out[1], out[2]))
    assert got == n * 16 * 4 + k * 2 * n * 4 + 3 * n * 4


def test_a_tensor_passed_twice_counts_once():
    ab = torch.zeros((100, 2), dtype=torch.int32)
    mod = torch.zeros((100, 32), dtype=torch.uint8)
    out = torch.zeros((100, 8), dtype=torch.uint8)
    assert roofline.call_bytes((mod, ab, ab, 10, 10), out) == 800 + 3200 + 800


def test_the_recorder_counts_calls_kernels_and_unknown_wrappers():
    rec = roofline.CallRecorder()
    enc = rec._wrap("dxt1_encode_cuda", lambda img: torch.zeros((4, 8),
                                                               dtype=torch.uint8))
    enc(torch.zeros((8, 8, 3), dtype=torch.uint8))
    empty = rec._wrap("etc1_hq_search_cuda",
                      lambda *a: torch.zeros((3, 0), dtype=torch.int32))
    empty(torch.zeros((0, 16), dtype=torch.int32))
    assert rec.calls == [("dxt1_encode_cuda", 8 * 8 * 3 + 32, 1),
                         ("etc1_hq_search_cuda", 0, 0)]
    assert rec.kernels() == 1
    assert rec.least_s() == pytest.approx((192 + 32) / roofline.HBM_BYTES_PER_S)
    rec._wrap("new_kernel_cuda", lambda x: x)(torch.zeros(4))
    assert rec.least_s() is None


def test_the_recorder_puts_every_wrapper_back():
    mod = importlib.import_module("texcomp_torch.ops.etc_cuda")
    before = mod.etc1_encode_cuda
    with roofline.CallRecorder():
        assert mod.etc1_encode_cuda is not before
    assert mod.etc1_encode_cuda is before


def test_the_port_kernel_names_are_the_kernels_of_csrc():
    import re

    from texbench import trace
    from texbench.manifest import ROOT

    src = "".join(p.read_text() for p in
                  (ROOT / "texcomp_torch" / "csrc").glob("*.cu"))
    names = set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?"
                           r"(\w+)\(", src))
    assert names == set(trace.PORT_KERNELS)
