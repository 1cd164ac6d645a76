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
    rows = (out[0], out[1], out[2])
    got = roofline.call_bytes((pixels, cands, True), rows)
    assert got == n * 16 * 4 + k * 2 * n * 4 + 3 * n * 4
    # The operation time, the larger: the search over the given words.
    t_bytes = got / roofline.HBM_BYTES_PER_S
    t_ops = n * roofline.etc1_hq_search_ops(k, False) / roofline.OPS_PER_S
    assert t_ops > t_bytes
    least = roofline.call_least_s("etc1_hq_search_cuda", (pixels, cands, True),
                                  rows)
    assert least == max(t_bytes, t_ops) == t_ops
    # With the candidates fitted in the call: 64 B of pixels and 12 B of
    # results a block, and the fit's and search's operations.
    fused = roofline.call_least_s("etc1_hq_search_cuda", (pixels, None, True),
                                  rows)
    assert roofline.call_bytes((pixels, None, True), rows) == n * (64 + 12)
    assert fused == n * 294020 / roofline.OPS_PER_S


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
    empty(torch.zeros((0, 16), dtype=torch.int32), None, False)
    assert rec.calls == [
        ("dxt1_encode_cuda", (8 * 8 * 3 + 32) / roofline.HBM_BYTES_PER_S, 1),
        ("etc1_hq_search_cuda", 0.0, 0)]
    assert rec.kernels() == 1
    assert rec.least_s() == pytest.approx((192 + 32) / roofline.HBM_BYTES_PER_S)
    rec._wrap("new_kernel_cuda", lambda x: x)(torch.zeros(4))
    assert rec.least_s() is None


def test_the_operation_counts_per_block():
    """Pinned: a change to a count is a change of the benchmark."""
    assert roofline.etc1_hq_evaluation_ops() == 2300
    assert roofline.etc1_hq_fit_ops() == 140269
    assert roofline.etc1_hq_search_ops(40, True) == 294020
    assert roofline.etc1_hq_search_ops(40, False) == 154711
    assert roofline.cluster_topk4_ops(965) == 35731


def test_the_counts_follow_the_reference():
    from texbench.reference import dxt_hq, etc

    rgb = torch.randint(0, 256, (3, 16, 3), generator=torch.Generator()
                        .manual_seed(5), dtype=torch.int32)
    for flip in (False, True):
        cands = etc._hq_candidates(rgb, flip, torch.float32)
        assert len(cands) == roofline.ETC1_HQ_CANDIDATES
    assert (roofline.ETC1_HQ_REFITS, roofline.ETC1_HQ_PROBES) == (
        etc.HQ_REFITS, etc.HQ_PROBES)
    assert dxt_hq.cluster_tables()[0].shape == (965, 3)


def test_the_cluster_fit_is_bound_by_its_operations():
    n = 4096
    prefix = torch.zeros((n, 17, 3), dtype=torch.int32)
    cuts = torch.zeros((965, 3), dtype=torch.int32)
    qtab = torch.zeros((965, 9), dtype=torch.float32)
    out = torch.zeros((n, 4, 6), dtype=torch.float32)
    args = (prefix, cuts, qtab)
    least = roofline.call_least_s("cluster_topk4_cuda", args, out)
    assert least == n * 35731 / roofline.OPS_PER_S
    assert least > roofline.call_bytes(args, out) / roofline.HBM_BYTES_PER_S
    # A wrapper with no count is held to its bytes.
    assert roofline.call_least_s("dxt1_encode_cuda", (prefix,), out) == (
        roofline.call_bytes((prefix,), out) / roofline.HBM_BYTES_PER_S)
    assert set(roofline.OPERATIONS) <= set(roofline.KERNELS_PER_CALL)


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
