"""The port's spans (``texcomp_torch.utils.profiling.span``): which steps a
request marks on a recording torch.profiler's timeline, that they nest as
the benchmark's readers assume, and that with no profiler a span site
costs one check and records nothing."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import texcomp_torch
from texcomp_torch.utils import profiling

HQ_NAMES = {"texcomp.api.compress", "texcomp.api.upload",
            "texcomp.api.download", "texcomp.etc1.hq.encode",
            "texcomp.etc1.hq.search"}
API_NAMES = {"texcomp.api.compress", "texcomp.api.upload",
             "texcomp.api.download"}
PVRTC_HQ_STEPS = ["texcomp.pvrtc.hq.reference", "texcomp.pvrtc.hq.fit",
                  "texcomp.pvrtc.hq.refine", "texcomp.pvrtc.hq.assign",
                  "texcomp.pvrtc.hq.choose"]
PVRTC_HQ_NAMES = API_NAMES | {"texcomp.pvrtc.hq.encode", *PVRTC_HQ_STEPS}


def _image(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[: h // 2, : w // 2] = img[0, 0]  # solid blocks
    return img


def _etc_hq(img, method):
    comp = texcomp_torch.EtcCompressor(quality="high", device="cpu")
    out = texcomp_torch.CompressedImage()
    h, w = img.shape[:2]
    fmt = texcomp_torch.Format.RGB
    if method == "compress":
        assert comp.compress(fmt, h, w, 0, img.tobytes(), out)
    else:
        assert comp.compress_and_pad(fmt, h, w, h + 4, w + 8, 0,
                                     img.tobytes(), out)
    return out


def _dxtc(img, fmt):
    comp = texcomp_torch.DxtcCompressor(device="cpu")
    out = texcomp_torch.CompressedImage()
    h, w = img.shape[:2]
    assert comp.compress(fmt, h, w, 0, img.tobytes(), out)
    return out


def _pvrtc(img, bits, quality):
    cls = (texcomp_torch.PvrtcCompressor if bits == 2
           else texcomp_torch.Pvrtc4bppCompressor)
    comp = cls(quality, device="cpu")
    out = texcomp_torch.CompressedImage()
    h, w = img.shape[:2]
    assert comp.compress(texcomp_torch.Format.RGBA, h, w, 0, img.tobytes(),
                         out)
    return out


def _recorded(fn):
    """Run ``fn`` under a CPU torch.profiler; return its result and the
    port's spans, [(name, start ns, end ns)] in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("texcomp."):
            start = ev.start_ns()
            spans.append((ev.name(), start, start + ev.duration_ns()))
    return result, sorted(spans, key=lambda s: s[1])


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("method", ["compress", "compress_and_pad"])
def test_hq_etc1_request_records_five_names_in_six_spans(method):
    """What the card records, on the CPU too: compress, upload, encode,
    one search a flip, download."""
    _, spans = _recorded(lambda: _etc_hq(_image(8, 12, 3), method))
    assert {n for n, _, _ in spans} == HQ_NAMES
    assert len(spans) == 6
    (request,) = [s for s in spans if s[0] == "texcomp.api.compress"]
    assert all(_within(s, request) for s in spans)
    (encode,) = [s for s in spans if s[0] == "texcomp.etc1.hq.encode"]
    steps = [s for s in spans if s[0].startswith("texcomp.etc1.hq.")
             and s is not encode]
    # One search a flip, inside the encode.
    assert [n for n, _, _ in steps] == ["texcomp.etc1.hq.search"] * 2
    assert all(_within(s, encode) for s in steps)
    order = [n for n, _, _ in spans if n.startswith("texcomp.api.")]
    assert order == ["texcomp.api.compress", "texcomp.api.upload",
                     "texcomp.api.download"]
    (upload,) = [s for s in spans if s[0] == "texcomp.api.upload"]
    (download,) = [s for s in spans if s[0] == "texcomp.api.download"]
    assert upload[2] <= encode[1] and encode[2] <= download[1]


@pytest.mark.parametrize("fmt", ["RGB", "RGBA"])
def test_dxtc_request_records_the_api_spans_only(fmt):
    _, spans = _recorded(lambda: _dxtc(
        _image(8, 8, 3 if fmt == "RGB" else 4), texcomp_torch.Format[fmt]))
    assert sorted(n for n, _, _ in spans) == sorted(API_NAMES)
    (request,) = [s for s in spans if s[0] == "texcomp.api.compress"]
    assert all(_within(s, request) for s in spans)


@pytest.mark.parametrize("bits,side", [(4, 16), (2, 32)])
def test_hq_pvrtc_request_records_one_span_a_name(bits, side):
    """4bpp: the API's three spans and five of the fit's, 8 in all; 2bpp
    adds the packing-aware refine rounds, 9."""
    _, spans = _recorded(lambda: _pvrtc(_image(side, side, 4), bits, "high"))
    steps = [n for n in PVRTC_HQ_STEPS
             if bits == 2 or n != "texcomp.pvrtc.hq.refine"]
    names = [n for n, _, _ in spans]
    assert sorted(names) == sorted(API_NAMES | {"texcomp.pvrtc.hq.encode",
                                                *steps})
    assert len(spans) == (8 if bits == 4 else 9)
    (request,) = [s for s in spans if s[0] == "texcomp.api.compress"]
    assert all(_within(s, request) for s in spans)
    (encode,) = [s for s in spans if s[0] == "texcomp.pvrtc.hq.encode"]
    # The fit's steps in order inside the encode, between the upload and
    # the download.
    assert [n for n in names if n in steps] == steps
    assert all(_within(s, encode) for s in spans if s[0] in steps)
    assert names[:2] == ["texcomp.api.compress", "texcomp.api.upload"]
    assert names[-1] == "texcomp.api.download"
    (upload,) = [s for s in spans if s[0] == "texcomp.api.upload"]
    (download,) = [s for s in spans if s[0] == "texcomp.api.download"]
    assert upload[2] <= encode[1] and encode[2] <= download[1]


@pytest.mark.parametrize("bits", [2, 4])
def test_reference_pvrtc_request_records_the_api_spans_only(bits):
    _, spans = _recorded(lambda: _pvrtc(_image(16, 16, 4), bits,
                                        "reference"))
    assert [n for n, _, _ in spans] == ["texcomp.api.compress",
                                        "texcomp.api.upload",
                                        "texcomp.api.download"]
    assert all(_within(s, spans[0]) for s in spans)


@pytest.mark.parametrize("name", sorted(HQ_NAMES | PVRTC_HQ_NAMES))
def test_without_a_profiler_a_span_is_the_shared_no_op(name, monkeypatch):
    def no_call(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_call)
    assert profiling.span(name) is profiling.NO_SPAN
    with profiling.span(name):
        pass


def test_a_recording_profiler_opens_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = profiling.span("texcomp.test")
        assert ctx is not profiling.NO_SPAN
        with ctx:
            torch.ones(2).add_(1)
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name() == "texcomp.test"] == ["texcomp.test"]


def test_no_profiler_records_no_span():
    """Spans outside a profile leave nothing for a later one to read."""
    _etc_hq(_image(8, 8, 3), "compress")
    _, spans = _recorded(lambda: torch.ones(2).add_(1))
    assert spans == []


@pytest.mark.parametrize("codec", ["etc1_hq", "dxt1", "dxt5", "pvrtc_hq",
                                   "pvrtc4_hq"])
def test_payload_bytes_do_not_depend_on_the_profiler(codec):
    def run():
        if codec == "etc1_hq":
            return _etc_hq(_image(8, 12, 3, seed=1), "compress")
        if codec.startswith("pvrtc"):
            return _pvrtc(_image(32, 32, 4, seed=1),
                          2 if codec == "pvrtc_hq" else 4, "high")
        fmt = texcomp_torch.Format.RGB if codec == "dxt1" else \
            texcomp_torch.Format.RGBA
        return _dxtc(_image(8, 12, 3 if codec == "dxt1" else 4, seed=1), fmt)

    plain = run()
    traced, spans = _recorded(run)
    assert spans
    np.testing.assert_array_equal(plain.get_data(), traced.get_data())
    assert plain.to_arrays()[0] == traced.to_arrays()[0]
