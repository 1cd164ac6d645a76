"""texcomp_torch against the C++ reference's recorded digests.

The 32 reference-mode golden cases of tests/golden_vectors.py (21 DXTC,
7 ETC1, the DXT1->ETC1 transcode and 3 PVRTC 2bpp encodes) run through the
port on the CPU, with the same case runner that chip_smoke.py uses on the
card; so do the 3 self-pinned PVRTC extension cases of
tests/golden/extensions.json (4bpp encode + decode, the 2bpp decode).

The 14 quality="high" cases of chip_smoke.HQ_CASES have no reference
referent: tests/golden/hq_torch.json pins texcomp's CPU digests, which
texcomp must still give and the port must equal (chip_smoke.py holds the
card to them). ``python -m tests.test_torch_golden`` rewrites the file
from texcomp.
"""

import json
import sys
from pathlib import Path

import pytest

from chip_smoke import (
    HQ_CASES,
    dxtc_golden_cases,
    extension_golden_outputs,
    golden_outputs,
    reference_golden_cases,
)
from tests import golden_vectors

_GOLDEN = Path(__file__).parent / "golden"
_EXPECTED = json.loads((_GOLDEN / "expected.json").read_text())
_EXT_EXPECTED = json.loads((_GOLDEN / "extensions.json").read_text())
_HQ_FILE = _GOLDEN / "hq_torch.json"
_CASES = dxtc_golden_cases(golden_vectors)
_REFERENCE = reference_golden_cases(golden_vectors)
_PVRTC = [c for c in _REFERENCE if c["codec"] == "pvrtc"]
_NEW = [c for c in _REFERENCE if c not in _CASES and c not in _PVRTC]


def test_twenty_one_dxtc_cases():
    assert len(_CASES) == 21


def test_twenty_nine_reference_cases():
    """The DXTC, ETC1 and transcode cases."""
    assert len(_CASES) + len(_NEW) == 29
    assert sorted(c["name"] for c in _NEW) == [
        "down_etc_16x16", "enc_etc_s0_28x20", "enc_etc_s1_28x20",
        "enc_etc_s2_28x20", "enc_etc_s3_28x20", "pad_etc_20x12", "solid_etc",
        "transcode_24x16"]


def test_thirty_two_reference_cases():
    """Every reference-mode case of tests/golden_vectors.py, PVRTC too."""
    assert len(_REFERENCE) == len(golden_vectors.CASES) == 32
    assert sorted(c["name"] for c in _PVRTC) == [
        "enc_pvrtc_32", "enc_pvrtc_64", "enc_pvrtc_8"]
    assert len(golden_vectors.EXT_CASES) == 3


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c["name"])
def test_golden_dxtc(case):
    got = golden_outputs(case, golden_vectors, "cpu")
    assert got == _EXPECTED[case["name"]]


@pytest.mark.parametrize("case", _NEW, ids=lambda c: c["name"])
def test_golden_etc_and_transcode(case):
    got = golden_outputs(case, golden_vectors, "cpu")
    assert got == _EXPECTED[case["name"]]


@pytest.mark.parametrize("case", _PVRTC, ids=lambda c: c["name"])
def test_golden_pvrtc(case):
    got = golden_outputs(case, golden_vectors, "cpu")
    assert got == _EXPECTED[case["name"]]


@pytest.mark.parametrize("case", golden_vectors.EXT_CASES,
                         ids=lambda c: c["name"])
def test_golden_pvrtc_extensions(case):
    """Self-pinned digests: the port's extension bytes equal texcomp's."""
    got = extension_golden_outputs(case, golden_vectors, "cpu")
    assert got == _EXT_EXPECTED[case["name"]]


def texcomp_hq_outputs(case: dict) -> dict:
    """One HQ case through texcomp on the CPU: golden_outputs' steps with
    quality="high"."""
    import texcomp

    gv = golden_vectors
    fmt = texcomp.Format(case["fmt"])
    h, w = case["h"], case["w"]
    img = gv.golden_image(case["seed"], h, w, case["comps"])
    if case["codec"] == "etc":
        comp = texcomp.EtcCompressor(quality="high")
    elif case["codec"] == "pvrtc":
        comp = texcomp.PvrtcCompressor(quality="high")
    elif case["codec"] == "pvrtc4":
        comp = texcomp.Pvrtc4bppCompressor(quality="high")
    else:
        comp = texcomp.DxtcCompressor("high")
    ci = texcomp.CompressedImage()
    if case["kind"] == "transcode":
        assert texcomp.DxtcCompressor().compress(fmt, h, w, 0, img.tobytes(), ci)
        texcomp.transcode_dxt1_to_etc1(ci, quality="high")
        return {"out": gv.digest(ci.get_data())}
    assert comp.compress(fmt, h, w, 0, img.tobytes(), ci)
    if case["kind"] == "encode" and case["codec"] == "pvrtc":
        return {"out": gv.digest(ci.get_data())}  # PVRTC 2bpp has no decode
    if case["kind"] == "encode":
        buf = bytearray()
        assert comp.decompress(ci, buf)
        return {"out": gv.digest(ci.get_data()), "decoded": gv.digest(bytes(buf))}
    out = texcomp.CompressedImage()
    assert comp.downsample(ci, out)
    return {"out": gv.digest(out.get_data())}


def _hq_expected() -> dict:
    return json.loads(_HQ_FILE.read_text())


def test_eleven_hq_cases():
    """The HQ cases, named once for the first eleven (DXTC, ETC1); the
    three PVRTC HQ cases make fourteen."""
    names = [c["name"] for c in HQ_CASES]
    assert len(names) == len(set(names)) == 14
    assert sorted(_hq_expected()) == sorted(names)


@pytest.mark.parametrize("case", HQ_CASES, ids=lambda c: c["name"])
def test_golden_hq_texcomp(case):
    """texcomp still gives the pinned HQ digest."""
    assert texcomp_hq_outputs(case) == _hq_expected()[case["name"]]


@pytest.mark.parametrize("case", HQ_CASES, ids=lambda c: c["name"])
def test_golden_hq_port(case):
    """The port on the CPU gives the pinned HQ digest."""
    got = golden_outputs(case, golden_vectors, "cpu", "high")
    assert got == _hq_expected()[case["name"]]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    digests = {c["name"]: texcomp_hq_outputs(c) for c in HQ_CASES}
    _HQ_FILE.write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(digests)} digests to {_HQ_FILE}", file=sys.stderr)
