"""texcomp_torch against the C++ reference's recorded digests.

The 32 reference-mode golden cases of tests/golden_vectors.py (21 DXTC,
7 ETC1, the DXT1->ETC1 transcode and 3 PVRTC 2bpp encodes) run through the
port on the CPU, with the same case runner that chip_smoke.py uses on the
card; so do the 3 self-pinned PVRTC extension cases of
tests/golden/extensions.json (4bpp encode + decode, the 2bpp decode).
"""

import json
from pathlib import Path

import pytest

from chip_smoke import (
    dxtc_golden_cases,
    extension_golden_outputs,
    golden_outputs,
    reference_golden_cases,
)
from tests import golden_vectors

_GOLDEN = Path(__file__).parent / "golden"
_EXPECTED = json.loads((_GOLDEN / "expected.json").read_text())
_EXT_EXPECTED = json.loads((_GOLDEN / "extensions.json").read_text())
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
