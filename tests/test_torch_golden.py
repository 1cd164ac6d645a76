"""texcomp_torch against the C++ reference's recorded digests.

The 29 reference-mode golden cases of tests/golden_vectors.py (21 DXTC,
7 ETC1, and the DXT1->ETC1 transcode) run through the port on the CPU,
with the same case runner that chip_smoke.py uses on the card.
"""

import json
from pathlib import Path

import pytest

from chip_smoke import dxtc_golden_cases, golden_outputs, reference_golden_cases
from tests import golden_vectors

_EXPECTED = json.loads(
    (Path(__file__).parent / "golden" / "expected.json").read_text())
_CASES = dxtc_golden_cases(golden_vectors)
_REFERENCE = reference_golden_cases(golden_vectors)
_NEW = [c for c in _REFERENCE if c not in _CASES]


def test_twenty_one_dxtc_cases():
    assert len(_CASES) == 21


def test_twenty_nine_reference_cases():
    assert len(_REFERENCE) == 29
    assert sorted(c["name"] for c in _NEW) == [
        "down_etc_16x16", "enc_etc_s0_28x20", "enc_etc_s1_28x20",
        "enc_etc_s2_28x20", "enc_etc_s3_28x20", "pad_etc_20x12", "solid_etc",
        "transcode_24x16"]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c["name"])
def test_golden_dxtc(case):
    got = golden_outputs(case, golden_vectors, "cpu")
    assert got == _EXPECTED[case["name"]]


@pytest.mark.parametrize("case", _NEW, ids=lambda c: c["name"])
def test_golden_etc_and_transcode(case):
    got = golden_outputs(case, golden_vectors, "cpu")
    assert got == _EXPECTED[case["name"]]
