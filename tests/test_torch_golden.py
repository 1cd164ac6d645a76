"""texcomp_torch against the C++ reference's recorded digests.

The 21 DXTC golden cases of tests/golden_vectors.py (every DXTC kind but
the DXT1->ETC1 transcode) run through DxtcCompressor(device="cpu"), with
the same case runner that chip_smoke.py uses on the card.
"""

import json
from pathlib import Path

import pytest

from chip_smoke import dxtc_golden_cases, golden_outputs
from tests import golden_vectors
from texcomp_torch import DxtcCompressor

_EXPECTED = json.loads(
    (Path(__file__).parent / "golden" / "expected.json").read_text())
_CASES = dxtc_golden_cases(golden_vectors)


def test_twenty_one_dxtc_cases():
    assert len(_CASES) == 21


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c["name"])
def test_golden_dxtc(case):
    got = golden_outputs(DxtcCompressor(device="cpu"), case, golden_vectors)
    assert got == _EXPECTED[case["name"]]
