"""The command gives no result where it cannot measure: without a card,
and in a directory that holds only BENCHMARK.json and texbench/."""

import shutil
import subprocess
import sys

import pytest

from texbench.manifest import HERE, ROOT

ARGS = ["-m", "texbench.run", "--workload", "etc1k.hq", "--seed",
        "4294967311", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, *ARGS], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def _no_result(out):
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_without_a_card_there_is_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    out = _run(ROOT)
    assert out.returncode == 2
    _no_result(out)


def test_alone_there_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "texbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
