"""The port's host runtime (texcomp_torch.native): its C++ library, built
with g++ at first use, against its numpy twins and against texcomp.native.
"""

import subprocess
import sys

import numpy as np
import pytest

from texcomp import native as jnative
from texcomp_torch import native


def test_native_builds_into_the_package_build_dir():
    lib = native.load()
    assert lib is native.load()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libtexcomp_host_")


def test_library_name_carries_the_source_hash(tmp_path, monkeypatch):
    before = native.library_path()
    src = tmp_path / "texcomp_host.cc"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n// changed\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != before


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build(native.library_path())
    assert not (tmp_path / "build" / native.library_path().name).exists()


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Processes that build at once (test workers) each rename a whole
    library into place; every one of them loads it."""
    code = (
        "import sys; from pathlib import Path\n"
        "from texcomp_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "print(native.zorder_perm(2, 4).tolist())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs == ["[0, 2, 1, 3, 4, 6, 5, 7]"] * 3
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]


@pytest.mark.parametrize("shape,pbr,pbc", [
    ((3, 5, 8), 6, 9), ((2, 2, 16), 2, 3), ((4, 1, 8), 5, 1),
    ((1, 1, 8), 1, 1)])
def test_pad_block_grid(rng, shape, pbr, pbc):
    nbr, nbc, bs = shape
    src = rng.integers(0, 256, shape, dtype=np.uint8)
    col = rng.integers(0, 256, (nbr, bs), dtype=np.uint8)
    row = rng.integers(0, 256, (nbc, bs), dtype=np.uint8)
    corner = rng.integers(0, 256, (bs,), dtype=np.uint8)
    got = native.pad_block_grid(src, pbr, pbc, col, row, corner)
    np.testing.assert_array_equal(
        got, native.pad_block_grid_plain(src, pbr, pbc, col, row, corner))
    np.testing.assert_array_equal(
        got, jnative.pad_block_grid(src, pbr, pbc, col, row, corner))
    np.testing.assert_array_equal(got[:nbr, :nbc], src)


@pytest.mark.parametrize("window", [(1, 2, 3, 4), (0, 0, 6, 7), (5, 6, 1, 1)])
def test_copy_subgrid(rng, window):
    src = rng.integers(0, 256, (6, 7, 16), dtype=np.uint8)
    got = native.copy_subgrid(src, *window)
    np.testing.assert_array_equal(got, native.copy_subgrid_plain(src, *window))
    np.testing.assert_array_equal(got, jnative.copy_subgrid(src, *window))
    r0, c0, nbr, nbc = window
    np.testing.assert_array_equal(got, src[r0:r0 + nbr, c0:c0 + nbc])


@pytest.mark.parametrize("n,bs", [(37, 16), (1, 8), (1000, 8)])
def test_fill_blocks(rng, n, bs):
    block = rng.integers(0, 256, (bs,), dtype=np.uint8)
    got = native.fill_blocks(n, block)
    assert got.shape == (n, bs)
    np.testing.assert_array_equal(got, native.fill_blocks_plain(n, block))
    np.testing.assert_array_equal(got, jnative.fill_blocks(n, block))


@pytest.mark.parametrize("rows,row_bytes,src_stride,dst_stride", [
    (10, 12, 20, 15), (10, 12, 12, 20), (1, 5, 5, 5), (7, 0, 3, 4)])
def test_strided_copy_rows(rng, rows, row_bytes, src_stride, dst_stride):
    src = rng.integers(0, 256, (rows * src_stride,), dtype=np.uint8)
    size = rows * dst_stride
    args = (src, rows, row_bytes, src_stride, dst_stride, size)
    got = native.strided_copy_rows(*args)
    np.testing.assert_array_equal(got, native.strided_copy_rows_plain(*args))
    np.testing.assert_array_equal(got, jnative.strided_copy_rows(*args))


@pytest.mark.parametrize("nbx,nby", [(1, 2), (2, 4), (8, 16), (32, 64),
                                     (4, 4), (2, 1)])
def test_zorder_perm(nbx, nby):
    got = native.zorder_perm(nbx, nby)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, native.zorder_perm_plain(nbx, nby))
    np.testing.assert_array_equal(got, jnative.zorder_perm(nbx, nby))


def test_zorder_perm_spot_values():
    # FromZOrder (pvrtc_compressor.cc:80-86): slot 1 is (x=0, y=1).
    p = native.zorder_perm(2, 4)
    assert list(p[:4]) == [0, 2, 1, 3]


@pytest.mark.parametrize("n,record", [(100, 8), (1, 8), (64, 16)])
def test_permute_records(rng, n, record):
    src = rng.integers(0, 256, (n, record), dtype=np.uint8)
    perm = rng.permutation(n).astype(np.int32)
    got = native.permute_records(src, perm)
    np.testing.assert_array_equal(got, native.permute_records_plain(src, perm))
    np.testing.assert_array_equal(got, jnative.permute_records(src, perm))
    np.testing.assert_array_equal(got, src[perm])


def test_permute_records_to_zorder(rng):
    """Z-order packing of row-major records on the host."""
    nbx, nby = 8, 16
    src = rng.integers(0, 256, (nbx * nby, 8), dtype=np.uint8)
    perm = native.zorder_perm(nbx, nby)
    np.testing.assert_array_equal(native.permute_records(src, perm),
                                  jnative.permute_records(src, perm))
