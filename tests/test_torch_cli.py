"""The port's CLI, ``python -m texcomp_torch``, case for case as
tests/test_cli.py holds texcomp's, on the CPU (``--device cpu``); each
archive it writes is held to the one texcomp's CLI writes for the same
commands, byte for byte (in-process main(), as tests/test_cli.py runs
texcomp's).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from texcomp.__main__ import main as jmain
from texcomp_torch.__main__ import main
from tests.conftest import make_test_image

CPU = ["--device", "cpu"]
ROOT = Path(__file__).resolve().parent.parent


def run_both(tmp_path, argv_of, archive="a.txc"):
    """Run one command list in both CLIs, each on its own archive; the exit
    codes, and the archives' bytes, must be equal."""
    ours, theirs = tmp_path / f"port_{archive}", tmp_path / f"jax_{archive}"
    rc = main(argv_of(str(ours)) + CPU)
    assert jmain(argv_of(str(theirs))) == rc
    if ours.exists() or theirs.exists():
        assert ours.read_bytes() == theirs.read_bytes()
    return rc, str(ours)


def test_cli_roundtrip(rng, tmp_path, capsys):
    img = make_test_image(rng, 16, 24, 3)
    np.save(tmp_path / "img.npy", img)
    src = str(tmp_path / "img.npy")

    rc, archive = run_both(tmp_path, lambda a: [
        "encode", "--codec", "dxt1", "--input", src, "--archive", a])
    assert rc == 0
    assert main(["info", "--archive", archive]) == 0
    out = capsys.readouterr().out
    assert "img: dxtc RGB 16x24" in out

    assert main(["decode", "--archive", archive, "--name", "img",
                 "--output", str(tmp_path / "dec.npy")] + CPU) == 0
    dec = np.load(tmp_path / "dec.npy")
    assert dec.shape == (16, 24, 3)
    assert jmain(["decode", "--archive", str(tmp_path / "jax_a.txc"),
                  "--name", "img", "--output",
                  str(tmp_path / "jdec.npy")]) == 0
    np.testing.assert_array_equal(dec, np.load(tmp_path / "jdec.npy"))

    rc, _ = run_both(tmp_path, lambda a: [
        "transcode-dxt1-etc1", "--archive", a, "--name", "img"])
    assert rc == 0
    assert main(["decode", "--archive", archive, "--name", "img",
                 "--output", str(tmp_path / "dec2.npy")] + CPU) == 0


@pytest.mark.parametrize("codec,c", [("dxt5", 4), ("etc1", 3), ("pvrtc", 4),
                                     ("pvrtc4", 4)])
def test_cli_encode_decode_codecs(rng, tmp_path, codec, c):
    img = make_test_image(rng, 16, 16, c)
    np.save(tmp_path / "img.npy", img)
    rc, archive = run_both(tmp_path, lambda a: [
        "encode", "--codec", codec, "--input", str(tmp_path / "img.npy"),
        "--archive", a, "--name", f"t_{codec}"])
    assert rc == 0
    assert main(["decode", "--archive", archive, "--name", f"t_{codec}",
                 "--output", str(tmp_path / "dec.npy")] + CPU) == 0
    assert jmain(["decode", "--archive", str(tmp_path / "jax_a.txc"),
                  "--name", f"t_{codec}",
                  "--output", str(tmp_path / "jdec.npy")]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "dec.npy"),
                                  np.load(tmp_path / "jdec.npy"))


def test_cli_transcode_rejects_dxt5_and_missing_name(rng, tmp_path, capsys):
    """A DXT5 entry also carries compressor_name 'dxtc'; transcoding it
    would reinterpret 16-byte blocks as DXT1 and destroy the texture."""
    img = make_test_image(rng, 16, 16, 4)
    np.save(tmp_path / "img.npy", img)
    archive = str(tmp_path / "a.txc")
    assert main(["encode", "--codec", "dxt5", "--input",
                 str(tmp_path / "img.npy"), "--archive", archive] + CPU) == 0

    assert main(["transcode-dxt1-etc1", "--archive", archive,
                 "--name", "img"] + CPU) == 1
    assert "DXT1" in capsys.readouterr().err
    assert main(["transcode-dxt1-etc1", "--archive", archive,
                 "--name", "nope"] + CPU) == 1
    assert "not in archive" in capsys.readouterr().err
    # the archive entry is untouched and still decodes
    assert main(["decode", "--archive", archive, "--name", "img",
                 "--output", str(tmp_path / "dec.npy")] + CPU) == 0
    assert main(["decode", "--archive", archive, "--name", "nope",
                 "--output", str(tmp_path / "dec.npy")] + CPU) == 1
    assert "not in archive" in capsys.readouterr().err


def test_cli_decode_strips_row_padding(rng, tmp_path):
    """Entries encoded with padding_bytes_per_row decode to clean (H, W, C)."""
    from texcomp_torch import CompressedImage, DxtcCompressor, Format
    from texcomp_torch.utils import save_archive

    img = make_test_image(rng, 8, 12, 3)
    pad = 5
    padded = np.concatenate(
        [img.reshape(8, -1),
         np.zeros((8, pad), np.uint8)], axis=1)
    ci = CompressedImage()
    assert DxtcCompressor(device="cpu").compress(
        Format.RGB, 8, 12, pad, padded.tobytes(), ci)
    assert ci.get_metadata().padding_bytes_per_row == pad
    save_archive(str(tmp_path / "p.txc"), {"img": ci})

    assert main(["decode", "--archive", str(tmp_path / "p.txc"),
                 "--name", "img",
                 "--output", str(tmp_path / "dec.npy")] + CPU) == 0
    dec = np.load(tmp_path / "dec.npy")
    assert dec.shape == (8, 12, 3)

    # Same pixels encoded without padding decode to the same image.
    ci0 = CompressedImage()
    assert DxtcCompressor(device="cpu").compress(Format.RGB, 8, 12, 0,
                                                 img.tobytes(), ci0)
    save_archive(str(tmp_path / "p0.txc"), {"img": ci0})
    assert main(["decode", "--archive", str(tmp_path / "p0.txc"),
                 "--name", "img",
                 "--output", str(tmp_path / "dec0.npy")] + CPU) == 0
    np.testing.assert_array_equal(dec, np.load(tmp_path / "dec0.npy"))


def test_cli_mipmap(rng, tmp_path, capsys):
    img = make_test_image(rng, 32, 16, 3)
    np.save(tmp_path / "img.npy", img)
    src = str(tmp_path / "img.npy")
    rc, archive = run_both(tmp_path, lambda a: [
        "encode", "--codec", "dxt1", "--input", src, "--archive", a],
        "m.txc")
    assert rc == 0
    rc, _ = run_both(tmp_path, lambda a: [
        "mipmap", "--archive", a, "--name", "img", "--levels", "3"], "m.txc")
    assert rc == 0
    assert main(["info", "--archive", archive]) == 0
    out = capsys.readouterr().out
    for lvl, size in ((1, "16x8"), (2, "8x4"), (3, "4x2")):
        assert f"img_mip{lvl}: dxtc RGB {size}" in out
    assert main(["decode", "--archive", archive, "--name", "img_mip2",
                 "--output", str(tmp_path / "m2.npy")] + CPU) == 0
    assert np.load(tmp_path / "m2.npy").shape == (8, 4, 3)
    assert main(["mipmap", "--archive", archive, "--name", "zz"] + CPU) == 1


def test_cli_mipmap_rejects_pvrtc(rng, tmp_path, capsys):
    img = make_test_image(rng, 16, 16, 4)
    np.save(tmp_path / "img.npy", img)
    rc, archive = run_both(tmp_path, lambda a: [
        "encode", "--codec", "pvrtc", "--input", str(tmp_path / "img.npy"),
        "--archive", a])
    assert rc == 0
    assert main(["mipmap", "--archive", archive, "--name", "img"] + CPU) == 1
    assert "does not support mipmap chains" in capsys.readouterr().err


def test_cli_rejects_bad_input(rng, tmp_path):
    img = make_test_image(rng, 16, 16, 4)
    np.save(tmp_path / "img4.npy", img)
    assert main(["encode", "--codec", "dxt1", "--input",
                 str(tmp_path / "img4.npy"),
                 "--archive", str(tmp_path / "b.txc")] + CPU) == 1
    # non-power-of-two pvrtc rejected by the compressor
    img = make_test_image(rng, 12, 12, 4)
    np.save(tmp_path / "img12.npy", img)
    assert main(["encode", "--codec", "pvrtc", "--input",
                 str(tmp_path / "img12.npy"),
                 "--archive", str(tmp_path / "b.txc")] + CPU) == 1
    assert not (tmp_path / "b.txc").exists()


def test_cli_transcode_quality_high(rng, tmp_path):
    """transcode-dxt1-etc1 --quality high: HQ re-encode, still decodable,
    never worse than the reference transcode against the DXT1 pixels, and
    the bytes of texcomp's CLI."""
    import torch

    from texcomp_torch.codecs import dxt as dxt_codec
    from texcomp_torch.codecs import etc as etc_codec
    from texcomp_torch.utils import load_archive

    img = make_test_image(rng, 24, 20, 3)
    np.save(tmp_path / "img.npy", img)
    src = str(tmp_path / "img.npy")
    for name in ("ref.txc", "hq.txc"):
        rc, _ = run_both(tmp_path, lambda a: [
            "encode", "--codec", "dxt1", "--input", src, "--archive", a], name)
        assert rc == 0
    a_ref, a_hq = str(tmp_path / "port_ref.txc"), str(tmp_path / "port_hq.txc")
    dxt_blocks = load_archive(a_ref)["img"].get_data().reshape(-1, 8).copy()

    rc, _ = run_both(tmp_path, lambda a: [
        "transcode-dxt1-etc1", "--archive", a, "--name", "img"], "ref.txc")
    assert rc == 0
    rc, _ = run_both(tmp_path, lambda a: [
        "transcode-dxt1-etc1", "--archive", a, "--name", "img",
        "--quality", "high"], "hq.txc")
    assert rc == 0

    pixels = dxt_codec.decode_dxt1_blocks(torch.from_numpy(dxt_blocks))
    err = {}
    for a in (a_ref, a_hq):
        blocks = load_archive(a)["img"].get_data().reshape(-1, 8)
        dec = etc_codec.decode_etc1_blocks(torch.from_numpy(blocks.copy()))
        err[a] = int(((dec.long() - pixels.long()) ** 2).sum())
    assert err[a_hq] <= err[a_ref]
    assert main(["decode", "--archive", a_hq, "--name", "img",
                 "--output", str(tmp_path / "dec.npy")] + CPU) == 0


def test_python_dash_m_runs_the_cli(rng, tmp_path):
    """``python -m texcomp_torch`` as a user calls it, in a process of its
    own: an encode and the archive's listing."""
    img = make_test_image(rng, 16, 16, 3)
    np.save(tmp_path / "img.npy", img)
    archive = str(tmp_path / "s.txc")
    run = [sys.executable, "-m", "texcomp_torch"]
    enc = subprocess.run(run + ["encode", "--codec", "etc1", "--input",
                                str(tmp_path / "img.npy"), "--archive",
                                archive] + CPU, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert enc.returncode == 0, enc.stderr
    assert "img: 16x16 etc1 -> 128 bytes" in enc.stdout
    info = subprocess.run(run + ["info", "--archive", archive], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert info.returncode == 0 and "img: etc RGB 16x16" in info.stdout
