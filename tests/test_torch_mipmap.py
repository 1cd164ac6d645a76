"""texcomp_torch mip chains against the JAX package.

The fused DXTC downsample op's plain twin is held to the Pallas kernel in
interpret mode; ``ops.mipmap.mipmap_chain`` to texcomp's, as
tests/test_mipmap.py runs it; and both compressors' ``downsample_chain``
to texcomp's on the CPU. Tolerance is 0: every step is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import texcomp
import texcomp_torch
from texcomp.ops import dxt_pallas as dp
from texcomp.ops import mipmap as jmip
from tests.conftest import make_test_image
from texcomp_torch.ops import dxt_cuda, etc_cuda, mipmap

H, W = 16, 24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("h,w", [(1024, 1024), (64, 32), (8, 8), (4, 4),
                                 (12, 12), (4096, 24), (40, 24)])
def test_num_chain_levels(h, w):
    assert mipmap.num_chain_levels(h, w) == jmip.num_chain_levels(h, w)


@pytest.mark.parametrize("payload", ["encoded", "random"])
@pytest.mark.parametrize("is_dxt1", [True, False])
def test_dxtc_downsample_encode(rng, is_dxt1, payload):
    bs = 8 if is_dxt1 else 16
    if payload == "encoded":
        img = make_test_image(rng, H, W, 3 if is_dxt1 else 4)
        enc = dxt_cuda.dxt1_encode_image if is_dxt1 else dxt_cuda.dxt5_encode_image
        data = enc(_t(img)).numpy()
    else:
        data = rng.integers(0, 256, (H * W // 16, bs), dtype=np.uint8)
    want = dp.dxtc_downsample_encode_words(
        dp.blocks_to_words(jnp.asarray(data), bs // 4), nby=H // 4,
        nbx=W // 4, is_dxt1=is_dxt1, interpret=True)
    got = dxt_cuda.dxtc_downsample_encode(_t(data), nby=H // 4, nbx=W // 4,
                                          is_dxt1=is_dxt1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(dp.words_to_blocks(want)))


@pytest.mark.parametrize("codec,strategy", [("dxt1", 2), ("dxt5", 2),
                                            ("etc1", 2), ("etc1", 3)])
def test_mipmap_chain(rng, codec, strategy):
    """128x128: five fused levels. texcomp runs its first level through the
    fused Pallas kernel (interpret mode) and the smaller ones through its
    jnp codecs; the port runs every level through the fused op."""
    h = w = 128
    c = 4 if codec == "dxt5" else 3
    img = _t(make_test_image(rng, h, w, c))
    if codec == "etc1":
        data = etc_cuda.etc1_encode_image(img, strategy)
    elif codec == "dxt1":
        data = dxt_cuda.dxt1_encode_image(img)
    else:
        data = dxt_cuda.dxt5_encode_image(img)
    levels = mipmap.num_chain_levels(h, w)
    got = mipmap.mipmap_chain(data, height=h, width=w, codec=codec,
                              levels=levels, strategy=strategy)
    want = jmip.mipmap_chain(jnp.asarray(data.numpy()), height=h, width=w,
                             codec=codec, levels=levels, strategy=strategy,
                             interpret=True)
    assert len(got) == len(want) == 5
    for lvl, (g, wnt) in enumerate(zip(got, want), 1):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt),
                                      err_msg=f"level {lvl}")


def test_mipmap_chain_refuses_odd_levels():
    data = torch.zeros((9, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="levels"):
        mipmap.mipmap_chain(data, height=12, width=12, codec="dxt1", levels=1)
    with pytest.raises(ValueError, match="codec"):
        mipmap.mipmap_chain(data, height=12, width=12, codec="pvrtc", levels=0)


# --- downsample_chain of both compressors against texcomp's ----------------


def _compressors(codec, strategy=2):
    if codec == "etc":
        return (texcomp.EtcCompressor(texcomp.CompressionStrategy(strategy)),
                texcomp_torch.EtcCompressor(
                    texcomp_torch.CompressionStrategy(strategy), device="cpu"))
    return texcomp.DxtcCompressor(), texcomp_torch.DxtcCompressor(device="cpu")


def _chain_both(rng, codec, fmt, h, w, levels=None, strategy=2):
    jc, tc = _compressors(codec, strategy)
    img = make_test_image(rng, h, w, 3 if fmt in (0, 1) else 4)
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert jc.compress(texcomp.Format(fmt), h, w, 0, img.tobytes(), ji)
    assert tc.compress(texcomp_torch.Format(fmt), h, w, 0, img.tobytes(), ti)
    return jc.downsample_chain(ji, levels), tc.downsample_chain(ti, levels)


def _assert_chains_equal(jchain, tchain):
    assert len(tchain) == len(jchain)
    for lvl, (j, t) in enumerate(zip(jchain, tchain), 1):
        jm = j.get_metadata()
        md = t.to_arrays()[0]
        assert (md["uncompressed_height"], md["uncompressed_width"]) == (
            jm.uncompressed_height, jm.uncompressed_width), f"level {lvl}"
        np.testing.assert_array_equal(t.get_data(), j.get_data(),
                                      err_msg=f"level {lvl}")


@pytest.mark.parametrize("codec,fmt", [("dxtc", 0), ("dxtc", 1), ("dxtc", 2),
                                       ("etc", 0)])
def test_downsample_chain_64x64(rng, codec, fmt):
    """Four fused levels, then 4x4 -> 2x2 -> 1x1 level by level."""
    jchain, tchain = _chain_both(rng, codec, fmt, 64, 64)
    assert len(tchain) == 6
    _assert_chains_equal(jchain, tchain)


@pytest.mark.parametrize("codec,fmt,h,w", [("dxtc", 2, 30, 30), ("etc", 0, 30, 30),
                                           ("dxtc", 0, 40, 24), ("etc", 0, 36, 8)])
def test_downsample_chain_ragged(rng, codec, fmt, h, w):
    """Extents that are not multiples of 8 (level by level from the start,
    or after a fused prefix) and chains that stop at an odd block count."""
    jchain, tchain = _chain_both(rng, codec, fmt, h, w)
    _assert_chains_equal(jchain, tchain)


@pytest.mark.parametrize("codec", ["dxtc", "etc"])
def test_downsample_chain_levels(rng, codec):
    jchain, tchain = _chain_both(rng, codec, 0, 64, 64, levels=2)
    assert len(tchain) == 2
    _assert_chains_equal(jchain, tchain)


@pytest.mark.parametrize("codec", ["dxtc", "etc"])
def test_downsample_chain_invalid(codec):
    _, tc = _compressors(codec)
    assert tc.downsample_chain(texcomp_torch.CompressedImage()) == []


def test_chain_runs_fused_ops(rng, monkeypatch):
    """The even prefix of a chain takes one fused op per level; the tail
    takes the level-by-level route."""
    calls = []
    orig = dxt_cuda.dxtc_downsample_plain

    def spy(data, nby, nbx, is_dxt1):
        calls.append((nby, nbx))
        return orig(data, nby, nbx, is_dxt1)

    monkeypatch.setattr(dxt_cuda, "dxtc_downsample_plain", spy)
    _, tchain = _chain_both(rng, "dxtc", 0, 64, 64)
    assert len(tchain) == 6
    assert calls == [(16, 16), (8, 8), (4, 4), (2, 2)]
