"""texcomp_torch mip chains against the JAX package.

The fused DXTC downsample op's plain twin is held to the Pallas kernel in
interpret mode; ``ops.mipmap.mipmap_chain`` to texcomp's, as
tests/test_mipmap.py runs it; and both compressors' ``downsample_chain``
to texcomp's on the CPU. Numpy models of the fused DXTC level's kernel
arithmetic (csrc/dxt.cu) are held to the twin and to texcomp. Tolerance
is 0: every step is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import texcomp
import texcomp_torch
from chip_smoke import edge_words
from texcomp.ops import dxt_pallas as dp
from texcomp.ops import mipmap as jmip
from tests.conftest import make_test_image
from texcomp_torch.codecs import dxt
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


# --- csrc/dxt.cu's fused level, as numpy models, against the twin ----------
#
# The kernel decodes a source block a row at a time: a channel's palette
# (or the alpha ramp) packed one entry a byte, looked up for a row of 4
# pixels by one byte permute whose selector holds the row's codes one a
# nibble. Source block q is destination quadrant q, so each destination
# pixel is the 2x2 sum of two row words: by __dp4a in the kernel; in 16-bit
# lanes in the form it was measured against, which took more instructions.
# The models take each step as the kernel does, vectorised over blocks.

_FORMS = ["dp4a", "lanes"]


def _bytes4(w):
    return np.stack([(w >> (8 * k)) & 255 for k in range(4)], axis=-1)


def _pack4(b):
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _byte_perm(x, y, sel):
    """__byte_perm (PRMT's default mode): result byte n is byte
    (sel >> 4n) & 7 of (x, y). PRMT reads bit 3 of a nibble as a sign
    flag, so the kernel keeps it clear: asserted here."""
    x, y, sel = np.broadcast_arrays(x, y, sel)
    src = np.concatenate([_bytes4(x), _bytes4(y)], axis=-1)
    out = []
    for n in range(4):
        s = (sel >> (4 * n)) & 15
        assert (s < 8).all()
        out.append(np.take_along_axis(src, s[..., None], axis=-1)[..., 0])
    return _pack4(np.stack(out, axis=-1))


def _dot(x, y):
    """__dp4a, unsigned: the dot product of the four bytes."""
    return (_bytes4(x) * _bytes4(y)).sum(axis=-1)


def _words(data):
    """(N, 8 | 16) uint8 blocks -> (N, 2 | 4) little-endian words."""
    d = data.astype(np.int64).reshape(len(data), -1, 4)
    return _pack4(d)


def _ext5(v):
    return (v << 3) | (v >> 2)


def _ext6(v):
    return (v << 2) | (v >> 4)


def _palette_planes(cw, always4):
    """palette_planes: the (r, g, b) planes of the color words."""
    c0, c1 = cw & 0xFFFF, cw >> 16
    e0 = [_ext5(c0 >> 11), _ext6((c0 >> 5) & 63), _ext5(c0 & 31)]
    e1 = [_ext5(c1 >> 11), _ext6((c1 >> 5) & 63), _ext5(c1 & 31)]
    four = always4 | (c0 > c1)
    has_v3 = four | (c0 == c1)
    planes = []
    for v0, v1 in zip(e0, e1):
        v2 = np.where(four, (2 * v0 + v1) // 3, (v0 + v1) // 2)
        v3 = np.where(has_v3, (v0 + 2 * v1) // 3, 0)
        planes.append(v0 | (v1 << 8) | (v2 << 16) | (v3 << 24))
    return planes


def _color_selectors(iw):
    """color_selectors: selector y holds row y's four 2-bit codes."""
    sel = []
    for h in (0, 1):
        x = _byte_perm(iw, 0, 0x4342 if h else 0x4140)
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        sel += [x, x >> 16]
    return sel


def _alpha_ramp(w0):
    """decode_alpha's 8-entry ramp, (N, 8)."""
    a0, a1 = w0 & 255, (w0 >> 8) & 255
    six = [a0, a1] + [((7 - k) * a0 + k * a1) // 7 for k in range(1, 7)]
    four = ([a0, a1] + [((5 - k) * a0 + k * a1) // 5 for k in range(1, 5)]
            + [0 * a0, 0 * a0 + 255])
    return np.where((a0 > a1)[:, None], np.stack(six, 1), np.stack(four, 1))


def _alpha_selectors(half):
    """alpha_selectors: 3-bit codes at bit 3n spread into nibble n."""
    x = (half & 0xFFF) | ((half << 4) & 0x0FFF0000)
    x = (x & 0x003F003F) | ((x << 2) & 0x3F003F00)
    return (x & 0x07070707) | ((x << 1) & 0x70707070)


def _rows(data, is_dxt1):
    """The kernel's row words of each block: (N, 3 | 4 channels, 4 rows),
    byte x of row y the channel of pixel (y, x)."""
    w = _words(data)
    cw, iw = (w[:, 0], w[:, 1]) if is_dxt1 else (w[:, 2], w[:, 3])
    sel = _color_selectors(iw)
    rows = [[_byte_perm(p, 0, s) for s in sel]
            for p in _palette_planes(cw, not is_dxt1)]
    if not is_dxt1:
        ramp = _alpha_ramp(w[:, 0])
        lo, hi = _pack4(ramp[:, :4]), _pack4(ramp[:, 4:])
        half0 = ((w[:, 0] >> 16) & 0xFFFF) | ((w[:, 1] & 255) << 16)
        half1 = (w[:, 1] >> 8) & 0xFFFFFF
        s01, s23 = _alpha_selectors(half0), _alpha_selectors(half1)
        rows.append([_byte_perm(lo, hi, s)
                     for s in (s01, s01 >> 16, s23, s23 >> 16)])
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=1)


def _quads(rows, form):
    """quad_pair on each channel: (N, C, 4 rows) row words -> (N, C, 2, 2)
    destination pixels (j, i) of the block's quadrant."""
    out = np.zeros(rows.shape[:2] + (2, 2), np.int64)
    for j in (0, 1):
        top, bottom = rows[..., 2 * j], rows[..., 2 * j + 1]
        if form == "dp4a":
            for i, m in enumerate((0x00000101, 0x01010000)):
                out[..., j, i] = (_dot(top, m) + _dot(bottom, m)) >> 2
        else:
            s = ((top & 0x00FF00FF) + _byte_perm(top, 0, 0x4341)
                 + (bottom & 0x00FF00FF) + _byte_perm(bottom, 0, 0x4341))
            out[..., j, 0] = (s & 0xFFFF) >> 2
            out[..., j, 1] = s >> 18
    return out


def _averaged(data, nby, nbx, is_dxt1, form):
    """The modelled decode + 2x2 average of an (nby, nbx) block grid: the
    (2 nby, 2 nbx, 3 | 4) uint8 image."""
    q = _quads(_rows(data, is_dxt1), form)
    c = q.shape[1]
    img = q.reshape(nby, nbx, c, 2, 2).transpose(0, 3, 1, 4, 2)
    return img.reshape(2 * nby, 2 * nbx, c).astype(np.uint8)


def _payload(rng, kind, is_dxt1, n):
    """(n, 8 | 16) uint8 blocks: random bytes, or blocks of edge_words'
    set (all of it first where n allows)."""
    if kind == "random":
        return rng.integers(0, 256, (n, 8 if is_dxt1 else 16), dtype=np.uint8)
    edge = edge_words(is_dxt1)
    pick = np.concatenate([rng.permutation(len(edge)),
                           rng.integers(0, len(edge), max(0, n - len(edge)))])
    return edge[pick[:n]]


def test_edge_words_take_every_branch():
    d1 = _words(edge_words(True))
    c0, c1 = d1[:, 0] & 0xFFFF, d1[:, 0] >> 16
    assert (c0 > c1).any() and (c0 < c1).any() and (c0 == c1).any()
    assert (d1[:, 1] == 0xFFFFFFFF).any()
    d5 = _words(edge_words(False))
    a0, a1 = d5[:, 0] & 255, (d5[:, 0] >> 8) & 255
    assert (a0 > a1).any() and (a0 < a1).any() and (a0 == a1).any()
    field = (d5[:, 0] >> 16) | (d5[:, 1] << 16)
    codes = np.stack([(field >> (3 * p)) & 7 for p in range(16)], axis=1)
    for code in (6, 7):  # a block with the code in every row
        assert (codes.reshape(-1, 4, 4) == code).any(axis=2).all(axis=1).any()
    assert len(np.unique(edge_words(False), axis=0)) == len(d5) == 35 * 56


@pytest.mark.parametrize("payload", ["random", "edge words"])
@pytest.mark.parametrize("is_dxt1", [True, False])
def test_byte_plane_decode_matches_twin(rng, is_dxt1, payload):
    """Byte-plane palettes and ramps, looked up by byte permutes with the
    nibble-spread selectors, equal the twin's decode channel by channel."""
    data = _payload(rng, payload, is_dxt1, 2048)
    got = _bytes4(_rows(data, is_dxt1)).transpose(0, 2, 3, 1)
    got = got.reshape(len(data), 16, -1)
    want = (dxt.decode_dxt1_blocks(_t(data)) if is_dxt1
            else dxt.decode_dxt5_blocks(_t(data)))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("form", _FORMS)
@pytest.mark.parametrize("payload", ["random", "edge words"])
@pytest.mark.parametrize("is_dxt1", [True, False])
def test_quad_sums_match_twin_average(rng, is_dxt1, payload, form):
    """Both 2x2 sum forms on the row words equal average_2x2 of the twin's
    decode."""
    nby = nbx = 64
    data = _payload(rng, payload, is_dxt1, nby * nbx)
    got = _averaged(data, nby, nbx, is_dxt1, form)
    if is_dxt1:
        dec = dxt_cuda.dxt1_decode_plain(_t(data), 4 * nby, 4 * nbx)[:, :, :3]
    else:
        dec = dxt_cuda.dxt5_decode_plain(_t(data), 4 * nby, 4 * nbx)
    np.testing.assert_array_equal(got, dxt_cuda.average_2x2(dec).numpy())


@pytest.mark.parametrize("nby,nbx", [(4, 6), (64, 64)])
@pytest.mark.parametrize("payload", ["random", "edge words"])
@pytest.mark.parametrize("is_dxt1", [True, False])
def test_modelled_level_matches_twin_and_texcomp(rng, is_dxt1, payload, nby,
                                                 nbx):
    """The modelled front half followed by the twin's encode equals the
    twin's fused level and texcomp's Pallas kernel in interpret mode."""
    bs = 8 if is_dxt1 else 16
    data = _payload(rng, payload, is_dxt1, nby * nbx)
    avg = _t(_averaged(data, nby, nbx, is_dxt1, "dp4a"))
    enc = dxt_cuda.dxt1_encode_plain if is_dxt1 else dxt_cuda.dxt5_encode_plain
    got = enc(avg, 2 * nby, 2 * nbx).numpy()
    plain = dxt_cuda.dxtc_downsample_plain(_t(data), nby, nbx, is_dxt1)
    np.testing.assert_array_equal(got, plain.numpy())
    want = dp.dxtc_downsample_encode_words(
        dp.blocks_to_words(jnp.asarray(data), bs // 4), nby=nby, nbx=nbx,
        is_dxt1=is_dxt1, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(dp.words_to_blocks(want)))
