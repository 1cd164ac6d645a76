"""texcomp_torch's quality="high" ETC1 encoder against texcomp's.

The same seeded numpy blocks go through ``texcomp.codecs.etc`` on the CPU
(its XLA route, ``_encode_etc1_hq_blocks_xla``, under jit) and through
``texcomp_torch.codecs.etc`` on CPU tensors (the plain twin of the HQ
search kernel). The twin is also held to texcomp's Pallas kernel
``etc1_hq_search`` in interpret mode on the same packed candidates. Then
``EtcCompressor(quality="high")`` where the API tests do not reach: the
padded compress and the pad, which keeps the strategy's reference encoder.
Tolerance 0: bytes and words equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import texcomp
import texcomp_torch
from texcomp.blocks import image_to_blocks
from texcomp.codecs import etc as jetc
from texcomp.ops import etc_pallas as ep
from texcomp_torch.codecs import etc as tetc
from texcomp_torch.core import colors as cc
from texcomp_torch.ops import etc_cuda

N = 256  # texcomp's API bucket: one jit shape for the block entry


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _hq_blocks(seed, n=N):
    """Random blocks with the cases the search must break alike: solid,
    transposed-symmetric (both flips tie), two-valued, split into a dark
    and a bright half (bases outside the differential window), and smooth
    ramps."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (n, 16, 3))
    px[:24] = px[:24, :1]
    sym = px[24:48].reshape(24, 4, 4, 3)
    upper = np.triu(np.ones((4, 4), bool))[None, :, :, None]
    px[24:48] = np.where(upper, sym, sym.transpose(0, 2, 1, 3)).reshape(
        24, 16, 3)
    two = rng.integers(0, 2, (24, 16, 1))
    px[48:72] = np.where(two == 1, px[48:72, :1], px[48:72, 1:2])
    left = (np.arange(16) % 4 < 2)[None, :, None]
    px[72:96] = np.where(left, rng.integers(0, 48, (24, 1, 3)),
                         rng.integers(208, 256, (24, 1, 3)))
    px[96:120] = (np.arange(16)[None, :, None] * 3
                  + rng.integers(0, 64, (24, 1, 3)))
    return np.clip(px, 0, 255).astype(np.int32)


@pytest.fixture(scope="module")
def rgb():
    return _hq_blocks(21)


@functools.partial(jax.jit, static_argnums=1)
def _texcomp_candidate_words(rgb, flip):
    """texcomp's packed candidates of one flip, as its Pallas route packs
    them: (K, 2, N) uint32."""
    return jnp.stack([jnp.stack([ep._pack_q_word(q[0], q[2]),
                                 ep._pack_q_word(q[1], q[3])])
                      for q in jetc._hq_base_candidates(rgb, flip)])


def test_pack_q_words_match_texcomp():
    rng = np.random.default_rng(2)
    q555 = [rng.integers(0, 32, 500).astype(np.int32) for _ in range(3)]
    q444 = [rng.integers(0, 16, 500).astype(np.int32) for _ in range(3)]
    want = ep._pack_q_word([jnp.asarray(v) for v in q555],
                           [jnp.asarray(v) for v in q444])
    got = tetc.pack_q_word([_t(v) for v in q555], [_t(v) for v in q444])
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
    w2 = _t(np.roll(_u32(want), 7).astype(np.uint32).view(np.int32))
    for ours, theirs in zip(tetc.unpack_q_words(got, w2), ep._unpack_q_words(
            want, jnp.asarray(np.roll(np.asarray(want), 7)))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("flip", [False, True])
def test_candidate_words_match_texcomp(rgb, flip):
    """The 40 candidates per flip, in order (the tie-break order): averages,
    Blinn rounding, clamped deltas, +-1 probes, both cluster fits."""
    want = _texcomp_candidate_words(jnp.asarray(rgb), flip)
    got = tetc.hq_candidate_words(_t(rgb), flip)
    assert got.shape == (40, 2, N)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))


@pytest.mark.parametrize("flip", [False, True])
def test_refit_bases_match_texcomp(rgb, flip):
    """The least-squares refit from the modifiers of arbitrary words."""
    rng = np.random.default_rng(3 + flip)
    hi = rng.integers(0, 2**32, N, dtype=np.uint32)
    lo = rng.integers(0, 2**32, N, dtype=np.uint32)
    want = jax.jit(jetc._refit_bases, static_argnums=1)(
        jnp.asarray(rgb), flip, jnp.asarray(hi), jnp.asarray(lo))
    got = tetc._refit_bases(_t(rgb), flip, _t(hi.view(np.int32)),
                            _t(lo.view(np.int32)))
    for ours, theirs in zip(got, want):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_neighborhood_order_matches_texcomp():
    """The 24 probes in texcomp's order: subblock, channel, -1 then +1,
    555 then 444; clamped at the ends of each range."""
    rng = np.random.default_rng(4)
    q = []
    for top in (31, 31, 15, 15):
        v = [rng.integers(0, top + 1, 64).astype(np.int32) for _ in range(3)]
        v[0][:8] = 0
        v[1][8:16] = top
        q.append(v)
    want = jetc._neighborhood_qs([[jnp.asarray(c) for c in v] for v in q],
                                 ("555", "444"))
    got = tetc._neighborhood_qs([[_t(c) for c in v] for v in q])
    assert len(got) == len(want) == tetc.HQ_PROBES
    for ours, theirs in zip(got, want):
        for a, b in zip(ours, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("flip", [False, True])
def test_hq_search_twin_matches_pallas_kernel(flip):
    """The search twin's (hi, lo, err) equals texcomp's _etc1_hq_kernel run
    in interpret mode on the same candidates: the candidates, two chained
    refits, the 24 probes around refit 1's bases, strict '<'."""
    rgb = _hq_blocks(31, 128)
    cands = tetc.hq_candidate_words(_t(rgb), flip)
    words = (rgb[:, :, 0] | (rgb[:, :, 1] << 8)
             | (rgb[:, :, 2] << 16)).astype(np.uint32).T  # (16, N)
    if not flip:  # texcomp's kernel reads the unflipped pixels permuted
        words = words[np.asarray(ep._PERM_F)]
    want = ep.etc1_hq_search(jnp.asarray(words),
                             jnp.asarray(_u32(cands.numpy()).astype(np.uint32)),
                             flip, interpret=True)
    got = etc_cuda.etc1_hq_search(etc_cuda.pack_pixels(_t(rgb)), cands, flip)
    np.testing.assert_array_equal(_u32(got[0].numpy()), _u32(want[0]))
    np.testing.assert_array_equal(_u32(got[1].numpy()), _u32(want[1]))
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(want[2]).astype(np.int32))


def test_encode_etc1_hq_blocks_matches_texcomp(rgb):
    """The whole HQ encode through the search twin equals texcomp's XLA
    route (twin of test_pallas.py's etc1_hq_search parity test)."""
    want = np.asarray(jetc.encode_etc1_hq_blocks(jnp.asarray(rgb)))
    np.testing.assert_array_equal(tetc.encode_etc1_hq_blocks(_t(rgb)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        etc_cuda.etc1_hq_encode_blocks(_t(rgb)).numpy(), want)


def test_hq_chunked_matches_single_chunk(rgb, monkeypatch):
    whole = tetc.encode_etc1_hq_blocks(_t(rgb))
    monkeypatch.setattr(tetc, "ENCODE_CHUNK", 37)
    assert torch.equal(tetc.encode_etc1_hq_blocks(_t(rgb)), whole)


def test_image_entry_matches_texcomp_blocks():
    """A 32x128 image (256 blocks) through the port's padded-image route
    equals texcomp's block entry on its blocks."""
    img = np.random.default_rng(5).integers(0, 256, (32, 128, 3), np.uint8)
    img[:16, :64] = img[0, 0]
    blocks = image_to_blocks(jnp.asarray(img)).astype(jnp.int32)
    want = np.asarray(jetc.encode_etc1_hq_blocks(blocks))
    got = etc_cuda.etc1_hq_encode_padded_image(_t(img), 32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_etc_hq_never_worse_and_better():
    """Per block the HQ decoded error is at most SMALLER_ERROR's, and less
    on many blocks (twin of test_etc.py's check)."""
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (600, 16, 3)).astype(np.int32)
    rgb[100:120] = (np.arange(16)[None, :, None] * 3
                    + rng.integers(0, 64, (20, 1, 3))).astype(np.int32)
    ref = tetc.encode_etc1_blocks(_t(rgb), tetc.SMALLER_ERROR)
    hq = tetc.encode_etc1_hq_blocks(_t(rgb))

    def err(data):
        dec = tetc.decode_etc1_blocks(data).numpy().astype(np.int64)
        return ((dec - rgb) ** 2).sum(axis=(1, 2))

    assert np.all(err(hq) <= err(ref))
    assert np.sum(err(hq) < err(ref)) > 50


def test_empty_batch():
    assert tetc.encode_etc1_hq_blocks(torch.zeros((0, 16, 3))).shape == (0, 8)


# ---------------------------------------------------------------------------
# EtcCompressor(quality="high"): padded compress and pad.
# ---------------------------------------------------------------------------


def _image(seed, h, w):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    img[: h // 2, : w // 2] = img[0, 0]
    return img


def test_compress_and_pad_matches_texcomp():
    h, w = 10, 14
    buf = _image(7, h, w).tobytes()
    ji, ti = texcomp.CompressedImage(), texcomp_torch.CompressedImage()
    assert texcomp.EtcCompressor(quality="high").compress_and_pad(
        texcomp.Format.RGB, h, w, 24, 20, 0, buf, ji)
    assert texcomp_torch.EtcCompressor(quality="high", device="cpu").compress_and_pad(
        texcomp_torch.Format.RGB, h, w, 24, 20, 0, buf, ti)
    np.testing.assert_array_equal(ti.get_data(), ji.get_data())


@pytest.mark.parametrize("strategy", [2, 3])
def test_pad_keeps_the_reference_encoder(strategy):
    """pad re-encodes the edge blocks with the strategy's reference encoder
    whatever the quality, as texcomp does."""
    h, w = 12, 8
    buf = _image(8, h, w).tobytes()
    outs = []
    for pkg, kw in ((texcomp, {}), (texcomp_torch, {"device": "cpu"})):
        comp = pkg.EtcCompressor(pkg.CompressionStrategy(strategy),
                                 quality="high", **kw)
        src, out = pkg.CompressedImage(), pkg.CompressedImage()
        assert comp.compress(pkg.Format.RGB, h, w, 0, buf, src)
        assert comp.pad(src, 20, 16, out)
        outs.append(out.get_data())
    np.testing.assert_array_equal(outs[1], outs[0])


# ---------------------------------------------------------------------------
# The CUDA kernels' packed error (csrc/etc.cu's search, which the HQ search
# and the reference encode share): pixels and candidate colours as
# r | g << 8 | b << 16 words, the error |c|^2 - 2 c.p + |p|^2 from byte dot
# products. Each colour is clamped per channel; saturating bytes model that
# here, and tests/test_torch_etc.py holds the kernel's DPX form to clamp8.
# ---------------------------------------------------------------------------


def _pack(v):
    return v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16)


def _bytes(w):
    return np.stack([(w >> (8 * k)) & 255 for k in range(4)], axis=-1)


def _vaddus4(x, y):
    """__vaddus4: the four bytes added, each saturated at 255."""
    return _pack4(np.minimum(_bytes(x) + _bytes(y), 255))


def _vsubus4(x, y):
    """__vsubus4: the four bytes subtracted, each saturated at 0."""
    return _pack4(np.maximum(_bytes(x) - _bytes(y), 0))


def _pack4(b):
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _dp4a(x, y):
    """__dp4a on unsigned bytes: the dot product of the four bytes."""
    return (_bytes(x) * _bytes(y)).sum(axis=-1)


@pytest.mark.parametrize("bases", ["random", "0-8", "247-255"])
@pytest.mark.parametrize("cw", range(8))
def test_packed_error_matches_twin(cw, bases):
    """Per (pixel, modifier) the kernel's expanded error (|c|^2 - 2 c.p) +
    |p|^2, with c = base +- m saturated per byte, equals the twin's squared
    error against clamp8(base + m), and its first argmin over the four
    modifiers (without the |p|^2 the modifiers share) is the twin's."""
    rng = np.random.default_rng(50 + cw)
    n = 2048
    px = rng.integers(0, 256, (n, 3)).astype(np.int64)
    lo, hi = {"random": (0, 256), "0-8": (0, 9), "247-255": (247, 256)}[bases]
    base = rng.integers(lo, hi, (n, 3)).astype(np.int64)
    a, b = (int(v) for v in tetc._codebook("cpu")[cw, :2])
    splat = lambda m: m * 0x010101  # noqa: E731
    p, bw = _pack(px), _pack(base)
    colors = [_vaddus4(bw, splat(a)), _vaddus4(bw, splat(b)),
              _vsubus4(bw, splat(a)), _vsubus4(bw, splat(b))]
    partial = np.stack([_dp4a(c, c) - 2 * _dp4a(c, p) for c in colors], axis=1)
    got = partial + _dp4a(p, p)[:, None]

    cand = cc.clamp8(_t(base)[:, None, :] + tetc._codebook("cpu")[cw][None, :, None])
    want = ((cand - _t(px)[:, None, :]) ** 2).sum(dim=2)  # (n, 4)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(
        np.argmin(partial, axis=1), tetc._argmin_first(want, 1).numpy())
    if bases != "random":  # the clamp bites on these bases
        raw = base[:, None, :] + tetc._codebook("cpu")[cw].numpy()[None, :, None]
        assert ((raw < 0) | (raw > 255)).any()
