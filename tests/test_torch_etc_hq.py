"""texcomp_torch's quality="high" ETC1 encoder against texcomp's.

The same seeded numpy blocks go through ``texcomp.codecs.etc`` on the CPU
(its XLA route, ``_encode_etc1_hq_blocks_xla``, under jit) and through
``texcomp_torch.ops.etc_cuda.etc1_hq_encode_blocks`` on CPU tensors (the
one HQ driver, whose search there is the plain twin of the HQ search
kernel, ``texcomp_torch.codecs.etc``). The twin is also held to texcomp's
Pallas kernel ``etc1_hq_search`` in interpret mode on the same packed
candidates. Then
``EtcCompressor(quality="high")`` where the API tests do not reach: the
padded compress and the pad, which keeps the strategy's reference encoder.
Tolerance 0: bytes and words equal.
"""

import contextlib
import ctypes
import functools
import sys
from pathlib import Path
from types import SimpleNamespace

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
from texcomp_torch.ops import _launch, etc_cuda
from chip_smoke import etc_hq_tie_blocks

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
    """The whole HQ encode on a CPU tensor, through the search twin and no
    launch, equals texcomp's XLA route (twin of test_pallas.py's
    etc1_hq_search parity test)."""
    want = np.asarray(jetc.encode_etc1_hq_blocks(jnp.asarray(rgb)))
    _launch.reset_launches()
    got = etc_cuda.etc1_hq_encode_blocks(_t(rgb))
    assert sum(_launch.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(got.numpy(), want)


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
    hq = etc_cuda.etc1_hq_encode_blocks(_t(rgb))

    def err(data):
        dec = tetc.decode_etc1_blocks(data).numpy().astype(np.int64)
        return ((dec - rgb) ** 2).sum(axis=(1, 2))

    assert np.all(err(hq) <= err(ref))
    assert np.sum(err(hq) < err(ref)) > 50


def test_empty_batch():
    got = etc_cuda.etc1_hq_encode_blocks(torch.zeros((0, 16, 3)))
    assert got.shape == (0, 8) and got.dtype == torch.uint8


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


# ---------------------------------------------------------------------------
# The card's route: hq_search_kernel<flip, true> (csrc/etc.cu) fits the 40
# candidates of a flip inside the search launch. Its float tables, a numpy
# model of its lane order, and the dispatch that takes it.
# ---------------------------------------------------------------------------

_TABLES = (Path(__file__).resolve().parent.parent / "texcomp_torch" / "csrc"
           / "etc_hq_tables.cuh")


def _hq_tables_header() -> str:
    """csrc/etc_hq_tables.cuh as ``codecs.etc._enum_tables()`` gives it:
    every value a float32 written exactly."""
    _, mu, const, coef13, coef2 = tetc._enum_tables()

    def table(name, values):
        words = [f"{float(v)!r}f" for v in values]
        rows = [", ".join(words[i:i + 8]) for i in range(0, len(words), 8)]
        return (f"__device__ const float {name}[{len(values)}] = {{\n    "
                + ",\n    ".join(rows) + "};\n")

    return ("// Generated by `python -m tests.test_torch_etc_hq` from\n"
            "// texcomp_torch/codecs/etc._enum_tables(); do not edit.\n"
            "//\n"
            "// The float32 tables of the HQ ETC1 exhaustive cluster fit, each value\n"
            "// exact as written: per cut c of the 165 (0 <= p1 <= p2 <= p3 <= 8, in\n"
            "// that nesting) and codeword w, the modifier mean kHqMu[8 c + w] and the\n"
            "// error constant kHqConst[8 c + w]; per codeword the coefficients\n"
            "// kHqCoef13[w] = a - b and kHqCoef2[w] = -2 a.\n"
            "\n#pragma once\n\nnamespace {\n\n"
            + table("kHqMu", mu) + "\n" + table("kHqConst", const) + "\n"
            + table("kHqCoef13", coef13) + "\n" + table("kHqCoef2", coef2)
            + "\n}  // namespace\n")


def test_hq_tables_header_matches_enum_tables():
    """The kernel's copy of the exhaustive fit's tables is the twin's, bit
    for bit: the header is what the generator writes, and each literal
    parses back to the table's float32."""
    text = _TABLES.read_text()
    assert text == _hq_tables_header()
    _, mu, const, coef13, coef2 = tetc._enum_tables()
    for name, want in (("kHqMu", mu), ("kHqConst", const),
                       ("kHqCoef13", coef13), ("kHqCoef2", coef2)):
        body = text.split(f"float {name}[")[1].split("{", 1)[1].split("}", 1)[0]
        got = np.array([float(v.strip().rstrip("f")) for v in body.split(",")],
                       dtype=np.float32)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.astype(np.float32).view(np.int32))


_F = np.float32
_LANES = np.arange(8)
_BIG = np.iinfo(np.int32).max


def _quantize8(v, bits):
    i = v * ((1 << bits) - 1) + 128
    return (i + (i >> 8)) >> 8


def _pack_q(q555, q444):
    return (q555[..., 0] | (q555[..., 1] << 5) | (q555[..., 2] << 10)
            | (q444[..., 0] << 15) | (q444[..., 1] << 19) | (q444[..., 2] << 23))


def _quantize_real(b):
    """(..., 3) float32 bases -> their packed word (half to even)."""
    r = np.rint(b).astype(np.int64)
    return _pack_q(_quantize8(r, 5), _quantize8(r, 4)), _quantize8(r, 5), \
        _quantize8(r, 4)


def _lex_less(e, k, f, j):
    return (e < f) | ((e == f) & (k < j))


def _group_top2(e1, k1, e2, k2):
    """The kernel's group_top2: three xor-shuffle rounds over the (N, 8)
    lanes, each keeping the lexicographic two least of both lanes' pairs."""
    for o in (1, 2, 4):
        f1, j1, f2, j2 = (x[:, _LANES ^ o] for x in (e1, k1, e2, k2))
        take = _lex_less(f1, j1, e1, k1)
        keep1 = ~_lex_less(e1, k1, f2, j2)  # the partner's second wins
        s_e = np.where(take, np.where(keep1, f2, e1),
                       np.where(_lex_less(f1, j1, e2, k2), f1, e2))
        s_k = np.where(take, np.where(keep1, j2, k1),
                       np.where(_lex_less(f1, j1, e2, k2), j1, k2))
        e1, k1 = np.where(take, f1, e1), np.where(take, j1, k1)
        e2, k2 = s_e, s_k
    return e1, k1, e2, k2


def _group_min(e, k):
    for o in (1, 2, 4):
        f, j = e[:, _LANES ^ o], k[:, _LANES ^ o]
        take = _lex_less(f, j, e, k)
        e, k = np.where(take, f, e), np.where(take, j, k)
    return e, k


def _fit_model(rgb: np.ndarray, flip: bool) -> np.ndarray:
    """(40, 2, N) candidate words in the kernel's order of work (hq_fit):
    lane l of a block walks codeword l, keeping its own best (and runner-up)
    by strict '<' in cut order, and the 8 lanes merge by xor shuffles on
    lexicographic (error, index); float32 op by op."""
    n = len(rgb)
    px = rgb.astype(np.int64)
    x, y = np.arange(16) % 4, np.arange(16) // 4
    first = (y < 2) if flip else (x < 2)
    members = [np.where(first)[0], np.where(~first)[0]]
    parts, mu, const, coef13, coef2 = tetc._enum_tables()
    cb = tetc._codebook("cpu").numpy().astype(np.int64)  # (8, 4)
    out = np.zeros((40, 2, n), np.int64)
    sums = [px[:, m].sum(axis=1) for m in members]

    # 0-27: averages, their clamped deltas, the 24 probes of the rounded pair.
    avg = [s >> 3 for s in sums]
    out[0] = [_pack_q(a >> 3, a >> 4) for a in avg]
    r5, r4 = [_quantize8(a, 5) for a in avg], [_quantize8(a, 4) for a in avg]
    out[1] = [_pack_q(r5[0], r4[0]), _pack_q(r5[1], r4[1])]
    out[2] = [out[1, 0], _pack_q(np.clip(r5[1], r5[0] - 4, r5[0] + 3), r4[1])]
    out[3] = [_pack_q(np.clip(r5[0], r5[1] - 3, r5[1] + 4), r4[0]), out[1, 1]]
    for j in range(24):
        sb, ch, d, is555 = j // 12, (j % 12) // 4, (-1, 1)[(j % 4) // 2], j % 2 == 0
        q = [[r5[0].copy(), r4[0].copy()], [r5[1].copy(), r4[1].copy()]]
        f = q[sb][0 if is555 else 1]
        f[:, ch] = np.clip(f[:, ch] + d, 0, 31 if is555 else 15)
        out[4 + j] = [_pack_q(*q[0]), _pack_q(*q[1])]

    # 34-39: the exhaustive fit, lane = codeword.
    mean, cum = [], []
    for s in (0, 1):
        m = sums[s].astype(_F) * _F(0.125)
        sub = px[:, members[s]].astype(_F)
        t = ((sub[..., 0] - m[:, None, 0]) + (sub[..., 1] - m[:, None, 1])) \
            + (sub[..., 2] - m[:, None, 2])
        c = np.concatenate([np.zeros((n, 1), _F),
                            np.cumsum(np.sort(t, axis=1), axis=1, dtype=_F)], 1)
        mean.append(m)
        cum.append(c)
    mu2, const2 = mu.reshape(165, 8).T, const.reshape(165, 8).T  # (lane, cut)
    kidx = 8 * np.arange(165)[None, :] + _LANES[:, None]          # (lane, cut)

    def errs(c):  # (N, lane, cut)
        g13 = (c[:, parts[:, 0]] + c[:, parts[:, 2]])[:, None, :]
        g2 = c[:, parts[:, 1]][:, None, :]
        tm = g13 * coef13[None, :, None] + g2 * coef2[None, :, None]
        return const2[None] - _F(2) * tm

    win, w5, w4, ww, ws = [], [], [], [], []
    for s in (0, 1):
        e = errs(cum[s])
        e1 = np.full((n, 8), np.inf, _F)
        e2 = e1.copy()
        k1 = np.full((n, 8), _BIG)
        k2 = k1.copy()
        for c in range(165):  # each lane's walk
            v, k = e[:, :, c], kidx[None, :, c]
            better = v < e1
            mid = ~better & (v < e2)
            e2, k2 = np.where(better, e1, np.where(mid, v, e2)), \
                np.where(better, k1, np.where(mid, k, k2))
            e1, k1 = np.where(better, v, e1), np.where(better, k, k1)
        e1, k1, e2, k2 = _group_top2(e1, k1, e2, k2)
        assert (k1 == k1[:, :1]).all() and (k2 == k2[:, :1]).all()
        b1 = np.clip(mean[s] - mu[k1[:, 0]][:, None], _F(0), _F(255))
        b2 = np.clip(mean[s] - mu[k2[:, 0]][:, None], _F(0), _F(255))
        word, q5, q4 = _quantize_real(b1)
        win.append(b1)
        w5.append(q5)
        w4.append(q4)
        ww.append(word)
        ws.append(_quantize_real(b2)[0])
    out[34] = ww
    out[35] = ws

    def constrained(s, other, lo_off, hi_off):
        lo_c = np.clip(other + lo_off, 0, 31)
        hi_c = np.clip(other + hi_off, 0, 31)
        lo_v, hi_v = (lo_c * 8).astype(_F), (hi_c * 8 + 7).astype(_F)
        e = errs(cum[s])
        pen = None
        for ch in range(3):
            b_opt = mean[s][:, None, None, ch] - mu2[None]
            d = np.maximum(lo_v[:, None, None, ch] - b_opt, _F(0)) \
                + np.maximum(b_opt - hi_v[:, None, None, ch], _F(0))
            pen = d * d if pen is None else pen + d * d
        tot = e + _F(8) * pen
        best = np.full((n, 8), np.inf, _F)
        k = np.full((n, 8), _BIG)
        for c in range(165):
            take = tot[:, :, c] < best
            best, k = np.where(take, tot[:, :, c], best), \
                np.where(take, kidx[None, :, c], k)
        _, k = _group_min(best, k)
        b = np.minimum(np.maximum(mean[s] - mu[k[:, 0]][:, None], lo_v), hi_v)
        r = np.rint(b).astype(np.int64)
        return _pack_q(np.clip(_quantize8(r, 5), lo_c, hi_c), _quantize8(r, 4))

    out[36] = [ww[0], constrained(1, w5[0], -4, 3)]
    out[37] = [constrained(0, w5[1], -3, 4), ww[1]]
    out[38] = [ww[0], _pack_q(np.clip(w5[1], w5[0] - 4, w5[0] + 3), w4[1])]
    out[39] = [_pack_q(np.clip(w5[0], w5[1] - 3, w5[1] + 4), w4[0]), ww[1]]

    # 28-33: the alternating fit, lane = codeword, from three seeds.
    def split(s):
        sub = px[:, members[s]]
        lum = sub.sum(axis=2)
        hi = 8 * lum >= lum.sum(axis=1, keepdims=True)
        n_hi = hi.sum(axis=1)
        s_hi = (sub * hi[..., None]).sum(axis=1)
        hi_n, lo_n = np.maximum(n_hi, 1)[:, None], np.maximum(8 - n_hi, 1)[:, None]
        a = 8 * (s_hi * lo_n + (sums[s] - s_hi) * hi_n)
        b = 2 * hi_n * lo_n
        return ((2 * a + b) // (2 * b)).astype(_F) * _F(0.125)

    mods = cb.astype(_F)  # (lane, 4): a, b, -a, -b
    side = np.where(first, 0, 1)
    pxf = px.astype(_F)

    def mod_errs(base, p):  # base (N, lane, 3) -> (N, lane, 4)
        cand = np.clip(base[:, :, None, :] + mods[None, :, :, None], _F(0), _F(255))
        d = cand - pxf[:, None, None, p, :]
        return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]

    for seed, (s0, s1) in enumerate([(mean[0], mean[1]), (split(0), split(1)),
                                     (win[0], win[1])]):
        b = np.stack([np.broadcast_to(s0[:, None], (n, 8, 3)),
                      np.broadcast_to(s1[:, None], (n, 8, 3))], axis=2).copy()
        for _ in range(2):
            rsum = np.zeros((n, 8, 2, 3), np.int64)
            for p in range(16):
                e = mod_errs(b[:, :, side[p]], p)
                best, mod = e[..., 0], np.broadcast_to(cb[None, :, 0], (n, 8))
                for m in range(1, 4):
                    take = e[..., m] < best
                    best, mod = np.where(take, e[..., m], best), \
                        np.where(take, cb[None, :, m], mod)
                rsum[:, :, side[p]] += px[:, None, p, :] - mod[..., None]
            b = np.clip(rsum.astype(_F) * _F(0.125), _F(0), _F(255))
        e16 = [mod_errs(b[:, :, side[p]], p).min(axis=2) for p in range(16)]
        for w in (8, 4, 2, 1):
            e16 = [e16[k] + e16[k + w] for k in range(w)]
        e1, k1, e2, k2 = _group_top2(e16[0], np.broadcast_to(_LANES, (n, 8)),
                                     np.full((n, 8), np.inf, _F),
                                     np.full((n, 8), _BIG))
        for r, k in enumerate((k1[:, 0], k2[:, 0])):
            bases = b[np.arange(n), k]  # (N, 2, 3): the winning lane's
            out[28 + 2 * seed + r] = [_quantize_real(bases[:, 0])[0],
                                      _quantize_real(bases[:, 1])[0]]
    return out


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("blocks", ["rgb", "ties"])
def test_kernel_fit_model_matches_candidate_words(rgb, blocks, flip):
    """The kernel's lane order of the fit (per-lane codeword walks, the
    shuffle merges on lexicographic (error, index) for the exhaustive top 2,
    the re-solves and the alternating best and runner-up) gives
    hq_candidate_words word for word, on random blocks and on blocks where
    codewords, cuts and flips tie."""
    px = rgb if blocks == "rgb" else etc_hq_tie_blocks(96)
    got = _fit_model(px, flip)
    want = tetc.hq_candidate_words(_t(px), flip).numpy()
    np.testing.assert_array_equal(got, _u32(want))


class _FakeCard:
    """Stands in for the card under ``_launch.launch``: the C entries the
    HQ encode may call, each recorded; the fit entry writes the plain
    result of its flip, precomputed, into ``out``."""

    def __init__(self, results):
        self.results = results
        self.calls = []

    def texcomp_etc1_hq_fit_search(self, px, n, flip, out, stream):
        self.calls.append(("texcomp_etc1_hq_fit_search", n, flip))
        want = self.results[bool(flip)]
        ctypes.memmove(out, want.data_ptr(), want.numel() * 4)
        return 0

    def texcomp_etc1_hq_search(self, *args):
        self.calls.append(("texcomp_etc1_hq_search",) + args[1:2])
        return 0


def test_card_route_fits_candidates_in_the_kernel(rgb, monkeypatch):
    """On a CUDA tensor the HQ encode packs the pixels once and launches
    the fit entry once per flip, over every block, with no candidate
    tensor; hq_candidate_words never runs; LAUNCHES counts the launches;
    the bytes are the flip choice over the twin's results."""
    blocks = _t(rgb)
    pixels = etc_cuda.pack_pixels(blocks)
    results = {f: torch.stack(etc_cuda.etc1_hq_search_plain(pixels, None, f))
               for f in (False, True)}
    want = tetc.hq_pick_flip(results[False], results[True])
    card = _FakeCard(results)
    monkeypatch.setattr(etc_cuda, "_pick", lambda t, plain, cuda: cuda)
    monkeypatch.setattr(etc_cuda, "_check", lambda *a, **k: None)
    monkeypatch.setattr(_launch._build, "load", lambda: card)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))

    def no_candidates(*args):
        raise AssertionError("hq_candidate_words on the card's route")

    monkeypatch.setattr(tetc, "hq_candidate_words", no_candidates)
    _launch.reset_launches()
    got = etc_cuda.etc1_hq_encode_blocks(blocks)
    assert card.calls == [("texcomp_etc1_hq_fit_search", N, 0),
                          ("texcomp_etc1_hq_fit_search", N, 1)]
    assert _launch.LAUNCHES["etc1_hq_fit_search"] == 2
    assert sum(_launch.LAUNCHES.values()) == 2
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_search_is_the_only_device_seam(rgb, monkeypatch):
    """The HQ encode hands each flip, in turn, to etc1_hq_search over every
    block's packed pixels with no candidates, and picks the flip from what
    it returns: the search is all that differs by device."""
    pixels = etc_cuda.pack_pixels(_t(rgb))
    idx = torch.arange(N, dtype=torch.int32)
    results = {False: (idx, idx + 7, torch.full((N,), 6, dtype=torch.int32)),
               True: (idx + 1000, idx + 9, 4 + 3 * (idx % 2))}
    calls = []

    def search(px, cands, flip):
        calls.append((px, cands, flip))
        return results[flip]

    monkeypatch.setattr(etc_cuda, "etc1_hq_search", search)
    got = etc_cuda.etc1_hq_encode_blocks(_t(rgb))
    assert [(c, f) for _, c, f in calls] == [(None, False), (None, True)]
    assert all(torch.equal(px, pixels) for px, _, _ in calls)
    want = tetc.hq_pick_flip(results[False], results[True])
    assert torch.equal(got, want)
    assert not torch.equal(want, tetc.words_to_bytes(*results[False][:2]))


@pytest.mark.parametrize("flip", [False, True])
def test_fit_search_plain_twin_chunks(rgb, flip, monkeypatch):
    """The fit route's twin, etc1_hq_search_plain(pixels, None, flip): the
    search over hq_candidate_words, chunk by chunk alike."""
    pixels = etc_cuda.pack_pixels(_t(rgb))
    want = etc_cuda.etc1_hq_search_plain(
        pixels, tetc.hq_candidate_words(_t(rgb), flip), flip)
    monkeypatch.setattr(tetc, "ENCODE_CHUNK", 37)
    got = etc_cuda.etc1_hq_search_plain(pixels, None, flip)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fit_search_wrapper_refuses_cpu_tensor():
    """The fused route's wrapper launches on a CUDA tensor or raises, and
    counts no launch."""
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        etc_cuda.etc1_hq_search_cuda(torch.zeros((4, 16), dtype=torch.int32),
                                     None, True)
    assert _launch.LAUNCHES == before


if __name__ == "__main__":
    _TABLES.write_text(_hq_tables_header())
    print(f"wrote {_TABLES}", file=sys.stderr)
