"""texcomp_torch's quality="high" DXT1/DXT5 codec against texcomp's.

The same seeded numpy blocks go through ``texcomp.codecs.dxt_hq`` on the
CPU (its jnp routes: the cluster fit's iterated argmax, the reference
encoder's jnp codec) and through ``texcomp_torch.codecs.dxt_hq`` on CPU
tensors (the plain twins). Tolerance 0: bytes equal, floats bit for bit.
The cluster-fit twin is also held to texcomp's Pallas kernel in interpret
mode. The image entries and ``DxtcCompressor("high")`` are in
test_torch_dxt_hq_image.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texcomp.codecs import dxt as jdxt
from texcomp.codecs import dxt_hq as jhq
from texcomp.ops import dxt_pallas as dp
from texcomp_torch.codecs import dxt as tdxt
from texcomp_torch.codecs import dxt_hq as thq
from texcomp_torch.ops import dxt_hq_cuda

N = 256  # texcomp's API bucket: one jit shape per entry point


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _hq_blocks(seed, n=N, c=3):
    """Random blocks with the ties the search must break alike: solid
    blocks, 2-value blocks, duplicated halves, a gradient ramp, and for
    c == 4 constant, 0/255 and 0/255-with-interior alpha."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (n, 16, c))
    px[:24] = px[:24, :1]
    two = rng.integers(0, 2, (24, 16, 1))
    px[24:48] = np.where(two == 1, px[24:48, :1], px[24:48, 1:2])
    px[48:72, 8:] = px[48:72, :8]
    px[72:96] = (np.arange(16)[None, :, None] * 16
                 + rng.integers(0, 16, (24, 1, c)))
    if c == 4:
        px[96:120, :, 3] = px[96:120, :1, 3]
        px[120:144, :, 3] = rng.integers(0, 2, (24, 16)) * 255
        px[144:168, :, 3] = np.where(rng.integers(0, 3, (24, 16)) == 0, 0,
                                     rng.integers(0, 256, (24, 16)))
    return np.clip(px, 0, 255).astype(np.int32)


@pytest.fixture(scope="module")
def rgb():
    return _hq_blocks(11)


@pytest.fixture(scope="module")
def rgba():
    return _hq_blocks(12, c=4)


def test_cluster_tables_match_texcomp():
    """965 partitions, the same cuts and constants as texcomp's tables."""
    cuts = thq._CF_CUTS
    assert cuts.shape == (965, 3) == (jhq._CF_SEL.shape[1], 3)
    sel = np.zeros((17, cuts.shape[0]), np.float32)
    for k in range(3):
        np.add.at(sel, (cuts[:, k], np.arange(cuts.shape[0])), 1.0)
    np.testing.assert_array_equal(sel, jhq._CF_SEL)
    for ours, theirs in ((thq._CF_QUU, jhq._CF_QUU), (thq._CF_QUT, jhq._CF_QUT),
                         (thq._CF_QTT, jhq._CF_QTT),
                         (thq._CF_ALPHA, jhq._CF_ALPHA),
                         (thq._CF_BETA, jhq._CF_BETA),
                         (thq._CF_DELTA, jhq._CF_DELTA)):
        np.testing.assert_array_equal(_bits(ours), _bits(theirs))


def test_cf_device_tables_match_texcomp():
    """The kernel's constants are texcomp's qtab columns, unpadded, with
    -0.0 stored as the +0.0 texcomp's one-hot pick gives."""
    _, qtab = thq._cf_tables_np()
    _, jqtab = jhq._cf_device_tables()
    p = qtab.shape[0]
    for ours, theirs in zip(range(9), (0, 1, 2, 3, 4, 5, 8, 9, 10)):
        np.testing.assert_array_equal(_bits(qtab[:, ours]),
                                      _bits(jqtab[:p, theirs] + 0.0))
    assert (_bits(jqtab[:p, 9]) == _bits(-0.0)).any()


def test_split_bf16_matches_texcomp():
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    x *= np.float32(10.0) ** np.random.default_rng(4).integers(-6, 9, 4096)
    for ours, theirs in zip(thq._split_bf16(x), jhq._split_bf16(x)):
        np.testing.assert_array_equal(_bits(ours), _bits(theirs))
    np.testing.assert_array_equal(_bits(thq._round_bf16(x)),
                                  _bits(jhq._round_bf16(x)))


@pytest.mark.parametrize("fn", ["_det_recip", "_det_rsqrt"])
def test_newton_matches_texcomp(fn):
    """The Newton reciprocal and rsqrt, bit for bit, over [1e-12, 1e17],
    against texcomp's function run op by op: each product and difference
    rounded on its own, as its barriers intend (see
    test_port_follows_texcomp_op_by_op_arithmetic)."""
    rng = np.random.default_rng(5)
    x = (10.0 ** rng.uniform(-12, 17, 20000)).astype(np.float32)
    x[:64] = np.arange(1, 65)
    with jax.disable_jit():
        want = np.asarray(getattr(jhq, fn)(jnp.asarray(x)))
    got = getattr(thq, fn)(_t(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


# Blocks on which texcomp's jitted CPU encode differs from its own op-by-op
# arithmetic: XLA on the CPU drops optimization_barrier before fusion, and
# LLVM then contracts a multiply and an add into an FMA (in _det_recip's
# Newton step, among others). texcomp's barriers intend the op-by-op
# result, and the port computes it on every device. Found among 16,384
# random and near-solid blocks: 2 such DXT1 blocks, 10 DXT5.
_CONTRACTED_DXT1 = np.array([
    [232, 28, 224, 249, 22, 220, 251, 39, 241, 249, 18, 232, 236, 21, 241,
     234, 42, 243, 250, 30, 221, 247, 27, 228, 231, 22, 239, 247, 41, 239,
     249, 34, 219, 240, 32, 240, 249, 20, 239, 238, 37, 227, 253, 42, 229,
     242, 39, 228],
    [208, 54, 86, 176, 170, 240, 133, 119, 41, 4, 178, 57, 28, 102, 47, 126,
     250, 62, 10, 242, 178, 40, 127, 229, 206, 5, 51, 58, 135, 122, 5, 19,
     215, 85, 67, 146, 192, 125, 227, 90, 171, 168, 155, 84, 236, 233, 167,
     241]], np.int32).reshape(2, 16, 3)
_CONTRACTED_DXT5 = np.array([
    [255, 93, 2, 245, 255, 93, 0, 242, 253, 103, 0, 232, 255, 114, 9, 233,
     255, 114, 9, 227, 248, 92, 12, 241, 244, 96, 4, 255, 255, 94, 6, 236,
     250, 93, 13, 239, 247, 94, 0, 255, 255, 111, 3, 255, 244, 113, 0, 243,
     245, 111, 7, 230, 254, 107, 0, 238, 248, 114, 6, 238, 250, 109, 8, 255],
    [88, 175, 94, 166, 34, 37, 198, 239, 2, 61, 167, 103, 130, 4, 62, 136,
     163, 29, 76, 15, 141, 60, 183, 25, 9, 17, 19, 110, 78, 158, 156, 154,
     162, 156, 125, 4, 242, 52, 28, 61, 195, 244, 179, 176, 125, 160, 195,
     62, 36, 214, 210, 106, 5, 141, 171, 250, 226, 163, 40, 215, 249, 115,
     208, 226]], np.int32).reshape(2, 16, 4)


def test_port_follows_texcomp_op_by_op_arithmetic():
    """On the blocks above the port equals texcomp run op by op."""
    outside = np.zeros(2, bool)
    with jax.disable_jit():
        want1 = np.asarray(jhq._encode_dxt1_hq(jnp.asarray(_CONTRACTED_DXT1),
                                               False))
        want5 = np.asarray(jhq._encode_dxt5_hq(jnp.asarray(_CONTRACTED_DXT5),
                                               jnp.asarray(outside), False))
    np.testing.assert_array_equal(
        thq.encode_dxt1_hq_blocks(_t(_CONTRACTED_DXT1)).numpy(), want1)
    np.testing.assert_array_equal(
        thq.encode_dxt5_hq_blocks(_t(_CONTRACTED_DXT5), _t(outside)).numpy(),
        want5)


def test_cf_score_matches_texcomp():
    """The contraction-immune score tree, bit for bit."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 450_000_000, (64, 1), dtype=np.int32)
    b = rng.integers(0, 150_000_000, (64, 1), dtype=np.int32)
    ptt = rng.integers(0, 50_000_000, (64, 1), dtype=np.int32)
    _, qtab = thq._cf_tables_np()
    q = [qtab[None, :, j] for j in range(6)]
    want = np.asarray(dp.cf_score(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(ptt), *map(jnp.asarray, q)))
    got = dxt_hq_cuda.cf_score(_t(a), _t(b), _t(ptt), *map(_t, q)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pca_project_matches_texcomp(rgb):
    want = jhq._pca_project(jnp.asarray(rgb).astype(jnp.float32))
    got = thq._pca_project(_t(rgb))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_cluster_topk4_twin_matches_pallas_kernel(rgb):
    """The twin's (N, 4, 6) payload equals texcomp's _cf_topk_kernel run in
    interpret mode on the same prefix sums, bit for bit: same picks, same
    order, ties to the lower partition."""
    tb = _t(rgb)
    prefix = thq._prefix_sums(tb, thq._pca_project(tb)[2])
    cuts, qtab = thq._cf_device_tables(torch.device("cpu"))
    got = dxt_hq_cuda.cluster_topk4_plain(prefix, cuts, qtab).numpy()
    p72 = np.zeros((3, 24, N), np.float32)
    p72[:, :17] = prefix.numpy().transpose(2, 1, 0)
    selt, jqtab = jhq._cf_device_tables()
    want = np.asarray(dp.cluster_topk4(jnp.asarray(p72.reshape(72, N)),
                                       jnp.asarray(selt), jnp.asarray(jqtab),
                                       interpret=True))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(want.reshape(4, 6, N).transpose(2, 0, 1)))


def test_prefix_sums_match_texcomp_ranks(rgb):
    """Row r is the sum of the r pixels of largest projection, ties to the
    lower index: texcomp's masked-rank sums."""
    t = thq._pca_project(_t(rgb))[2].numpy()
    order = np.argsort(-t, axis=1, kind="stable")
    want = np.concatenate([np.zeros((N, 1, 3), np.int64), np.cumsum(
        np.take_along_axis(rgb, order[:, :, None], axis=1), axis=1)], axis=1)
    np.testing.assert_array_equal(thq._prefix_sums(_t(rgb), _t(t)).numpy(), want)


def test_cluster_fit_candidates_match_texcomp():
    """The endpoint candidates through the twin equal texcomp's jnp route
    (twin of test_pallas.py's cluster_topk4 test): random, constant and
    2-value blocks."""
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (700, 16, 3)).astype(np.int32)
    rgb[:40] = rgb[:40, :1, :]
    rgb[40:80, 8:] = rgb[40:80, :8]
    want = jhq._cluster_fit_candidates(jnp.asarray(rgb).astype(jnp.float32))
    tb = _t(rgb)
    got = thq._cluster_fit_candidates(tb, thq._pca_project(tb)[2])
    for (wc0, wc1), (gc0, gc1) in zip(want, got):
        np.testing.assert_array_equal(gc0.numpy(), np.asarray(wc0))
        np.testing.assert_array_equal(gc1.numpy(), np.asarray(wc1))


def test_cluster_fit_chunked_matches_single_chunk(rgb, monkeypatch):
    tb = _t(rgb)
    t = thq._pca_project(tb)[2]
    whole = thq._cluster_fit_candidates(tb, t)
    monkeypatch.setattr(thq, "_CLUSTER_CHUNK", 37)
    for (a0, a1), (b0, b1) in zip(whole, thq._cluster_fit_candidates(tb, t)):
        assert torch.equal(a0, b0) and torch.equal(a1, b1)


@pytest.mark.parametrize("swap", [False, True])
def test_encode_dxt1_hq_blocks_matches_texcomp(rgb, swap):
    want = np.asarray(jhq.encode_dxt1_hq_blocks(jnp.asarray(rgb),
                                                swap_red_and_blue=swap))
    got = thq.encode_dxt1_hq_blocks(_t(rgb), swap).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("swap", [False, True])
def test_encode_dxt5_hq_blocks_matches_texcomp(rgba, swap):
    """Flagged has_one_pixel blocks keep their reference alpha rule."""
    outside = np.zeros(N, bool)
    outside[200:216] = True
    want = np.asarray(jhq.encode_dxt5_hq_blocks(
        jnp.asarray(rgba), jnp.asarray(outside), swap_red_and_blue=swap))
    got = thq.encode_dxt5_hq_blocks(_t(rgba), _t(outside), swap).numpy()
    np.testing.assert_array_equal(got, want)


def _dxt1_errors(blocks, data):
    dec = tdxt.decode_dxt1_blocks(_t(data)).numpy()
    return ((dec - blocks) ** 2).sum(axis=(1, 2))


def test_hq_blocks_never_worse_than_reference(rgb):
    """Per block the HQ decoded error is at most the reference's, and
    strictly less on most random blocks (twin of test_dxt_hq.py)."""
    hq = thq.encode_dxt1_hq_blocks(_t(rgb)).numpy()
    ref = tdxt.encode_dxt1_blocks(_t(rgb)).numpy()
    e_hq, e_ref = _dxt1_errors(rgb, hq), _dxt1_errors(rgb, ref)
    assert np.all(e_hq <= e_ref)
    assert np.sum(e_hq < e_ref) > N // 4


def test_hq_alpha_never_worse(rgba):
    """The HQ alpha half decodes no worse than the reference's, per block."""
    outside = torch.zeros(N, dtype=torch.bool)
    hq = thq.encode_dxt5_hq_blocks(_t(rgba), outside).numpy()
    ref = tdxt.encode_dxt5_blocks(_t(rgba), outside).numpy()
    a = rgba[:, :, 3]

    def alpha_err(data):
        dec = tdxt.decode_dxt5_blocks(_t(data)).numpy()[:, :, 3]
        return ((dec - a) ** 2).sum(axis=1)

    assert np.all(alpha_err(hq) <= alpha_err(ref))
    assert np.sum(alpha_err(hq) < alpha_err(ref)) > 0


def test_hq_payloads_decode_like_texcomp(rgb):
    """The HQ payload decodes to the same pixels under both packages'
    standard decoders (it is plain DXT1)."""
    hq = thq.encode_dxt1_hq_blocks(_t(rgb)).numpy()
    np.testing.assert_array_equal(
        tdxt.decode_dxt1_blocks(_t(hq)).numpy(),
        np.asarray(jdxt.decode_dxt1_blocks(jnp.asarray(hq))))


def test_empty_batch():
    assert thq.encode_dxt1_hq_blocks(torch.zeros((0, 16, 3))).shape == (0, 8)
    assert thq.encode_dxt5_hq_blocks(torch.zeros((0, 16, 4)),
                                     torch.zeros(0, dtype=torch.bool)).shape == (0, 16)


# ---------------------------------------------------------------------------
# The CUDA kernel's decomposition of the cluster-fit top 4 (csrc/dxt_hq.cu):
# eight warps each keep the top 4 of a contiguous slice of the table, and
# warp 0 merges their lists.
# ---------------------------------------------------------------------------

_WARPS = 8


def _kernel_order_topk4(prefix, cuts, qtab):
    """cluster_topk4 as the kernel splits it: the table cut into 8
    contiguous slices of ceil(P / 8) rows, in each a strict '>' insertion
    into 4 sorted slots in table order (empty slots -inf), then the 8 lists
    merged by (score descending, index ascending). (N, 4, 6) float32."""
    p = prefix.to(torch.int32)
    pt = p[:, 16, :]
    uc = [p[:, cuts[:, 0], c] + p[:, cuts[:, 1], c] + p[:, cuts[:, 2], c]
          for c in range(3)]
    a_i = uc[0] * uc[0] + uc[1] * uc[1] + uc[2] * uc[2]
    b_i = pt[:, 0:1] * uc[0] + pt[:, 1:2] * uc[1] + pt[:, 2:3] * uc[2]
    ptt_i = (pt * pt).sum(dim=1, dtype=torch.int32)[:, None]
    score = dxt_hq_cuda.cf_score(a_i, b_i, ptt_i,
                                 *[qtab[None, :, j] for j in range(6)]).numpy()
    n, parts = score.shape
    per = -(-parts // _WARPS)
    lists_s, lists_q = [], []
    for w in range(_WARPS):
        top_s = np.full((n, 4), -np.inf, np.float32)
        top_q = np.full((n, 4), np.iinfo(np.int32).max, np.int64)
        for q in range(w * per, min(parts, (w + 1) * per)):
            ins = score[:, q] > top_s[:, 3]
            top_s[ins, 3] = score[ins, q]
            top_q[ins, 3] = q
            for k in (3, 2, 1):
                up = top_s[:, k] > top_s[:, k - 1]
                for t in (top_s, top_q):
                    lo, hi = t[:, k].copy(), t[:, k - 1].copy()
                    t[:, k], t[:, k - 1] = np.where(up, hi, lo), np.where(up, lo, hi)
        lists_s.append(top_s)
        lists_q.append(top_q)
    s = np.concatenate(lists_s, axis=1)
    q = np.concatenate(lists_q, axis=1)
    pick = np.take_along_axis(q, np.lexsort((q, -s), axis=1)[:, :4], axis=1)
    assert (pick < parts).all()
    pick = torch.from_numpy(pick)
    u = [torch.gather(c, 1, pick).to(torch.float32) for c in uc]
    return torch.cat([torch.stack(u, dim=2), qtab[pick, 6:9]], dim=2)


def _topk_blocks(kind):
    rng = np.random.default_rng({"solid": 41, "tied": 42, "random": 43}[kind])
    px = rng.integers(0, 256, (N, 16, 3))
    if kind == "solid":
        px[:] = px[:, :1]
    elif kind == "tied":  # two values per block, or duplicated halves
        two = rng.integers(0, 2, (N, 16, 1))
        px[: N // 2] = np.where(two[: N // 2] == 1, px[: N // 2, :1],
                                px[: N // 2, 1:2])
        px[N // 2:, 8:] = px[N // 2:, :8]
    return px.astype(np.int32)


@pytest.mark.parametrize("n_parts", [4, 13, 965])
@pytest.mark.parametrize("kind", ["solid", "tied", "random"])
def test_sliced_topk4_merge_matches_twin(kind, n_parts):
    """The kernel's split of the table over 8 warps, each slice's top 4
    merged by (score descending, index ascending), equals the twin's
    iterated first-occurrence argmax, bit for bit: also where slices are
    empty (4 rows) or short (13 rows), and on blocks full of ties."""
    tb = _t(_topk_blocks(kind))
    prefix = thq._prefix_sums(tb, thq._pca_project(tb)[2])
    cuts, qtab = thq._cf_device_tables(torch.device("cpu"))
    cuts, qtab = cuts[:n_parts], qtab[:n_parts]
    want = dxt_hq_cuda.cluster_topk4_plain(prefix, cuts, qtab)
    got = _kernel_order_topk4(prefix, cuts, qtab)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
