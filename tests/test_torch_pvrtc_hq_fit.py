"""The HQ PVRTC fit's kernels (``ops.pvrtc_hq_cuda``, ``csrc/pvrtc_hq.cu``):
the normal operator, the ordered dot and the hard blend weight.

On the CPU: the fit's route on a CUDA tensor (the C entries in order, each
counted, through a stand-in library that runs the twins), and PyTorch
models of the kernels' own orders and indexing (the dot's residue-class
passes, the normal operator's tile with its wrap halo, the choice's tile)
held to the twins bit for bit. On a card (``card``-marked tests): each
kernel against its twin, and the HQ encodes against the frozen plain
reference.

This file imports no JAX, so the tests marked ``card`` run on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_pvrtc_hq_fit.py
"""

import contextlib
import ctypes
import math
import re
import tokenize
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from texbench.reference import pvrtc_hq as frozen
from texcomp_torch.codecs import pvrtc_hq
from texcomp_torch.ops import _launch
from texcomp_torch.ops import pvrtc_hq_cuda as ops

BLOCKS = [(4, 4), (4, 8)]
T_KINDS = ["0", "0.375", "0.625", "1", "random"]
FIT_KERNELS = ("pvrtc_hq_normal", "pvrtc_hq_dot", "pvrtc_hq_choose")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and torch.equal(_bits(got), _bits(want))


def _inputs(side: int, block: tuple, t_kind: str, seed: int):
    """A/B texels (some outside 0..255, as the CG leaves them), a float
    image and blend weights (one value of ``_T`` everywhere, or drawn per
    pixel) for a (side, side) image."""
    rng = np.random.default_rng(seed)
    bh, bw = block
    x = rng.uniform(-40, 300, (2, side // bh, side // bw, 4))
    img = rng.integers(0, 256, (side, side, 4))
    if t_kind == "random":
        t = np.asarray(pvrtc_hq._T)[rng.integers(0, 4, (side, side))]
    else:
        t = np.full((side, side), float(t_kind))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(t.astype(np.float32)),
            torch.from_numpy(img.astype(np.float32)))


# --- the card's route, on a stand-in library ---------------------------------


def _view(ptr: int, shape: tuple) -> torch.Tensor:
    """The float32 tensor at address ``ptr`` (CPU memory)."""
    buf = (ctypes.c_float * math.prod(shape)).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.float32).reshape(shape)


class _FakeCard:
    """Stands in for the kernel library under ``_launch.launch``: each fit
    entry is recorded and computes its twin's result into ``out``."""

    def __init__(self):
        self.calls = []

    def texcomp_pvrtc_hq_normal(self, x, t, img, nby, nbx, bh, bw, out,
                                stream):
        self.calls.append("normal" if img is None else "rhs")
        h, w = nby * bh, nbx * bw
        low = (2, nby, nbx, 4)
        res = ops.pvrtc_hq_normal_plain(
            _view(x, low), _view(t, (h, w)),
            None if img is None else _view(img, (h, w, 4)))
        _view(out, low).copy_(res)
        return 0

    def texcomp_pvrtc_hq_dot(self, x, y, n, scratch, floats, out, stream):
        self.calls.append("dot")
        assert floats == ops.dot_scratch_floats(n)
        res = ops.pvrtc_hq_dot_plain(_view(x, (2, n)), _view(y, (2, n)))
        _view(out, (1,)).copy_(res.reshape(1))
        return 0

    def texcomp_pvrtc_hq_choose(self, img, ab, nby, nbx, bh, bw, out, stream):
        self.calls.append("choose")
        h, w = nby * bh, nbx * bw
        res = ops.pvrtc_hq_choose_plain(_view(img, (h, w, 4)),
                                        _view(ab, (2, nby, nbx, 4)))
        _view(out, (h, w)).copy_(res)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the kernel wrappers, which launch into a
    :class:`_FakeCard`; LAUNCHES starts at zero."""
    card = _FakeCard()
    monkeypatch.setattr(ops, "_pick", lambda t, plain, cuda: cuda)
    monkeypatch.setattr(ops, "_check", lambda *a, **k: None)
    monkeypatch.setattr(_launch._build, "load", lambda: card)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    _launch.reset_launches()
    return card


_SOLVE_CALLS = (["rhs", "normal", "dot"]
                + ["normal", "dot", "dot"] * pvrtc_hq._CG_ITERS)


@pytest.mark.parametrize("block", BLOCKS, ids=["4x4", "4x8"])
def test_outer_step_launches_the_fit_entries_in_order(block, fake_card):
    """On a CUDA tensor one alternation is the choice, then the CG's
    right-hand side, normal operators and dots, each a counted launch, and
    gives the plain path's bits."""
    x, _, img = _inputs(32, block, "random", 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_pick", lambda t, plain, cuda: plain)
        want = pvrtc_hq._outer_step(img, x)
    got = pvrtc_hq._outer_step(img, x)
    assert fake_card.calls == ["choose"] + _SOLVE_CALLS
    assert _launch.LAUNCHES["pvrtc_hq_choose"] == 1
    assert _launch.LAUNCHES["pvrtc_hq_normal"] == 2 + pvrtc_hq._CG_ITERS
    assert _launch.LAUNCHES["pvrtc_hq_dot"] == 1 + 2 * pvrtc_hq._CG_ITERS
    assert sum(_launch.LAUNCHES.values()) == len(fake_card.calls)
    assert _same_bits(got, want)


def test_solve_ab_launches_no_choice(fake_card):
    """The 2bpp refine's refit takes its blend weights as given: the CG's
    launches alone."""
    x, t, img = _inputs(16, (4, 8), "random", 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_pick", lambda t, plain, cuda: plain)
        want = pvrtc_hq._solve_ab(img, t, x)
    got = pvrtc_hq._solve_ab(img, t, x)
    assert fake_card.calls == _SOLVE_CALLS
    assert _launch.LAUNCHES["pvrtc_hq_choose"] == 0
    assert _same_bits(got, want)


@pytest.mark.parametrize("bits", [2, 4])
def test_encode_on_the_card_route_equals_the_frozen_reference(bits,
                                                              fake_card):
    """A whole HQ encode through the wrappers (the 2bpp reference arm on
    its plain twins) gives the frozen reference's bytes, with the fit's
    launches: per alternation one choice, per refit 2 + CG steps normal
    operators and 1 + 2 x CG steps dots."""
    rng = np.random.default_rng(bits)
    img = torch.from_numpy(rng.integers(0, 256, (16, 16, 4), dtype=np.uint8))
    if bits == 4:
        got = pvrtc_hq._encode_pvrtc_4bpp_hq_eager(img)
        want = frozen.encode_pvrtc_4bpp_hq(img)
        refits = pvrtc_hq._OUTER_ITERS
    else:
        got = pvrtc_hq.encode_pvrtc_2bpp_hq(img)
        want = frozen.encode_pvrtc_2bpp_hq(img)
        refits = pvrtc_hq._OUTER_ITERS + pvrtc_hq._REFINE_CYCLES
    assert torch.equal(got, want)
    cg = pvrtc_hq._CG_ITERS
    assert {k: _launch.LAUNCHES[k] for k in FIT_KERNELS} == {
        "pvrtc_hq_normal": refits * (2 + cg),
        "pvrtc_hq_dot": refits * (1 + 2 * cg),
        "pvrtc_hq_choose": pvrtc_hq._OUTER_ITERS}


# --- the dot kernel's order --------------------------------------------------


def _dot_model(x: torch.Tensor, y: torch.Tensor, per: int, lanes: int,
               last: int) -> torch.Tensor:
    """csrc/pvrtc_hq.cu's dot: while a leaf has more than ``last`` values,
    a pass makes each partial the halving tree over one residue class
    (values c, c + m_out, ..., ``per`` of them); the last pass makes each
    of at most ``lanes`` partials the same way, then their halving tree;
    then leaf A + leaf B."""
    n = x.shape[1]
    m = 1 << (n - 1).bit_length()
    v = torch.nn.functional.pad(x * y, (0, m - n))

    def residue_trees(v, m_out):
        cls = v.reshape(2, -1, m_out)  # cls[:, j, c] = v[:, c + j m_out]
        while cls.shape[1] > 1:
            half = cls.shape[1] // 2
            cls = cls[:, :half] + cls[:, half:]
        return cls[:, 0]

    while m > last:
        m //= per
        v = residue_trees(v, m)
    v = residue_trees(v, min(m, lanes))
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    return v[0, 0] + v[1, 0]


def _mixed(n: int, seed: int):
    """(2, n) float32 pairs whose products span 1e-8 to 1e8 in magnitude,
    of both signs."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-4, 4, (2, 2, n))
    v = rng.standard_normal((2, 2, n)) * mag
    return (torch.from_numpy(v[0].astype(np.float32)),
            torch.from_numpy(v[1].astype(np.float32)))


@pytest.mark.parametrize("per,lanes,last", [
    (ops._DOT_PER, 256, ops._DOT_LAST), (16, 4, 64), (2, 1, 1), (4, 8, 16),
    (2, 32, 512), (64, 2, 64), (8, 1024, 1024)])
@pytest.mark.parametrize("n", [1, 5, 64, 1000, 4096, 16384, 65536])
def test_dot_passes_keep_the_halving_tree(n, per, lanes, last):
    """The kernel's plan, and others with other partial counts, give the
    halving tree's bits."""
    x, y = _mixed(n, n + per + lanes)
    got = _dot_model(x, y, per, lanes, last)
    assert _same_bits(got, ops.pvrtc_hq_dot_plain(x, y))


def test_dot_inputs_are_order_sensitive():
    """The mixed inputs have teeth: a left-to-right sum of the same
    products gives other bits than the halving tree."""
    x, y = _mixed(65536, 3)
    prod = (x * y).numpy()
    seq = np.float32(0)
    for v in prod[0]:
        seq = np.float32(seq + v)
    tree = ops._ordered_sum((x * y).flatten(1))[0]
    assert seq.view(np.int32) != tree.numpy().view(np.int32)


@pytest.mark.parametrize("n,floats", [(1, 0), (16384, 0), (16385, 2 * 2048),
                                      (262144, 2 * 16384),
                                      (1 << 20, 2 * 65536 + 2 * 4096)])
def test_dot_scratch_follows_the_plan(n, floats):
    assert ops.dot_scratch_floats(n) == floats


# --- the tiles of the normal operator and the choice -------------------------

_TILE = 32  # csrc/pvrtc_hq.cu kTile: the tiles' pixel rows (the choice's
_NORMAL_COLS = 16  # columns too); kNormalCols: the normal operator's columns


def _lerp(b: int, fw: torch.Tensor, prev: torch.Tensor,
          nxt: torch.Tensor) -> torch.Tensor:
    return (b - fw) * prev + fw * nxt


def _normal_model(x: torch.Tensor, t: torch.Tensor,
                  img: torch.Tensor | None = None) -> torch.Tensor:
    """normal_kernel as PyTorch ops, one tile at a time: the A/B texels one
    past the tile (wrapped), the x pass over a window of pixels B/2 past
    the tile on each side, the y pass, residual and weighted g on that
    window (its pixels wrapped), then the transposed passes with their
    group sums and the ridge, written for the tile's texels in the
    image."""
    _, nby, nbx, _ = x.shape
    h, w = t.shape
    bh, bw = h // nby, w // nbx
    ty_n, tx_n = _TILE // bh, _NORMAL_COLS // bw
    inv = 1.0 / (bh * bw)
    out = torch.empty_like(x)
    wy = torch.arange(_TILE + bh)
    wx = torch.arange(_NORMAL_COLS + bw)
    for ty0 in range(0, nby, ty_n):
        for tx0 in range(0, nbx, tx_n):
            ly = (ty0 - 1 + torch.arange(ty_n + 2)) % nby
            lx = (tx0 - 1 + torch.arange(tx_n + 2)) % nbx
            sp = x[:, ly][:, :, lx]
            fx = (wx % bw).to(torch.float32)[:, None]
            sx = _lerp(bw, fx, sp[:, :, wx // bw], sp[:, :, wx // bw + 1])
            gy = (ty0 * bh - bh // 2 + wy) % h
            gx = (tx0 * bw - bw // 2 + wx) % w
            tb = t[gy][:, gx][..., None]
            w0 = 1.0 - tb
            if img is None:
                fy = (wy % bh).to(torch.float32)[:, None, None]
                up = _lerp(bh, fy, sx[:, wy // bh], sx[:, wy // bh + 1]) * inv
                r = w0 * up[0] + tb * up[1]
            else:
                r = img[gy][:, gx]
            sg = torch.stack([(w0 * r) * inv, (tb * r) * inv])
            rows = torch.arange(ty_n) * bh
            acc = (bh - 0) * sg[:, rows + bh] + 0 * sg[:, rows]
            for ky in range(1, bh):
                acc = acc + ((bh - ky) * sg[:, rows + ky + bh]
                             + ky * sg[:, rows + ky])
            cols = torch.arange(tx_n) * bw
            res = (bw - 0) * acc[:, :, cols + bw] + 0 * acc[:, :, cols]
            for kx in range(1, bw):
                res = res + ((bw - kx) * acc[:, :, cols + kx + bw]
                             + kx * acc[:, :, cols + kx])
            ny, nx = min(ty_n, nby - ty0), min(tx_n, nbx - tx0)
            p = x[:, ty0:ty0 + ny, tx0:tx0 + nx]
            out[:, ty0:ty0 + ny, tx0:tx0 + nx] = (ops._RIDGE * p
                                                  + res[:, :ny, :nx])
    return out


def _choose_model(img: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """choose_kernel as PyTorch ops, one 32x32 tile at a time: texels one
    past the tile (wrapped); pixel v's prev texel (v + B/2) / B, its next
    one more, its weight (v + B/2) mod B; the error terms and the strict-<
    chain; written for the tile's pixels in the image."""
    _, nby, nbx, _ = ab.shape
    h, w = img.shape[:2]
    bh, bw = h // nby, w // nbx
    ty_n, tx_n = _TILE // bh, _TILE // bw
    v = torch.arange(_TILE)
    out = torch.empty((h, w), dtype=torch.float32)
    for ty0 in range(0, nby, ty_n):
        for tx0 in range(0, nbx, tx_n):
            ly = (ty0 - 1 + torch.arange(ty_n + 2)) % nby
            lx = (tx0 - 1 + torch.arange(tx_n + 2)) % nbx
            sp = ab[:, ly][:, :, lx]
            ix, fx = (v + bw // 2) // bw, ((v + bw // 2) % bw).float()[:, None]
            sx = _lerp(bw, fx, sp[:, :, ix], sp[:, :, ix + 1])
            iy, fy = (v + bh // 2) // bh, ((v + bh // 2) % bh).float()
            up = _lerp(bh, fy[:, None, None], sx[:, iy], sx[:, iy + 1])
            up = up / float(bh * bw)
            ny, nx = min(_TILE, h - ty0 * bh), min(_TILE, w - tx0 * bw)
            im = img[ty0 * bh:ty0 * bh + ny, tx0 * bw:tx0 * bw + nx]
            up = up[:, :ny, :nx]
            d = im - up[0]
            e = up[1] - up[0]
            de, ee = d * e, e * e
            s = de[..., 0] + de[..., 1] + de[..., 2] + de[..., 3]
            q = ee[..., 0] + ee[..., 1] + ee[..., 2] + ee[..., 3]
            best_t, best_e = torch.zeros_like(s), torch.zeros_like(s)
            for tv in pvrtc_hq._T[1:]:
                cand = (tv * tv) * q - (2.0 * tv) * s
                better = cand < best_e
                best_t = torch.where(better, tv, best_t)
                best_e = torch.where(better, cand, best_e)
            out[ty0 * bh:ty0 * bh + ny, tx0 * bw:tx0 * bw + nx] = best_t
    return out


@pytest.mark.parametrize("with_img", [False, True], ids=["Jp", "image"])
@pytest.mark.parametrize("t_kind", ["0", "1", "random"])
@pytest.mark.parametrize("block", BLOCKS, ids=["4x4", "4x8"])
@pytest.mark.parametrize("side", [8, 16, 32, 64])
def test_tiled_normal_operator_equals_the_twin(side, block, t_kind,
                                               with_img):
    x, t, img = _inputs(side, block, t_kind, side)
    img = img if with_img else None
    got = _normal_model(x, t, img)
    assert _same_bits(got, ops.pvrtc_hq_normal_plain(x, t, img))


@pytest.mark.parametrize("block", BLOCKS, ids=["4x4", "4x8"])
@pytest.mark.parametrize("side", [8, 16, 64])
def test_tiled_choice_equals_the_twin(side, block):
    x, _, img = _inputs(side, block, "0", side + 1)
    got = _choose_model(img, x)
    assert _same_bits(got, ops.pvrtc_hq_choose_plain(img, x))


# --- the twins keep one float order ------------------------------------------


def _code(path: str) -> str:
    with open(path, "rb") as f:
        return " ".join(t.string for t in tokenize.tokenize(f.readline)
                        if t.type not in (tokenize.STRING, tokenize.COMMENT))


@pytest.mark.parametrize("banned", [
    r"torch \. func", "autograd", "backward", r"torch \. compile", "addcmul",
    "lerp", r"[,(] alpha =", r"item \(", "nonzero", r"cpu \(", "matmul",
    r"\. sum \(",
])
def test_twins_have_no_order_changing_or_syncing_call(banned):
    """The fit's arithmetic moved here from ``codecs.pvrtc_hq`` keeps its
    rules: no fused or device-dependent arithmetic, no float ``.sum``, and
    nothing that waits on the device."""
    assert not re.search(banned, _code(ops.__file__))


# --- the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is available")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("block", BLOCKS, ids=["4x4", "4x8"])
@pytest.mark.parametrize("side", [8, 16, 64, 256, 1024])
def test_kernels_equal_their_twins(card, side, block):
    """Each kernel gives its twin's bits on the card, for t of each single
    value and of values drawn per pixel, with and without the image."""
    for k, t_kind in enumerate(T_KINDS):
        x, t, img = (v.to(card) for v in _inputs(side, block, t_kind, k))
        for im in (None, img):
            got = ops.pvrtc_hq_normal_cuda(x, t, im)
            want = ops.pvrtc_hq_normal_plain(x, t, im)
            assert _same_bits(got, want), (t_kind, im is None)
        y = ops.pvrtc_hq_normal_plain(x, t)
        assert _same_bits(ops.pvrtc_hq_dot_cuda(x, y),
                          ops.pvrtc_hq_dot_plain(x, y)), t_kind
    assert _same_bits(ops.pvrtc_hq_choose_cuda(img, x),
                      ops.pvrtc_hq_choose_plain(img, x))


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 262144, 1 << 20, 3000001])
def test_dot_kernel_equals_its_twin(card, n):
    x, y = (v.to(card) for v in _mixed(n, n))
    assert _same_bits(ops.pvrtc_hq_dot_cuda(x, y),
                      ops.pvrtc_hq_dot_plain(x, y))


@pytest.mark.card
@pytest.mark.parametrize("side", [16, 64, 256])
def test_hq_encodes_equal_the_frozen_reference(card, side, monkeypatch):
    """Both HQ encodes on the card, 2bpp eager and 4bpp eager, captured and
    replayed, give the frozen reference's bytes."""
    monkeypatch.setattr(pvrtc_hq, "_GRAPHS",
                        pvrtc_hq._GraphCache(pvrtc_hq._GRAPH_CAP))
    rng = np.random.default_rng(side)
    images = [rng.integers(0, 256, (side, side, 4), dtype=np.uint8)
              for _ in range(3)]
    images[1][..., 3] = 255
    for im in images:
        img = torch.from_numpy(im)
        assert torch.equal(pvrtc_hq.encode_pvrtc_2bpp_hq(img.to(card)).cpu(),
                           frozen.encode_pvrtc_2bpp_hq(img))
        want = frozen.encode_pvrtc_4bpp_hq(img)
        for _ in range(3):  # eager, capture, replay
            got = pvrtc_hq.encode_pvrtc_4bpp_hq(img.to(card)).cpu()
            assert torch.equal(got, want)
