"""The 4bpp HQ PVRTC encode as a CUDA graph (``codecs.pvrtc_hq``'s
``_GraphCache``): a CPU tensor always runs the ops one by one and counts
as eager; on a card a key's first call runs eagerly, its second captures
and every later call replays, each with the bytes of the op-by-op path.

This file imports no JAX: it compares with the op-by-op function and with
the frozen plain reference (``texbench.reference``), so the tests marked
``card`` run on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_pvrtc_hq_graph.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import texcomp_torch
from texbench.reference import pvrtc_hq as frozen
from texcomp_torch.codecs import pvrtc_hq
from texcomp_torch.dist import pipeline
from texcomp_torch.ops import _launch

API_NAMES = {"texcomp.api.compress", "texcomp.api.upload",
             "texcomp.api.download"}
HQ4_NAMES = API_NAMES | {"texcomp.pvrtc.hq.encode",
                         "texcomp.pvrtc.hq.reference", "texcomp.pvrtc.hq.fit",
                         "texcomp.pvrtc.hq.assign", "texcomp.pvrtc.hq.choose"}


def _image(side: int, seed: int, opaque: bool) -> torch.Tensor:
    """Noise with a solid quarter and a smooth quarter; alpha 255 or a
    ramp with noise."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (side, side, 4), dtype=np.uint8)
    half = side // 2
    img[:half, :half] = img[0, 0]
    yy, xx = np.mgrid[0:half, 0:half]
    img[half:, :half, 0] = xx * 255 // max(1, half - 1)
    img[half:, :half, 1] = yy * 255 // max(1, half - 1)
    if opaque:
        img[..., 3] = 255
    else:
        img[..., 3] = np.minimum(255, np.arange(side) * 8)[:, None]
    return torch.from_numpy(img)


def _stats() -> dict:
    return dict(pvrtc_hq.GRAPH_STATS)


def _delta(before: dict) -> dict:
    return {k: pvrtc_hq.GRAPH_STATS[k] - before[k] for k in before}


@pytest.fixture
def card(monkeypatch):
    """The card, with an empty graph cache of its own for the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is available")
    monkeypatch.setattr(pvrtc_hq, "_GRAPHS",
                        pvrtc_hq._GraphCache(pvrtc_hq._GRAPH_CAP))
    return torch.device("cuda")


# --- the CPU: always op by op ------------------------------------------------


@pytest.mark.parametrize("side", [16, 64])
def test_a_cpu_image_never_captures(side):
    before = _stats()
    for seed in range(3):
        pvrtc_hq.encode_pvrtc_4bpp_hq(_image(side, seed, opaque=False))
    assert _delta(before) == {"eager": 3, "captures": 0, "replays": 0}


@pytest.mark.parametrize("opaque", [True, False],
                         ids=["opaque", "translucent"])
@pytest.mark.parametrize("side", [16, 64])
def test_cpu_bytes_equal_the_op_by_op_and_frozen_paths(side, opaque):
    img = _image(side, 7, opaque)
    got = pvrtc_hq.encode_pvrtc_4bpp_hq(img)
    assert got.shape == (side * side // 16, 8) and got.dtype == torch.uint8
    assert torch.equal(got, pvrtc_hq._encode_pvrtc_4bpp_hq_eager(img))
    assert torch.equal(got, frozen.encode_pvrtc_4bpp_hq(img))


def test_a_cpu_hq_request_records_the_eight_spans():
    """The API's three spans and the encode's five, one of each name; no
    replay span on the CPU."""
    img = _image(16, 3, opaque=False).numpy()
    comp = texcomp_torch.Pvrtc4bppCompressor("high", device="cpu")
    out = texcomp_torch.CompressedImage()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert comp.compress(texcomp_torch.Format.RGBA, 16, 16, 0,
                             img.tobytes(), out)
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("texcomp.")]
    assert sorted(names) == sorted(HQ4_NAMES)


# --- the card: capture once, replay after ------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("side", [1024, 64])
def test_replays_give_each_image_its_own_bytes(card, side):
    """Calls 3 and later replay; each of three distinct images (one fully
    opaque) gives its op-by-op bytes on the card and its CPU bytes, in
    whatever order the graph saw them."""
    images = [_image(side, 11, False), _image(side, 12, True),
              _image(side, 13, False)]
    want = [pvrtc_hq.encode_pvrtc_4bpp_hq(im) for im in images]
    eager = [pvrtc_hq._encode_pvrtc_4bpp_hq_eager(im.to(card)).cpu()
             for im in images]
    for w, e in zip(want, eager):
        assert torch.equal(w, e)
    before = _stats()
    order = [0, 1, 2, 0, 1, 2, 1]
    got = [pvrtc_hq.encode_pvrtc_4bpp_hq(images[i].to(card)).cpu()
           for i in order]
    assert _delta(before) == {"eager": 1, "captures": 1,
                              "replays": len(order) - 2}
    for i, g in zip(order, got):
        assert torch.equal(g, want[i]), f"image {i}"


@pytest.mark.card
def test_results_held_together_do_not_alias(card):
    """Four results held in a list and stacked, as
    ``dist.pipeline._batch_encode_hq`` does, are each their image's."""
    images = [_image(64, 20 + k, k % 2 == 0) for k in range(4)]
    want = torch.stack([pvrtc_hq.encode_pvrtc_4bpp_hq(im) for im in images])
    for im in images[:2]:  # eager, then capture
        pvrtc_hq.encode_pvrtc_4bpp_hq(im.to(card))
    held = [pvrtc_hq.encode_pvrtc_4bpp_hq(im.to(card)) for im in images]
    assert torch.equal(torch.stack(held).cpu(), want)
    batch = torch.stack(images).to(card)
    assert torch.equal(pipeline._batch_encode_hq(batch, "pvrtc4").cpu(), want)


@pytest.mark.card
def test_counters_keys_and_eviction(card):
    """N calls of one key: one eager, one capture, N - 2 replays; two sides
    are two keys; past the cap the least recently used key goes and its
    next call runs eagerly again."""
    n = 5
    before = _stats()
    for _ in range(n):
        pvrtc_hq.encode_pvrtc_4bpp_hq(_image(32, 1, False).to(card))
    assert _delta(before) == {"eager": 1, "captures": 1, "replays": n - 2}
    for _ in range(2):
        pvrtc_hq.encode_pvrtc_4bpp_hq(_image(16, 1, False).to(card))
    assert list(pvrtc_hq._GRAPHS.entries) == [(32, 32, 0), (16, 16, 0)]
    assert all(g is not None for g in pvrtc_hq._GRAPHS.entries.values())

    sides = [8, 64, 128, 256]
    for side in sides:
        for _ in range(2):
            pvrtc_hq.encode_pvrtc_4bpp_hq(_image(side, 2, False).to(card))
    assert len(pvrtc_hq._GRAPHS.entries) == pvrtc_hq._GRAPH_CAP
    assert [k[0] for k in pvrtc_hq._GRAPHS.entries] == sides
    before = _stats()
    img = _image(32, 3, True)
    got = pvrtc_hq.encode_pvrtc_4bpp_hq(img.to(card))
    assert _delta(before) == {"eager": 1, "captures": 0, "replays": 0}
    assert torch.equal(got.cpu(), pvrtc_hq.encode_pvrtc_4bpp_hq(img))


@pytest.mark.card
def test_no_kernel_of_the_port_launches(card):
    """Of the port's kernels the 4bpp HQ path launches the fit's alone: on
    the eager call, a choice an alternation, 2 + CG steps normal operators
    and 1 + 2 x CG steps dots a refit; as many again at capture; and none
    from the host on a replay, which runs them from the graph."""
    fit = {"pvrtc_hq_choose": pvrtc_hq._OUTER_ITERS,
           "pvrtc_hq_normal": pvrtc_hq._OUTER_ITERS * (2 + pvrtc_hq._CG_ITERS),
           "pvrtc_hq_dot": pvrtc_hq._OUTER_ITERS * (1 + 2 * pvrtc_hq._CG_ITERS)}
    _launch.reset_launches()
    counts = []
    for seed in range(4):
        pvrtc_hq.encode_pvrtc_4bpp_hq(_image(64, seed, False).to(card))
        counts.append({k: n for k, n in _launch.LAUNCHES.items() if n})
    torch.cuda.synchronize()
    assert pvrtc_hq._GRAPHS.entries[(64, 64, 0)] is not None
    assert counts[0] == fit
    assert counts[1] == {k: 2 * n for k, n in fit.items()}
    assert counts[2] == counts[3] == counts[1]
