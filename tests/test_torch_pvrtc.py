"""texcomp_torch PVRTC 2bpp codec, Z-order and image ops against the JAX
package.

Each stage twin of ``ops.pvrtc_cuda`` (what a CPU tensor runs, and what
the CUDA kernels are held to on the card) is held to its Pallas kernel run
in interpret mode, as tests/test_pallas.py runs it, by mapping the twin's
(blocks, ...) layout onto JAX's (C, blocks) one with a transpose. The whole
encode is held to ``texcomp.codecs.pvrtc.encode_pvrtc_2bpp_device`` and
``texcomp.ops.pvrtc_fast.encode_pvrtc_2bpp_fast``, the batched encode to
``encode_pvrtc_2bpp_batched``, and the decode extension to
``decode_pvrtc_2bpp_device``. Tolerance is 0: every step is integer
arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texcomp import native as jnative
from texcomp.codecs import pvrtc as jpvrtc
from texcomp.ops import pvrtc_fast as pf
from texcomp_torch import native as tnative
from texcomp_torch.codecs import pvrtc as tpvrtc
from texcomp_torch.ops import _launch, pvrtc_cuda


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _words_to_image(words: np.ndarray, nby: int, nbx: int) -> np.ndarray:
    """(32, NB) uint32 JAX block words (sublane py*8+px, row-major blocks)
    -> the (H, W, 4) uint8 image they came from."""
    t = words.reshape(4, 8, nby, nbx).transpose(2, 0, 3, 1)
    return np.ascontiguousarray(t.reshape(4 * nby, 8 * nbx)).view(
        np.uint8).reshape(4 * nby, 8 * nbx, 4)


def _image_words(images: np.ndarray) -> np.ndarray:
    """(B, H, W, 4) uint8 -> JAX's (32, B*NB) uint32 words, image-major."""
    b, h, w, _ = images.shape
    px = np.ascontiguousarray(images).view(np.uint32).reshape(b * h, w)
    return np.asarray(pf._px_block_words(jnp.asarray(px)))


def _ab_jax(ab: torch.Tensor) -> jnp.ndarray:
    """The twin's (N, 2) int32 ab -> JAX's (2, N) uint32."""
    return jnp.asarray(ab.numpy().view(np.uint32).T.copy())


def _records(words: np.ndarray, nby: int, nbx: int, batch: int = 1):
    """JAX's (2, B*NB) uint32 row-major words -> (B*NB, 8) uint8 Z-order
    records."""
    perm = jnative.zorder_perm(nbx, nby)
    w = words.reshape(2, batch, nby * nbx)[:, :, perm]
    both = np.stack([w[0], w[1]], axis=-1).astype("<u4")
    return both.view(np.uint8).reshape(-1, 8)


def _stage_words(rng, nby: int, nbx: int) -> np.ndarray:
    """(32, NB) uint32 pixels with tied pixels, all-black, zero-alpha,
    alpha-only and flat blocks (the inputs of tests/test_pallas.py)."""
    n = nby * nbx
    px = rng.integers(0, 2**32, (32, n), dtype=np.uint32)
    px[:, 5:15] = px[:1, 5:15]  # flat blocks: all pixels tied
    px[16:, 15:30] = px[:16, 15:30]  # duplicated pixels: first occurrence
    px[:, 40:44] = 0  # all-black: every axis all-zero
    px[:, 44:48] &= 0x00FFFFFF  # zero alpha
    px[:, 48:52] = 0xFF000000  # opaque black: only alpha is non-zero
    px[:, 52:56] &= 0xFF00FF00  # red and blue zero
    return px


# --- native.zorder_perm ------------------------------------------------------


@pytest.mark.parametrize("nbx,nby", [(1, 2), (2, 4), (4, 8), (16, 32),
                                     (8, 8), (3, 5), (64, 128)])
def test_zorder_perm_equals_texcomp(nbx, nby):
    np.testing.assert_array_equal(tnative.zorder_perm(nbx, nby),
                                  jnative.zorder_perm(nbx, nby))


@pytest.mark.parametrize("nbx", [1, 2, 8, 64])
def test_zorder_is_a_bijection_on_2bpp_grids(nbx):
    """The kernel computes each block's slot by interleaving bits; on the
    (2 nbx, nbx) grids of square images that map is one to one."""
    perm = tnative.zorder_perm(nbx, 2 * nbx)
    assert sorted(perm.tolist()) == list(range(2 * nbx * nbx))


# --- each stage twin against its Pallas kernel (interpret mode) -------------


@pytest.mark.parametrize("nbx", [8, 64])
def test_morph_twin_equals_pallas(rng, nbx):
    """64 blocks (one grid step), and 8,192 (four steps) with an all-zero
    block in a later step."""
    nby = 2 * nbx
    px = _stage_words(rng, nby, nbx)
    px[:, -3] = 0
    origin = rng.integers(0, 256, 4, dtype=np.uint8)
    p00wi = jnp.asarray(origin.view(np.int32).reshape(1, 1))
    want = np.asarray(pf.morph_packed(jnp.asarray(px), p00wi, interpret=True))
    image = _words_to_image(px, nby, nbx)
    got = pvrtc_cuda.pvrtc_morph_plain(_t(image), _t(origin))
    assert got.dtype == torch.int32 and got.shape == (nby * nbx, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32).T, want)


def test_morph_twin_takes_the_image_origin_by_default(rng):
    px = _stage_words(rng, 16, 8)
    image = _t(_words_to_image(px, 16, 8))
    a = pvrtc_cuda.pvrtc_morph_plain(image, image[0, 0])
    b = pvrtc_cuda.pvrtc_morph_batched_plain(image[None])
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("batch,side", [(3, 32), (2, 8)])
def test_morph_batched_twin_equals_pallas(rng, batch, side):
    """Each image falls back to its own pixel (0, 0): the per-lane origin
    row of morph_packed_batched."""
    nby, nbx = side // 4, side // 8
    nb = nby * nbx
    images = rng.integers(0, 256, (batch, side, side, 4), dtype=np.uint8)
    images[0, :4, :8] = 0  # all-black block in image 0
    images[-1, side - 4:, side - 8:, 3] = 0  # zero-alpha block in the last
    images[-1, :4, :8, :3] = 0  # zero color, some alpha
    words = _image_words(images)
    p00 = np.repeat(words[0, ::nb].view(np.int32), nb)[None]
    want = np.asarray(pf.morph_packed_batched(
        jnp.asarray(words), jnp.asarray(p00), interpret=True))
    got = pvrtc_cuda.pvrtc_morph_batched_plain(_t(images))
    np.testing.assert_array_equal(got.numpy().view(np.uint32).T, want)


@pytest.mark.parametrize("nbx", [1, 2, 8])
def test_upscale_modulate_twin_equals_pallas(rng, nbx):
    """Fed by JAX's _make_var_words; nbx = 1 is the 8x8 image, where every
    neighbor wraps onto the block itself or its one sibling."""
    nby = 2 * nbx
    px = _stage_words(rng, nby, nbx) if nbx == 8 else rng.integers(
        0, 2**32, (32, nby * nbx), dtype=np.uint32)
    image = _t(_words_to_image(px, nby, nbx))
    ab = pvrtc_cuda.pvrtc_morph_plain(image, image[0, 0])
    ab_j = _ab_jax(ab)
    va9 = pf._make_var_words(ab_j[0:1], nby, nbx)
    vb9 = pf._make_var_words(ab_j[1:2], nby, nbx)
    want = np.asarray(pf.upscale_modulate_packed(
        jnp.asarray(px), jnp.concatenate([va9, vb9], axis=0), interpret=True))
    got = pvrtc_cuda.pvrtc_upscale_modulate_plain(image[None], ab)
    assert got.dtype == torch.uint8 and got.shape == (nby * nbx, 32)
    np.testing.assert_array_equal(got.numpy().T, want)


def test_upscale_modulate_twin_batched_equals_pallas(rng):
    """Three images wrap each on its own grid (_make_var_words_batched)."""
    batch, side = 3, 32
    nby, nbx = side // 4, side // 8
    images = rng.integers(0, 256, (batch, side, side, 4), dtype=np.uint8)
    ab = pvrtc_cuda.pvrtc_morph_batched_plain(_t(images))
    ab_j = _ab_jax(ab)
    va9 = pf._make_var_words_batched(ab_j[0:1], batch, nby, 1, nbx)
    vb9 = pf._make_var_words_batched(ab_j[1:2], batch, nby, 1, nbx)
    want = np.asarray(pf.upscale_modulate_packed(
        jnp.asarray(_image_words(images)),
        jnp.concatenate([va9, vb9], axis=0), interpret=True))
    got = pvrtc_cuda.pvrtc_upscale_modulate_plain(_t(images), ab)
    np.testing.assert_array_equal(got.numpy().T, want)


def _modulation(rng, n):
    """(32, n) int32 modulation: random, flat, and runs that pick each
    mode."""
    mod = rng.integers(0, 4, (32, n)).astype(np.int32)
    mod[:, 3:7] = 0  # flat -> 1bpp
    mod[:, 7:9] = 3
    s = np.arange(32)
    mod[:, 9] = (s & 7) % 4  # varies along x -> vertical
    mod[:, 10] = (s >> 3) % 4  # varies along y -> horizontal
    mod[:, 11] = 1 + ((s ^ (s >> 3)) & 1)  # 1 and 2 -> average4
    return mod


@pytest.mark.parametrize("nbx", [1, 4, 8])
def test_modes_pack_twin_equals_pallas(rng, nbx):
    """Fed by JAX's _mode_edges; the kernel writes Z-order records, so the
    JAX words go through the Z-order permutation and the LE byte layout."""
    nby = 2 * nbx
    n = nby * nbx
    mod = _modulation(rng, max(n, 12))[:, :n]
    image = _t(_words_to_image(_stage_words(rng, nby, nbx) if n >= 56 else
                               rng.integers(0, 2**32, (32, n), dtype=np.uint32),
                               nby, nbx))
    ab = pvrtc_cuda.pvrtc_morph_plain(image, image[0, 0])
    nh_edge, nv_edge = pf._mode_edges(jnp.asarray(mod), nby, nbx)
    want = np.asarray(pf.modes_pack_colors_packed(
        jnp.asarray(mod), nh_edge, nv_edge, _ab_jax(ab), interpret=True))
    got = pvrtc_cuda.pvrtc_modes_pack_plain(_t(mod.T.astype(np.uint8)), ab,
                                            nby, nbx)
    np.testing.assert_array_equal(got.numpy(), _records(want, nby, nbx))


def test_modes_pack_twin_batched_equals_pallas(rng):
    batch, nby, nbx = 3, 8, 4
    n = batch * nby * nbx
    mod = _modulation(rng, n)
    ab = _t(rng.integers(-2**31, 2**31, (n, 2), dtype=np.int64).astype(np.int32))
    nh_edge, nv_edge = pf._mode_edges_batched(jnp.asarray(mod), batch, nby, 1,
                                              nbx)
    want = np.asarray(pf.modes_pack_colors_packed(
        jnp.asarray(mod), nh_edge, nv_edge, _ab_jax(ab), interpret=True))
    got = pvrtc_cuda.pvrtc_modes_pack_plain(_t(mod.T.astype(np.uint8)), ab,
                                            nby, nbx)
    np.testing.assert_array_equal(got.numpy(), _records(want, nby, nbx, batch))


# --- the whole encode --------------------------------------------------------


def _test_image(rng, side: int, kind: str) -> np.ndarray:
    yy, xx = np.mgrid[0:side, 0:side]
    img = rng.integers(0, 256, (side, side, 4), dtype=np.uint8)
    if kind == "solid":
        img[:] = rng.integers(0, 256, 4, dtype=np.uint8)
    elif kind == "vstripes":  # varies along x: vertical mode
        img[..., :3] = (xx % 4 * 85)[..., None]
        img[..., 3] = 255
    elif kind == "hstripes":  # varies along y: horizontal mode
        img[..., :3] = (yy % 4 * 85)[..., None]
        img[..., 3] = 255
    elif kind == "alpha":  # bands of alpha 0 / 255 / gradient / noise
        band = yy * 4 // side
        img[..., 3] = np.select([band == 0, band == 1, band == 2],
                                [0, 255, xx * 255 // (side - 1)], img[..., 3])
        img[: side // 8, : side // 4] = 0  # all-black corner
    return img


def _modes(records: np.ndarray) -> set:
    """The modes of (N, 8) records: 0 = 1bpp, 1 = average4, 2 = vertical,
    3 = horizontal."""
    words = records.view("<u4").reshape(-1, 2).astype(np.int64)
    two = (words[:, 1] & 1) == 1
    other = (words[:, 0] & 1) == 1
    vert = ((words[:, 0] >> 20) & 1) == 1
    mode = np.where(~two, 0, np.where(~other, 1, np.where(vert, 2, 3)))
    return set(mode.tolist())


@pytest.mark.parametrize("kind", ["random", "solid", "vstripes", "hstripes",
                                  "alpha"])
@pytest.mark.parametrize("side", [8, 16, 32, 128])
def test_encode_image_equals_texcomp(rng, side, kind):
    img = _test_image(rng, side, kind)
    got = pvrtc_cuda.pvrtc_encode_image(_t(img)).numpy()
    want = np.asarray(jpvrtc.encode_pvrtc_2bpp_device(jnp.asarray(img)))
    assert got.shape == (side * side // 32, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(pf.encode_pvrtc_2bpp_fast(jnp.asarray(img))))
    np.testing.assert_array_equal(tpvrtc.encode_pvrtc_2bpp(_t(img)).numpy(),
                                  got)
    if side == 128 and kind in ("vstripes", "hstripes"):
        assert {"vstripes": 2, "hstripes": 3}[kind] in _modes(got)


def test_encode_image_hits_every_mode(rng):
    """Quadrants of noise, vertical and horizontal stripes and a solid
    color: the encode takes all four modulation modes."""
    q = [_test_image(rng, 32, k)
         for k in ("random", "vstripes", "hstripes", "solid")]
    img = np.concatenate([np.concatenate(q[:2], axis=1),
                          np.concatenate(q[2:], axis=1)], axis=0)
    got = pvrtc_cuda.pvrtc_encode_image(_t(img)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpvrtc.encode_pvrtc_2bpp_device(jnp.asarray(img))))
    assert _modes(got) == {0, 1, 2, 3}


@pytest.mark.parametrize("batch,side", [(3, 32), (2, 8)])
def test_encode_batched_equals_texcomp(rng, batch, side):
    images = np.stack([_test_image(rng, side, k) for k in
                       ("random", "alpha", "vstripes")[:batch]])
    got = pvrtc_cuda.pvrtc_encode_batched(_t(images)).numpy()
    want = np.asarray(pf.encode_pvrtc_2bpp_batched(jnp.asarray(images)))
    assert got.shape == (batch, side * side // 32, 8)
    np.testing.assert_array_equal(got, want)
    for i in range(batch):
        np.testing.assert_array_equal(
            got[i], pvrtc_cuda.pvrtc_encode_image(_t(images[i])).numpy())


@pytest.mark.parametrize("shape", [(8, 16, 4), (16, 8, 4), (12, 12, 4),
                                   (4, 4, 4), (8, 8, 3)])
def test_encode_rejects_other_shapes(shape):
    with pytest.raises(ValueError):
        pvrtc_cuda.pvrtc_encode_image(torch.zeros(shape, dtype=torch.uint8))


# --- the decode extension ----------------------------------------------------


@pytest.mark.parametrize("side", [8, 32, 64])
@pytest.mark.parametrize("source", ["encoded", "random"])
def test_decode_equals_texcomp(rng, side, source):
    """Encoded payloads, and random record bytes (every mode bit and flag
    combination)."""
    if source == "encoded":
        data = np.asarray(jpvrtc.encode_pvrtc_2bpp_device(
            jnp.asarray(_test_image(rng, side, "alpha"))))
    else:
        data = rng.integers(0, 256, (side * side // 32, 8), dtype=np.uint8)
    want = np.asarray(jpvrtc.decode_pvrtc_2bpp_device(
        jnp.asarray(data), height=side, width=side))
    got = tpvrtc.decode_pvrtc_2bpp(_t(data), side, side)
    assert got.shape == (side, side, 4)
    np.testing.assert_array_equal(got.numpy(), want)


# --- codec helpers ----------------------------------------------------------


def test_words_round_trip(rng):
    rgba = rng.integers(0, 256, (50, 4)).astype(np.int32)
    words = tpvrtc.pack_words(_t(rgba))
    assert words.dtype == torch.int32 and (words < 0).any()
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  rgba.astype(np.uint8).view(np.uint32)[:, 0])
    np.testing.assert_array_equal(tpvrtc.unpack_words(words).numpy(), rgba)


@pytest.mark.parametrize("is_b", [False, True])
def test_color_reduction_and_packing_equal_texcomp(rng, is_b):
    rgba = rng.integers(0, 256, (400, 4)).astype(np.int32)
    rgba[::3, 3] = 255
    np.testing.assert_array_equal(
        tpvrtc._apply_color_channel_reduction(_t(rgba), is_b).numpy(),
        np.asarray(jpvrtc._apply_color_channel_reduction(jnp.asarray(rgba),
                                                         is_b)))
    modes = rng.integers(0, 4, 200).astype(np.int32)
    a, b = rgba[:200], rgba[200:]
    np.testing.assert_array_equal(
        tpvrtc._encode_colors(_t(a), _t(b), _t(modes)).numpy().view(np.uint32),
        np.asarray(jpvrtc._encode_colors(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(modes))))


# --- the kernel wrappers refuse what they cannot launch --------------------


@pytest.mark.parametrize("name", ["pvrtc_morph", "pvrtc_morph_batched",
                                  "pvrtc_upscale_modulate",
                                  "pvrtc_modes_pack"])
def test_kernel_wrapper_refuses_cpu_tensor(name):
    """A kernel wrapper launches on a CUDA tensor or raises; it never runs
    the plain version instead, and counts no launch."""
    before = dict(_launch.LAUNCHES)
    image = torch.zeros((8, 8, 4), dtype=torch.uint8)
    ab = torch.zeros((2, 2), dtype=torch.int32)
    args = {"pvrtc_morph": (image, image[0, 0]),
            "pvrtc_morph_batched": (image[None],),
            "pvrtc_upscale_modulate": (image[None], ab),
            "pvrtc_modes_pack": (torch.zeros((2, 32), dtype=torch.uint8), ab,
                                 2, 1)}[name]
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(pvrtc_cuda, f"{name}_cuda")(*args)
    assert _launch.LAUNCHES == before
