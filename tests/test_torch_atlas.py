"""The sharded PVRTC atlases and their strip kernels' plain twins:
texcomp_torch against texcomp on the CPU.

An atlas splits its block rows over the "data" devices of a mesh; each
strip needs one block row of its neighbours, which texcomp exchanges by
``ppermute`` and the port by copies between the mesh's devices. On the
CPU the port runs the plain twins of its strip kernels
(``ops.pvrtc_cuda``: the morph of a strip, upscale + modulate with halo
rows, mode + pack of a strip, row-major), on a mesh of repeated CPU
devices; texcomp runs its own atlases on its 8 virtual CPU devices. Every
payload must be equal byte for byte to texcomp's atlas and to the port's
single-device encoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from texcomp.codecs import pvrtc4 as jpvrtc4
from texcomp.dist import mesh as jmesh
from texcomp.ops import pvrtc_fast as pf
from texcomp_torch.codecs import pvrtc4
from texcomp_torch.dist import mesh as tmesh
from texcomp_torch.ops import pvrtc_cuda as pc
from tests.conftest import make_test_image

CPU = torch.device("cpu")


def cpu_mesh(data: int, block: int = 1) -> tmesh.Mesh:
    return tmesh.make_mesh(data * block, data=data, block=block,
                           devices=[CPU] * (data * block))


def jax_mesh(data: int, block: int = 1):
    if block == 1:
        return JaxMesh(np.array(jax.devices()[:data]), ("data",))
    return jmesh.make_mesh(data * block, data=data, block=block)


def atlas_image(side: int, seed: int = 1234) -> np.ndarray:
    """texcomp's atlas test image: an all-zero first shard's rows (the
    fallback pixel (0, 0) is the whole image's) and rows correlated across
    a shard boundary (tests/test_dist.py)."""
    img = make_test_image(np.random.default_rng(seed), side, side, 4).copy()
    if side >= 128:
        img[0:8] = 0
        img[60:68] = img[4:12]
    return img


@pytest.fixture(scope="module")
def texcomp_atlas():
    """(side, bpp) -> texcomp's atlas of :func:`atlas_image` on its
    8-device mesh, computed once."""
    cache = {}

    def get(side: int, bpp: int = 2):
        if (side, bpp) not in cache:
            img = jnp.asarray(atlas_image(side))
            fn = (jmesh.pvrtc_encode_atlas_sharded if bpp == 2
                  else jmesh.pvrtc4_encode_atlas_sharded)
            cache[side, bpp] = np.asarray(fn(img, jax_mesh(8)))
        return cache[side, bpp]

    return get


# ---------------------------------------------------------------------------
# The atlases.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side,data,block", [
    (128, 1, 1), (128, 2, 1), (128, 8, 1), (128, 4, 2),
    (32, 8, 1),  # one block row a shard: both halos foreign
])
def test_pvrtc_atlas_2bpp(texcomp_atlas, side, data, block):
    img = atlas_image(side)
    got = tmesh.pvrtc_encode_atlas_sharded(torch.from_numpy(img),
                                           cpu_mesh(data, block))
    single = pc.pvrtc_encode_image(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), texcomp_atlas(side))
    np.testing.assert_array_equal(got.numpy(), single.numpy())


def test_pvrtc_atlas_2bpp_texcomp_two_axis_mesh():
    """texcomp's atlas on its (data 4, block 2) mesh against the port's."""
    img = atlas_image(128)
    want = np.asarray(jmesh.pvrtc_encode_atlas_sharded(
        jnp.asarray(img), jax_mesh(4, 2)))
    got = tmesh.pvrtc_encode_atlas_sharded(torch.from_numpy(img),
                                           cpu_mesh(4, 2))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("side,data", [(128, 8), (32, 8), (64, 2)])
def test_pvrtc_atlas_4bpp(texcomp_atlas, side, data):
    img = atlas_image(side)
    got = tmesh.pvrtc4_encode_atlas_sharded(torch.from_numpy(img),
                                            cpu_mesh(data))
    single = pvrtc4.encode_pvrtc_4bpp(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    if data == 8:
        np.testing.assert_array_equal(got.numpy(), texcomp_atlas(side, 4))


def test_pvrtc4_atlas_matches_texcomp_single_device():
    img = atlas_image(64, seed=5)
    want = np.asarray(jpvrtc4.encode_pvrtc_4bpp_device(jnp.asarray(img)))
    got = tmesh.pvrtc4_encode_atlas_sharded(torch.from_numpy(img),
                                            cpu_mesh(4))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", [tmesh.pvrtc_encode_atlas_sharded,
                                tmesh.pvrtc4_encode_atlas_sharded])
@pytest.mark.parametrize("shape,data,match", [
    ((128, 64, 4), 2, "square"),      # not square
    ((96, 96, 4), 2, "square"),       # not a power of two
    ((64, 64, 3), 2, "square"),       # not RGBA
    ((16, 16, 4), 8, "split evenly"),  # 4 block rows over 8 shards
])
def test_atlas_rejects(fn, shape, data, match):
    img = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        fn(img, cpu_mesh(data))


def test_atlas_rejects_as_texcomp_does():
    """The same shapes raise in both packages."""
    for shape, data in (((128, 64, 4), 8), ((16, 16, 4), 8), ((4, 4, 4), 1)):
        img = np.zeros(shape, np.uint8)
        with pytest.raises(ValueError):
            jmesh.pvrtc_encode_atlas_sharded(jnp.asarray(img), jax_mesh(data))
        with pytest.raises(ValueError):
            tmesh.pvrtc_encode_atlas_sharded(torch.from_numpy(img),
                                             cpu_mesh(data))


def test_atlas_gathers_on_the_first_device():
    img = torch.from_numpy(atlas_image(32))
    out = tmesh.pvrtc_encode_atlas_sharded(img, cpu_mesh(2))
    assert out.device == CPU and out.dtype == torch.uint8
    assert tuple(out.shape) == (32 * 32 // 32, 8)


# ---------------------------------------------------------------------------
# The strip kernels' plain twins against texcomp's halo functions.
# ---------------------------------------------------------------------------


def strip_case(nby: int, nbx: int, seed: int):
    """A strip, its low-res words and foreign halo rows: the rows above and
    below come from other images, so they differ from the strip's wrap."""
    rng = np.random.default_rng(seed)
    strip = rng.integers(0, 256, (4 * nby, 8 * nbx, 4), dtype=np.uint8)
    strip[: 4 * nby // 2 or 1, :, 3] = 255  # opaque and translucent blocks
    origin = rng.integers(0, 256, 4, dtype=np.uint8)
    ab = pc.pvrtc_morph_strip_plain(torch.from_numpy(strip),
                                    torch.from_numpy(origin))
    others = [pc.pvrtc_morph_strip_plain(
        torch.from_numpy(rng.integers(0, 256, (4, 8 * nbx, 4), np.uint8)),
        torch.from_numpy(origin)) for _ in range(2)]
    return strip, origin, ab, others[0], others[1]


def _u32(t: torch.Tensor) -> jax.Array:
    return jnp.asarray(t.numpy().view(np.uint32))


@pytest.mark.parametrize("nby,nbx", [(1, 4), (2, 1), (4, 8), (1, 16)])
def test_morph_strip_twin_matches_texcomp(nby, nbx):
    strip, origin, ab, _, _ = strip_case(nby, nbx, seed=nby * 100 + nbx)
    words = pf._to_block_words(jnp.asarray(strip))
    p00 = jnp.asarray(origin.view(np.uint32).astype(np.int32).reshape(1, 1))
    want = np.asarray(pf._morph_words(words, p00))  # (2, NB) uint32
    np.testing.assert_array_equal(ab.numpy().view(np.uint32), want.T)


@pytest.mark.parametrize("nby,nbx", [(1, 4), (2, 1), (4, 8), (1, 16), (8, 2)])
def test_upscale_modulate_halo_twin_matches_texcomp(nby, nbx):
    strip, _, ab, top, bot = strip_case(nby, nbx, seed=nby * 10 + nbx)
    got = pc.pvrtc_upscale_modulate_halo_plain(
        torch.from_numpy(strip), ab, top, bot)
    words = pf._to_block_words(jnp.asarray(strip))
    ab_u, top_u, bot_u = _u32(ab), _u32(top), _u32(bot)
    va9 = pf._make_var_words(ab_u[:, 0][None], nby, nbx, top_u[:, 0],
                             bot_u[:, 0])
    vb9 = pf._make_var_words(ab_u[:, 1][None], nby, nbx, top_u[:, 1],
                             bot_u[:, 1])
    want = np.asarray(pf._upscale_modulate_body(words, va9, vb9))
    np.testing.assert_array_equal(got.numpy(), want.T)
    # The halo rows matter: the strip's own wrap gives other bytes.
    low = ab.reshape(nby, nbx, 2)
    wrapped = pc.pvrtc_upscale_modulate_halo_plain(
        torch.from_numpy(strip), ab, low[-1], low[0])
    assert not torch.equal(wrapped, got)


def test_upscale_modulate_halo_twin_with_own_wrap_is_the_square_twin():
    img = make_test_image(np.random.default_rng(3), 64, 64, 4)
    t = torch.from_numpy(img)
    ab = pc.pvrtc_morph_plain(t, t[0, 0])
    low = ab.reshape(16, 8, 2)
    np.testing.assert_array_equal(
        pc.pvrtc_upscale_modulate_halo_plain(t, ab, low[-1], low[0]).numpy(),
        pc.pvrtc_upscale_modulate_plain(t[None], ab).numpy())


@pytest.mark.parametrize("nby,nbx", [(1, 4), (2, 1), (4, 8), (1, 16), (8, 2)])
@pytest.mark.parametrize("kind", ["encoded", "random"])
def test_modes_pack_strip_twin_matches_texcomp(nby, nbx, kind):
    strip, _, ab, top, bot = strip_case(nby, nbx, seed=nby * 7 + nbx)
    rng = np.random.default_rng(nby * 13 + nbx)
    if kind == "encoded":
        mod = pc.pvrtc_upscale_modulate_halo_plain(
            torch.from_numpy(strip), ab, top, bot)
    else:
        mod = torch.from_numpy(
            rng.integers(0, 4, (nby * nbx, 32), dtype=np.uint8))
    halo_v = torch.from_numpy(rng.integers(0, 4, (nbx, 8), dtype=np.uint8))
    got = pc.pvrtc_modes_pack_strip_plain(mod, ab, halo_v, nby, nbx)

    mod_j = jnp.asarray(mod.numpy().T.astype(np.int32))  # (32, NB)
    halo_j = jnp.asarray(halo_v.numpy().T.astype(np.int32))  # (8, nbx)
    nh_edge, nv_edge = pf._mode_edges(mod_j, nby, nbx, halo_v=halo_j)
    words = np.asarray(pf._modes_pack_colors_body(
        mod_j, nh_edge, nv_edge, _u32(ab).T))  # (2, NB) uint32
    want = np.ascontiguousarray(words.T).view(np.uint8).reshape(-1, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_modes_pack_strip_twin_with_own_wrap_is_the_square_twin():
    """A whole square image as one strip, its own first row as the halo:
    the square twin's records, row-major."""
    rng = np.random.default_rng(8)
    nby, nbx = 16, 8
    mod = torch.from_numpy(rng.integers(0, 4, (nby * nbx, 32), np.uint8))
    ab = torch.from_numpy(rng.integers(-2**31, 2**31, (nby * nbx, 2),
                                       dtype=np.int64).astype(np.int32))
    got = pc.pvrtc_modes_pack_strip_plain(mod, ab, mod[:nbx, :8], nby, nbx)
    square = pc.pvrtc_modes_pack_plain(mod, ab, nby, nbx)
    perm = torch.from_numpy(pc.pvrtc.zorder_block_permutation(nbx, nby))
    np.testing.assert_array_equal(got[perm.long()].numpy(), square.numpy())


def _zeros(*shape, dtype=torch.uint8):
    return torch.zeros(shape, dtype=dtype)


def test_strip_grid_checks():
    origin = _zeros(4)
    for shape in ((12, 16, 4), (4, 4, 4)):
        with pytest.raises(ValueError, match="power-of-two block grid"):
            pc.pvrtc_morph_strip_plain(_zeros(*shape), origin)
    # A one-block strip is a grid.
    out = pc.pvrtc_morph_strip_plain(_zeros(4, 8, 4), origin)
    assert tuple(out.shape) == (1, 2)


def test_strip_kernels_refuse_cpu_tensors():
    """The kernel wrappers refuse a CPU tensor: no fallback to the twin."""
    ab = _zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pc.pvrtc_upscale_modulate_halo_cuda(_zeros(4, 8, 4), ab, ab, ab)
    with pytest.raises(ValueError, match="CUDA"):
        pc.pvrtc_modes_pack_strip_cuda(_zeros(1, 32), ab, _zeros(1, 8), 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        pc.pvrtc_morph_strip_cuda(_zeros(4, 8, 4), _zeros(4))
