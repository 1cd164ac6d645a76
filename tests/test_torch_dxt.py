"""texcomp_torch DXT codecs and image ops against the JAX package.

The block codecs are held to ``texcomp.codecs.dxt``; each image op's plain
twin (what a CPU tensor runs) is held to the JAX Pallas kernel run in
interpret mode. Tolerance is 0: every step is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texcomp.codecs import dxt as jdxt
from texcomp.ops import dxt_pallas as dp
from texcomp.blocks import full_outside_mask
import texcomp.ops as jops
import texcomp_torch.ops as tops
from texcomp_torch.codecs import dxt as tdxt
from texcomp_torch.ops import _launch, dxt_cuda

H, W = 16, 24  # image ops: 24 blocks, one Pallas grid step


def _random_blocks(rng, n, c):
    """As test_pallas.py: random, constant, near-constant, alpha 0 / 255."""
    px = rng.integers(0, 256, (n, 16, c)).astype(np.int32)
    px[5:10] = px[5:6, 0:1]
    px[10] = 7
    if c == 4:
        px[11:14, :, 3] = 0
        px[14:17, :, 3] = 255
    return px


def _image(rng, h, w, c):
    """Noise with solid 4x4 blocks and alpha bands, so every path runs."""
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    img[:4, :8] = img[0, 0]
    img[4:8, 8:12] = 200
    if c == 4:
        img[8:12, :, 3] = 0
        img[12:16, :8, 3] = 255
    return img


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unblock_u32(px, h, w):
    """(16, N) packed uint32 pixels -> (h, w, 4) uint8, row-major blocks."""
    px = np.asarray(px).T.reshape(h // 4, w // 4, 4, 4)
    img = px.transpose(0, 2, 1, 3).reshape(h, w).copy()
    return img.view(np.uint8).reshape(h, w, 4)


# --- block codecs against texcomp.codecs.dxt (700 blocks) ------------------


@pytest.mark.parametrize("always4", [False, True])
@pytest.mark.parametrize("swap", [False, True])
def test_encode_dxt1_blocks(rng, swap, always4):
    rgb = _random_blocks(rng, 700, 3)
    want = jdxt.encode_dxt1_blocks(jnp.asarray(rgb), always_4_color=always4,
                                   swap_red_and_blue=swap)
    got = tdxt.encode_dxt1_blocks(_t(rgb), always4, swap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("swap", [False, True])
def test_encode_dxt5_blocks(rng, swap):
    rgba = _random_blocks(rng, 700, 4)
    outside = np.zeros(700, dtype=bool)
    outside[33:45] = True
    want = jdxt.encode_dxt5_blocks(jnp.asarray(rgba), jnp.asarray(outside),
                                   swap_red_and_blue=swap)
    got = tdxt.encode_dxt5_blocks(_t(rgba), _t(outside), swap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("always4", [False, True])
def test_decode_dxt1_blocks(rng, always4):
    data = rng.integers(0, 256, (700, 8), dtype=np.uint8)
    data[:50, 2:4] = data[:50, 0:2]  # equal endpoints
    want = jdxt.decode_dxt1_blocks(jnp.asarray(data), always_4_color=always4)
    got = tdxt.decode_dxt1_blocks(_t(data), always4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_dxt5_blocks(rng):
    data = rng.integers(0, 256, (700, 16), dtype=np.uint8)
    data[:50, 1] = data[:50, 0]  # equal alpha endpoints
    want = jdxt.decode_dxt5_blocks(jnp.asarray(data))
    got = tdxt.decode_dxt5_blocks(_t(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["column", "row", "corner"])
@pytest.mark.parametrize("codec,bs", [("dxt1", 8), ("dxt5", 16)])
def test_pad_functors(rng, codec, bs, kind):
    blocks = rng.integers(0, 256, (37, bs), dtype=np.uint8)
    name = f"{codec}_{kind}_pad_blocks"
    np.testing.assert_array_equal(getattr(tdxt, name)(blocks),
                                  getattr(jdxt, name)(blocks))


# --- image ops (plain twins) against the Pallas kernels, interpret mode ----


def test_dxt1_encode_image(rng):
    img = _image(rng, H, W, 3)
    want = dp.dxt1_encode_image(jnp.asarray(img), interpret=True)
    got = dxt_cuda.dxt1_encode_image(_t(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("always4", [False, True])
@pytest.mark.parametrize("swap", [False, True])
def test_dxt1_encode_image_flags(rng, swap, always4):
    img = _image(rng, H, W, 3)
    words = dp.pack_rgb_image(jnp.asarray(img), swap)
    want = dp.encode_dxt1_packed(words, always4=always4, swap=swap,
                                 interpret=True)
    got = dxt_cuda.dxt1_encode_image(_t(img), swap=swap, always4=always4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)


@pytest.mark.parametrize("swap", [False, True])
def test_dxt5_encode_image(rng, swap):
    img = _image(rng, H, W, 4)
    if swap:
        words = np.asarray(dp.pack_rgba_image(jnp.asarray(img), swap=True))
        w17 = np.concatenate([words, np.zeros((1, words.shape[1]), np.uint32)])
        want = np.asarray(dp.encode_dxt5_packed(jnp.asarray(w17), swap=True,
                                                interpret=True)).T
    else:
        want = np.asarray(dp.dxt5_encode_image(jnp.asarray(img), interpret=True))
    got = dxt_cuda.dxt5_encode_image(_t(img), swap=swap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("is_dxt1", [True, False])
def test_dxtc_encode_padded_image(rng, is_dxt1, swap):
    """The compress-and-pad route, as test_pallas.py checks the fused
    pipeline: edge-pad, pack, flag has_one_pixel blocks, encode."""
    h, w, gh, gw = 10, 14, 16, 24
    c = 3 if is_dxt1 else 4
    img = _image(rng, h, w, c)
    padded = np.pad(img, ((0, gh - h), (0, gw - w), (0, 0)), mode="edge")
    if is_dxt1:
        words = dp.pack_rgb_image(jnp.asarray(padded), swap)
        want = dp.encode_dxt1_packed(words, swap=swap, interpret=True)
    else:
        words = np.asarray(dp.pack_rgba_image(jnp.asarray(padded), swap))
        outside = full_outside_mask(h, w, gh, gw)
        assert outside.any()
        w17 = np.concatenate([words, outside.astype(np.uint32)[None, :]])
        want = dp.encode_dxt5_packed(jnp.asarray(w17), swap=swap,
                                     interpret=True)
    got = dxt_cuda.dxtc_encode_padded_image(_t(img), gh, gw, swap, is_dxt1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)


@pytest.mark.parametrize("swap", [False, True])
def test_dxt1_decode_image(rng, swap):
    data = rng.integers(0, 256, (H * W // 16, 8), dtype=np.uint8)
    want = dp.dxt1_decode_image(jnp.asarray(data), height=H, width=W,
                                swap=swap, interpret=True)
    got = dxt_cuda.dxt1_decode_image(_t(data), height=H, width=W, swap=swap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("swap", [False, True])
def test_dxt1_decode_image_always4(rng, swap):
    data = rng.integers(0, 256, (H * W // 16, 8), dtype=np.uint8)
    px = dp.decode_dxt1_packed(dp.blocks_to_words(jnp.asarray(data), 2),
                               always4=True, swap=swap, interpret=True)
    got = dxt_cuda.dxt1_decode_image(_t(data), height=H, width=W, swap=swap,
                                     always4=True)
    np.testing.assert_array_equal(got.numpy(), _unblock_u32(px, H, W))


@pytest.mark.parametrize("swap", [False, True])
def test_dxt5_decode_image(rng, swap):
    data = rng.integers(0, 256, (H * W // 16, 16), dtype=np.uint8)
    want = dp.dxt5_decode_image(jnp.asarray(data), height=H, width=W,
                                swap=swap, interpret=True)
    got = dxt_cuda.dxt5_decode_image(_t(data), height=H, width=W, swap=swap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ops_module(rng):
    """texcomp_torch.ops: encode as texcomp.ops does on the CPU, decode to
    the (H, W, 4) image that the accelerator route of texcomp.ops gives."""
    rgb, rgba = _image(rng, H, W, 3), _image(rng, H, W, 4)
    np.testing.assert_array_equal(
        tops.dxt1_encode_image_op(_t(rgb)).numpy(),
        np.asarray(jops.dxt1_encode_image_op(jnp.asarray(rgb))))
    np.testing.assert_array_equal(
        tops.dxt5_encode_image_op(_t(rgba)).numpy(),
        np.asarray(jops.dxt5_encode_image_op(jnp.asarray(rgba))))
    data = rng.integers(0, 256, (H * W // 16, 8), dtype=np.uint8)
    got = tops.dxt1_decode_image_op(_t(data), H, W)
    assert got.shape == (H, W, 4)
    want = dp.dxt1_decode_image(jnp.asarray(data), height=H, width=W,
                                interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the kernel wrappers refuse what they cannot launch --------------------


@pytest.mark.parametrize("name", ["dxt1_encode", "dxt5_encode", "dxt1_decode",
                                  "dxt5_decode", "dxtc_downsample"])
def test_kernel_wrapper_refuses_cpu_tensor(name):
    """A kernel wrapper launches on a CUDA tensor or raises; it never runs
    the plain version instead, and counts no launch."""
    before = dict(_launch.LAUNCHES)
    if name.endswith("encode"):
        args = (torch.zeros((8, 8, 4), dtype=torch.uint8), 8, 8)
    elif name == "dxtc_downsample":
        args = (torch.zeros((4, 8), dtype=torch.uint8), 2, 2, True)
    else:
        args = (torch.zeros((4, 8 if name == "dxt1_decode" else 16),
                            dtype=torch.uint8), 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(dxt_cuda, f"{name}_cuda")(*args)
    assert _launch.LAUNCHES == before
