"""texcomp_torch core and block grid against the JAX package, byte for byte.

Tolerance is 0 throughout: every step is integer arithmetic. Inputs are
numpy arrays handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texcomp.blocks import grid as jgrid
from texcomp.core import colors as jc
from texcomp.core.constants import DXTC_CONST_COLOR_TABLE as JAX_LUT
from texcomp_torch.blocks import grid as tgrid
from texcomp_torch.core import colors as tc
from texcomp_torch.core.constants import DXTC_CONST_COLOR_TABLE


def test_const_color_table_equals_texcomp():
    assert DXTC_CONST_COLOR_TABLE.dtype == np.uint8
    np.testing.assert_array_equal(DXTC_CONST_COLOR_TABLE, JAX_LUT)


_V = np.arange(256, dtype=np.int32)
_A, _B = (m.reshape(-1) for m in np.meshgrid(_V, _V, indexing="ij"))
_R6 = np.random.default_rng(5).integers(0, 256, (6, 50_000)).astype(np.int32)


def _fn(name, *static):
    """A case calling ``module.name(*args, *static)`` for either package."""
    return lambda m: lambda *args: getattr(m, name)(*args, *static)


def _combine(s0, s1):
    return lambda m: lambda a, b: m.combine_int_fast(s0, s1, a, b)


_C32 = np.arange(32, dtype=np.int32)
# case -> (function of the colors module, numpy int32 arguments)
_COLOR_CASES = {
    "div_trunc": (_fn("div_trunc", 7), (np.arange(-2000, 2001, dtype=np.int32),)),
    "quantize8_fast_5": (_fn("quantize8_fast", 5), (_V,)),
    "quantize8_fast_6": (_fn("quantize8_fast", 6), (_V,)),
    "quantize8_4": (_fn("quantize8", 4), (_V,)),
    "quantize8_5": (_fn("quantize8", 5), (_V,)),
    "quantize8_6": (_fn("quantize8", 6), (_V,)),
    "quantize_to_565": (_fn("quantize_to_565"), (_A, _B, _A[::-1].copy())),
    "extend_4bit": (_fn("extend_4bit"), (np.arange(16, dtype=np.int32),)),
    "extend_5bit": (_fn("extend_5bit"), (_C32,)),
    "extend565_r": (_fn("extend565_r"), (_C32,)),
    "extend565_g": (_fn("extend565_g"), (np.arange(64, dtype=np.int32),)),
    "extend565_b": (_fn("extend565_b"), (_C32,)),
    "to_uint16_565": (_fn("to_uint16_565"), tuple(
        m.reshape(-1).astype(np.int32) for m in np.meshgrid(
            np.arange(32), np.arange(64), np.arange(32), indexing="ij"))),
    "from_uint16_565": (_fn("from_uint16_565"), (np.arange(1 << 16, dtype=np.int32),)),
    "clamp8": (_fn("clamp8"), (np.arange(-300, 600, dtype=np.int32),)),
    "combine_int_fast_2_1": (_combine(2, 1), (_A, _B)),
    "combine_int_fast_1_1": (_combine(1, 1), (_A, _B)),
    "combine_int_fast_6_1": (_combine(6, 1), (_A, _B)),
    "combine_int_fast_negative": (_combine(1, 2), (_A - 255, _B)),
    "average4_fast": (_fn("average4_fast"), (_A, _B, _B[::-1].copy(), _A[::-1].copy())),
    "compute_luminance_fast": (_fn("compute_luminance_fast"), (_A, _B, _A[::-1].copy())),
    "compute_squared_luminance_distance_fast": (
        _fn("compute_squared_luminance_distance_fast"), tuple(_R6)),
    "compute_difference_luminance_fast": (
        _fn("compute_difference_luminance_fast"), tuple(_R6)),
    "compute_squared_component_distance": (
        _fn("compute_squared_component_distance"), (_A, _B)),
}


@pytest.mark.parametrize("name", sorted(_COLOR_CASES))
def test_colors_equal_texcomp(name):
    """Each color function over full 0..255 grids (random samples for the
    six-channel distances)."""
    case, args = _COLOR_CASES[name]
    want = case(jc)(*(jnp.asarray(a) for a in args))
    got = case(tc)(*(torch.from_numpy(a) for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


_GRIDS = [
    (4, 4, None, None),
    (5, 7, None, None),
    (57, 33, None, None),
    (2, 5, None, None),
    (10, 14, 16, 24),
    (1, 1, 8, 12),
    (13, 6, 28, 20),
]


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("h,w,gh,gw", _GRIDS)
def test_extract_blocks_equals_texcomp(rng, h, w, gh, gw, c):
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    want = jgrid.extract_blocks(jnp.asarray(img), height=h, width=w,
                                grid_height=gh, grid_width=gw)
    got = tgrid.extract_blocks(torch.from_numpy(img), height=h, width=w,
                               grid_height=gh, grid_width=gw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w", [(4, 4), (8, 12), (57, 33), (2, 5)])
def test_image_to_blocks_and_scatter_equal_texcomp(rng, h, w):
    nb = tgrid.num_blocks(h) * tgrid.num_blocks(w)
    blocks = rng.integers(0, 256, (nb, 16, 3)).astype(np.int32)
    want = jgrid.scatter_blocks(jnp.asarray(blocks), height=h, width=w)
    got = tgrid.scatter_blocks(torch.from_numpy(blocks), height=h, width=w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if h % 4 == 0 and w % 4 == 0:
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        np.testing.assert_array_equal(
            tgrid.image_to_blocks(torch.from_numpy(img)).numpy(),
            np.asarray(jgrid.image_to_blocks(jnp.asarray(img))))


@pytest.mark.parametrize("h,w,gh,gw", [g for g in _GRIDS if g[2]] + [(57, 33, 57, 33)])
def test_full_outside_mask_equals_texcomp(h, w, gh, gw):
    got = tgrid.full_outside_mask(h, w, gh, gw, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jgrid.full_outside_mask(h, w, gh, gw))
