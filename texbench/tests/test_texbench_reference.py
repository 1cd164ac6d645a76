"""The frozen reference equals the port's plain twins on the CPU at small
sizes (the test may import the port; the reference may not)."""

import json

import numpy as np
import pytest
import torch

from texbench import inputs
from texbench.manifest import HERE
from texbench.reference import images as ref
from texcomp_torch import (CompressedImage, CompressionStrategy,
                           DxtcCompressor, EtcCompressor, Format)
from texcomp_torch.blocks import image_to_blocks
from texcomp_torch.ops import dxt_cuda, etc_cuda, pvrtc_cuda

CONTENT = json.loads((HERE / "configs" / "fleet5.json").read_text())["content"]


def images(side: int, c: int, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    out = [inputs.make_image(gen, kind, side, side, c, CONTENT, "cpu")
           for kind in ("banded", "noise")]
    out.append(np.zeros((side, side, c), np.uint8))  # all-zero axes
    return [torch.from_numpy(x) for x in out]


@pytest.mark.parametrize("side", [8, 64, 128])
def test_encodes(side):
    for img in images(side, 3):
        assert torch.equal(ref.encode("dxt1", img),
                           dxt_cuda.dxt1_encode_image(img))
        for strategy in (2, 3):
            assert torch.equal(ref.encode("etc1", img, strategy),
                               etc_cuda.etc1_encode_image(img, strategy))
    for img in images(side, 4):
        assert torch.equal(ref.encode("dxt5", img),
                           dxt_cuda.dxt5_encode_image(img))
        assert torch.equal(ref.encode("pvrtc", img),
                           pvrtc_cuda.pvrtc_encode_image(img))


def test_decodes():
    rng = np.random.default_rng(5)
    nb = 64
    for codec, bb, fn in (("dxt1", 8, dxt_cuda.dxt1_decode_image),
                          ("dxt5", 16, dxt_cuda.dxt5_decode_image),
                          ("etc1", 8, etc_cuda.etc1_decode_image)):
        data = torch.from_numpy(rng.integers(0, 256, (nb, bb), dtype=np.uint8))
        got = ref.decode(codec, data, 8, 8)
        want = fn(data, height=32, width=32)[..., :got.shape[-1]]
        assert torch.equal(got, want)


@pytest.mark.parametrize("side", [64, 128])
def test_chains_equal_the_api(side):
    for codec, comp, fmt, c in (
            ("dxt1", DxtcCompressor(device="cpu"), Format.RGB, 3),
            ("dxt5", DxtcCompressor(device="cpu"), Format.RGBA, 4),
            ("etc1", EtcCompressor(device="cpu"), Format.RGB, 3)):
        img = images(side, c)[0]
        ci = CompressedImage()
        assert comp.compress(fmt, side, side, 0, img.numpy(), ci)
        got = comp.downsample_chain(ci)
        want = ref.chain(codec, ref.encode(codec, img), side, side)
        assert len(got) == len(want) == len(ref.chain_extents(side, side))
        for g, (payload, h, w) in zip(got, want):
            md = g.get_metadata()
            assert (md.uncompressed_height, md.uncompressed_width) == (h, w)
            assert ref.metadata(codec, h, w)[2:] == (
                h, w, md.compressed_height, md.compressed_width, 0)
            assert np.array_equal(g.get_data(), payload.numpy().reshape(-1))


def test_hq_etc1():
    img = images(32, 3)[0]
    want = etc_cuda.etc1_hq_encode_blocks(image_to_blocks(img)[:, :, :3])
    assert torch.equal(ref.encode("etc1", img, quality="high"), want)
    comp = EtcCompressor(CompressionStrategy.SMALLER_ERROR, quality="high",
                         device="cpu")
    ci = CompressedImage()
    assert comp.compress(Format.RGB, 32, 32, 0, img.numpy(), ci)
    assert np.array_equal(ci.get_data(), want.numpy().reshape(-1))
