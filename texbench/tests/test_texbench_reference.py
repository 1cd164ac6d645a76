"""The frozen reference equals the port's plain twins on the CPU at small
sizes (the test may import the port; the reference may not)."""

import json

import numpy as np
import pytest
import torch

from texbench import inputs
from texbench.manifest import HERE
from texbench.reference import images as ref
from texbench.reference import pvrtc4 as ref_pvrtc4
from texbench.reference import pvrtc_hq as ref_pvrtc_hq
from texcomp_torch import (CompressedImage, CompressionStrategy,
                           DxtcCompressor, EtcCompressor, Format,
                           Pvrtc4bppCompressor, PvrtcCompressor)
from texcomp_torch.blocks import image_to_blocks
from texcomp_torch.codecs import dxt_hq, pvrtc, pvrtc4, pvrtc_hq
from texcomp_torch.ops import dxt_cuda, etc_cuda, pvrtc_cuda

CONTENT = json.loads((HERE / "configs" / "fleet5.json").read_text())["content"]


def images(side: int, c: int, seed: int = 3, width: int | None = None):
    gen = torch.Generator().manual_seed(seed)
    w = side if width is None else width
    out = [inputs.make_image(gen, kind, side, w, c, CONTENT, "cpu")
           for kind in ("banded", "noise")]
    out.append(np.zeros((side, w, c), np.uint8))  # all-zero axes
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
        assert torch.equal(ref.encode("pvrtc4", img),
                           pvrtc4.encode_pvrtc_4bpp(img))


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


def test_pvrtc_decodes():
    """The 2bpp and 4bpp decodes inside the HQ PVRTC references' best-of
    equal the port's on random records."""
    rng = np.random.default_rng(6)
    for nb, fn, want_fn in ((128, ref_pvrtc_hq.decode_pvrtc_2bpp,
                             pvrtc.decode_pvrtc_2bpp),
                            (256, ref_pvrtc4.decode_pvrtc_4bpp,
                             pvrtc4.decode_pvrtc_4bpp)):
        data = torch.from_numpy(rng.integers(0, 256, (nb, 8), dtype=np.uint8))
        assert torch.equal(fn(data, 64, 64), want_fn(data, 64, 64))


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


#: (codec, channels, the port's plain twin of an image, its compressor,
#: format): the HQ pairs the request client takes besides HQ ETC1.
HQ = {"dxt1": (3, dxt_hq.encode_dxt1_hq_image, DxtcCompressor, Format.RGB),
      "dxt5": (4, dxt_hq.encode_dxt5_hq_image, DxtcCompressor, Format.RGBA),
      "pvrtc": (4, pvrtc_hq.encode_pvrtc_2bpp_hq, PvrtcCompressor,
                Format.RGBA),
      "pvrtc4": (4, pvrtc_hq.encode_pvrtc_4bpp_hq, Pvrtc4bppCompressor,
                 Format.RGBA)}


@pytest.mark.parametrize("codec,h,w", [("dxt1", 64, 64), ("dxt1", 32, 96),
                                       ("dxt5", 64, 64), ("dxt5", 32, 96),
                                       ("pvrtc", 64, 64), ("pvrtc4", 64, 64)])
def test_hq_equals_the_ports_twin(codec, h, w):
    """The frozen HQ reference equals the port's plain twin byte for byte,
    and the port's compress() of the first image, on banded, noise and
    all-zero images."""
    c, twin, comp, fmt = HQ[codec]
    imgs = images(h, c, seed=7, width=w)
    for img in imgs:
        assert torch.equal(ref.encode(codec, img, quality="high"), twin(img))
    ci = CompressedImage()
    assert comp("high", device="cpu").compress(fmt, h, w, 0, imgs[0].numpy(),
                                               ci)
    want = ref.encode(codec, imgs[0], quality="high").numpy().reshape(-1)
    assert np.array_equal(ci.get_data(), want)
    md = ci.get_metadata()
    assert ref.metadata(codec, h, w) == (
        int(md.format), md.compressor_name, md.uncompressed_height,
        md.uncompressed_width, md.compressed_height, md.compressed_width,
        md.padding_bytes_per_row)


def test_every_codec_has_a_reference_at_each_quality():
    assert set(ref.ENCODERS) == {(c, q) for c in ref.CODECS
                                 for q in ("reference", "high")}
