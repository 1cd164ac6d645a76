"""The ``pvrtc4k.hq`` benchmark cell's comparison on the CPU: the port's
``Pvrtc4bppCompressor("high").compress`` on the cell's own banded images
(``texbench.inputs``, the configuration's layout at smaller sides) equals
the frozen plain-PyTorch reference (``texbench.reference``) byte for
byte, payload and ``Metadata``. On the card the benchmark makes the same
comparison at 1024x1024 after every run."""

import json

import pytest
import torch

from texbench import drive, inputs
from texbench.manifest import HERE
from texbench.reference import images as ref
from texcomp_torch import CompressedImage, Format, Pvrtc4bppCompressor

CONFIG = json.loads((HERE / "configs" / "pvrtc4k.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager HQ fit is thousands of small ops; one intra-op thread keeps
    them from stalling on each other when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_configuration_is_hq_pvrtc_4bpp_rgba():
    assert (CONFIG["codec"], CONFIG["quality"], CONFIG["channels"]) == (
        "pvrtc4", "high", 4)
    assert ref.CODECS[CONFIG["codec"]] == ("pvrtc4", Format.RGBA.value, 4)


@pytest.mark.parametrize("side,seed", [(64, 3200002101), (128, 3200002102)])
def test_hq_compress_equals_the_frozen_reference(side, seed):
    config = {**CONFIG, "side": side}
    comp = Pvrtc4bppCompressor("high", device="cpu")
    for img in inputs.request_pool(config, 2, seed, "cpu"):
        assert img.shape == (side, side, 4)
        ci = CompressedImage()
        assert comp.compress(Format.RGBA, side, side, 0, img.tobytes(), ci)
        md, payload = drive.kept(ci)
        assert md == ref.metadata("pvrtc4", side, side)
        want = ref.encode("pvrtc4", torch.from_numpy(img), quality="high")
        assert payload.tobytes() == want.numpy().tobytes()
