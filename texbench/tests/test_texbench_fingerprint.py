"""Every seed does the same work: the same shapes in the same order, the
same content classes on the same blocks, and pixel values that stay
inside their class, in every cell, for seeds 0-11, at the cells' own
sizes."""

import functools

import numpy as np
import pytest

from texbench import drive, inputs
from texbench.manifest import Manifest

from cells import NAMES, cell as cell_named

MAN = Manifest()
SEEDS = range(12)


def _layout_holds(img: np.ndarray, kind: str, content: dict) -> bool:
    """The image obeys its layout: solid tiles constant, near tiles within
    +-near of one colour, the gradient exact and, with alpha, the alpha
    pattern exact outside the noise band."""
    if kind == "noise":
        return True
    h, w, c = img.shape
    tile, near, bands = content["tile"], content["near"], content["bands"]
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    rgb = img[..., :3].astype(np.int16)
    for b, name in enumerate(bands):
        r0, r1 = inputs.band_rows(h, len(bands), b)
        part = rgb[r0:r1]
        if name == "gradient":
            want = np.stack([np.broadcast_to(x * 255 // (w - 1), (h, w)),
                             np.broadcast_to(y * 255 // (h - 1), (h, w)),
                             (x + y) % 2 * 255], axis=-1)[r0:r1]
            if not np.array_equal(part, want):
                return False
        elif name in ("solid", "near"):
            for ty in range((r0 // tile) * tile, r1, tile):
                for tx in range(0, w, tile):
                    t = rgb[max(ty, r0):min(ty + tile, r1), tx:tx + tile]
                    spread = t.max(axis=(0, 1)) - t.min(axis=(0, 1))
                    if spread.max() > (0 if name == "solid" else 2 * near):
                        return False
        if c == 4 and name != "noise":
            third = x * 3 // w
            alpha = np.where(third == 0, 0,
                             np.where(third == 1, 255, x * 255 // (w - 1)))
            if not np.array_equal(img[r0:r1, :, 3],
                                  np.broadcast_to(alpha, (r1 - r0, w))):
                return False
    return True


def _solid_blocks(img: np.ndarray) -> int:
    """4x4 blocks whose 16 pixels are equal, counted from the data."""
    h, w, c = img.shape
    b = img.reshape(h // 4, 4, w // 4, 4, c)
    return int((b == b[:, :1, :, :1]).all(axis=(1, 3, 4)).sum())


@functools.lru_cache(maxsize=None)
def fingerprint(cell: str, seed: int):
    """(shape sequence, per-key work) of one cell's inputs for one seed."""
    c = cell_named(cell)
    return inputs_fingerprint(MAN.config(c["config"]),
                              MAN.traffic(c["traffic"]), seed)


def inputs_fingerprint(config: dict, mix: dict, seed: int):
    content = config["content"]
    if mix["entry"] == "compress":
        pool = inputs.request_pool(config, mix["pool"], seed, "cpu")
        assert all(_layout_holds(im, config["kind"], content) for im in pool)
        shapes = tuple(im.shape for im in pool)
        classes = inputs.block_classes(config["kind"], config["side"],
                                       config["side"], content)
        work = {"pixels": sum(im.shape[0] * im.shape[1] for im in pool),
                "classes": tuple(sorted(classes.items())),
                "solid_blocks": tuple(_solid_blocks(im) for im in pool)}
        return shapes, work
    meta, pools = inputs.fleet_assets(config, seed, "cpu")
    kinds = config["pool"]
    for (codec, side, j), img in pools.items():
        assert img.shape[:2] == (side, side)
        assert _layout_holds(img, kinds[j], content), (codec, side, j)
    sequence = tuple(drive.entry_names(meta, mix["mipmaps"]))
    solid = {key: _solid_blocks(img) for key, img in pools.items()}
    work: dict = {}
    for name, codec, _, key in meta:
        img = pools[key]
        entry = work.setdefault((codec, key[1]), {"pixels": 0, "classes": {},
                                                  "solid_blocks": 0})
        entry["pixels"] += img.shape[0] * img.shape[1]
        entry["solid_blocks"] += solid[key]
        for k, n in inputs.block_classes(kinds[key[2]], *img.shape[:2],
                                         content).items():
            entry["classes"][k] = entry["classes"].get(k, 0) + n
    return sequence, {k: (v["pixels"], tuple(sorted(v["classes"].items())),
                          v["solid_blocks"]) for k, v in work.items()}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", NAMES)
def test_every_seed_does_the_same_work(cell, seed):
    assert fingerprint(cell, seed) == fingerprint(cell, 0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("codec,channels", [("dxt1", 3), ("dxt5", 4),
                                            ("pvrtc", 4), ("pvrtc4", 4)])
def test_every_seed_of_each_codec_does_the_same_work(codec, channels, seed):
    """A request configuration of any codec: a pool of the channels that
    codec encodes, the same work for every seed."""
    config = {**MAN.config("etc1k"), "side": 64, "codec": codec}
    del config["channels"]
    mix = MAN.traffic("api_hq")
    got = inputs_fingerprint(config, mix, seed)
    assert got == inputs_fingerprint(config, mix, 0)
    assert got[0] == ((64, 64, channels),) * mix["pool"]


def test_seeds_change_the_pixels():
    config = MAN.config("etc1k")
    a = inputs.request_pool(config, 1, 0, "cpu")[0]
    b = inputs.request_pool(config, 1, 1, "cpu")[0]
    assert not np.array_equal(a, b)


def test_the_fleet_is_config_5():
    sequence, work = fingerprint("fleet5.ref", 0)
    assert len(sequence) == 9984
    assert sum(p for p, _, _ in work.values()) == 1_308_622_848
    assert len(fingerprint("fleet5.mip", 0)[0]) == 62_880
