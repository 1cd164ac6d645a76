"""Seeded inputs whose work does not depend on the seed.

A configuration fixes the layout of every image: its shape, and for a
"banded" image the horizontal bands of content classes (solid 32x32
tiles, the same tiles with +-2 noise, a gradient with a checkerboard,
uniform noise) and, with four channels, the alpha pattern (0, 255 and a
ramp in column thirds, noise alpha in the noise band); a "noise" image is
uniform noise. The seed draws only the pixel values inside those classes:
the tile colours, the +-2 offsets and the noise. Every seed therefore
gives the same shapes, the same classes on the same blocks and the same
request order (a copy of ``chip_smoke.make_image`` and
``chip_smoke.pipeline_fleet``, rewritten so that nothing else depends on
the seed).

Images are drawn on ``device`` with one ``torch.Generator`` and returned
as host arrays, which is what users of the port hand it.
"""

from __future__ import annotations

import numpy as np
import torch

from texbench.reference.images import CODECS


def band_rows(h: int, n: int, b: int) -> tuple[int, int]:
    return b * h // n, (b + 1) * h // n


def make_image(gen: torch.Generator, kind: str, h: int, w: int, c: int,
               content: dict, device) -> np.ndarray:
    """One (h, w, c) uint8 image of layout ``kind`` ("banded" | "noise")."""
    if kind == "noise":
        return torch.randint(0, 256, (h, w, c), generator=gen, device=device,
                             dtype=torch.uint8).cpu().numpy()
    tile, near = content["tile"], content["near"]
    bands = content["bands"]
    y = torch.arange(h, device=device)[:, None]
    x = torch.arange(w, device=device)[None, :]
    tiles = torch.randint(0, 256, (-(-h // tile), -(-w // tile), c),
                          generator=gen, device=device, dtype=torch.int16)
    solid = tiles.repeat_interleave(tile, 0).repeat_interleave(tile, 1)[:h, :w]
    offset = torch.randint(-near, near + 1, (h, w, c), generator=gen,
                           device=device, dtype=torch.int16)
    noise = torch.randint(0, 256, (h, w, c), generator=gen, device=device,
                          dtype=torch.int16)
    grad = torch.zeros((h, w, c), dtype=torch.int16, device=device)
    grad[..., 0] = x * 255 // max(1, w - 1)
    grad[..., 1] = y * 255 // max(1, h - 1)
    grad[..., 2] = (x + y) % 2 * 255
    by_class = {"solid": solid, "near": (solid + offset).clamp(0, 255),
                "gradient": grad, "noise": noise}
    img = torch.empty((h, w, c), dtype=torch.int16, device=device)
    for b, name in enumerate(bands):
        r0, r1 = band_rows(h, len(bands), b)
        img[r0:r1] = by_class[name][r0:r1]
    if c == 4:
        third = x * 3 // w
        ramp = (x * 255 // max(1, w - 1)).to(torch.int16)
        alpha = torch.where(third == 0, 0, torch.where(third == 1, 255, ramp))
        for b, name in enumerate(bands):
            r0, r1 = band_rows(h, len(bands), b)
            img[r0:r1, :, 3] = (noise[r0:r1, :, 3] if name == "noise"
                                else alpha.to(torch.int16).expand(r1 - r0, w))
    return img.to(torch.uint8).cpu().numpy()


def block_classes(kind: str, h: int, w: int, content: dict) -> dict:
    """Blocks (4x4) of each content class in an image of this layout."""
    if kind == "noise":
        return {"noise": (h // 4) * (w // 4)}
    bands = content["bands"]
    out: dict = {}
    for b, name in enumerate(bands):
        r0, r1 = band_rows(h, len(bands), b)
        out[name] = out.get(name, 0) + (r1 - r0) // 4 * (w // 4)
    return out


def fleet_layout(config: dict):
    """[(codec, strategy, channels, side, count, pool kinds)] in the order
    the assets are made: sizes outer, codecs inner."""
    return [(c["codec"], c.get("strategy", 2), c["channels"], side, count,
             tuple(config["pool"]))
            for side, count in config["sizes"] for c in config["codecs"]]


def fleet_assets(config: dict, seed: int, device):
    """(assets, pools) of a fleet configuration: per (codec, side) a pool of
    images of the configured kinds, and ``count`` assets drawing from it in
    turn (asset i takes pool image i % len(pool)). ``assets`` are
    ``(name, codec, strategy, pool key)``; ``pools`` maps a pool key
    (codec, side, j) to its (side, side, channels) uint8 image."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    assets, pools = [], {}
    for codec, strategy, ch, side, count, kinds in fleet_layout(config):
        for j, kind in enumerate(kinds):
            pools[(codec, side, j)] = make_image(gen, kind, side, side, ch,
                                                 config["content"], device)
        assets += [(f"{codec}_{side}_{i}", codec, strategy,
                    (codec, side, i % len(kinds))) for i in range(count)]
    return assets, pools


def request_pool(config: dict, pool: int, seed: int, device) -> list:
    """The ``pool`` images a request stream cycles through, in order, with
    the channels the configuration's codec encodes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    side, ch = config["side"], CODECS[config["codec"]][2]
    return [make_image(gen, config["kind"], side, side, ch, config["content"],
                       device) for _ in range(pool)]
