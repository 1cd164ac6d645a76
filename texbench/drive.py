"""The general traffic generator: one closed-loop client driving one of
the port's entry points, as a traffic mix file says, and the comparison
of every answer it keeps with the plain reference.

A mix names its ``entry``:

  * ``pipeline.run``: ``AssetPipeline.run`` passes over a fleet
    configuration (``mipmaps`` as the mix says), back to back. After each
    pass the client copies a sample of its entries into one buffer, every
    ``sample_every``-th expected entry name from an offset drawn from the
    seed and moved on by one each pass, so that ``sample_every`` passes
    together hold every entry once; the pass's own objects are dropped,
    as a build farm drops what it has written out.
  * ``compress``: one ``compress()`` request after another through an
    ``EtcCompressor`` of the configuration's strategy and quality on RGB
    images (the only codec a request cell has yet; another needs its own
    reference too), cycling through a pool of ``pool`` images in a fixed
    order. Every answer is kept.

A unit of work is one pass or one request. The comparison runs after the
window, on the reference's own encodes of the same inputs.
"""

from __future__ import annotations

import gc
import numpy as np
import torch

from texbench import inputs
from texbench.reference import images as ref

def md_tuple(md) -> tuple:
    """A Metadata's fields as ``reference.images.metadata`` gives them."""
    return (int(md.format), md.compressor_name, md.uncompressed_height,
            md.uncompressed_width, md.compressed_height, md.compressed_width,
            md.padding_bytes_per_row)


def kept(ci) -> tuple:
    """What the comparison reads of a request's answer: (metadata, a copy
    of the payload)."""
    return md_tuple(ci.get_metadata()), ci.get_data().copy()


def kept_sample(out: dict, names: list) -> dict:
    """name -> (metadata, payload) of the sampled entries of one pass, the
    payloads copied into one buffer (None where an entry is missing).

    Keeping the program's own containers would leave blocks pinned all
    over the host heap: a window that kept an eighth of each mip pass's
    containers ran at about half the rate of one that kept a
    sixty-fourth (measured on one H100). One buffer a pass leaves the heap
    as the program left it, and neither the tuples nor the buffer's views
    are objects the garbage collector scans."""
    found = [(n, out[n]) for n in names if n in out]
    buf = np.empty(sum(ci.get_data_size() for _, ci in found), np.uint8)
    sample = dict.fromkeys(names)
    off = 0
    for n, ci in found:
        size = ci.get_data_size()
        view = buf[off:off + size]
        view[:] = ci.get_data()
        sample[n] = (md_tuple(ci.get_metadata()), view)
        off += size
    return sample


def _wrong(got: tuple, md: tuple, payload: np.ndarray) -> tuple[bool, bool]:
    """(payload differs, metadata differs) of one kept answer."""
    data = got[1].reshape(-1)
    return (data.shape != payload.shape or not np.array_equal(data, payload),
            got[0] != md)


def entry_names(meta: list, mipmaps: bool) -> list:
    """Every entry a pass over the assets ``meta`` returns, in a fixed
    order: the assets, then each DXT and ETC1 asset's mip levels."""
    names = [name for name, *_ in meta]
    if mipmaps:
        for name, codec, _, (_, side, _) in meta:
            if codec != "pvrtc":
                n = len(ref.chain_extents(side, side))
                names += [f"{name}_mip{lvl}" for lvl in range(1, n + 1)]
    return names


class Fleet:
    """``AssetPipeline.run`` passes over a fleet configuration."""

    label = "texbench.fleet.run"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from texcomp_torch.dist.pipeline import AssetPipeline, TextureAsset

        self.config, self.mix, self.device = config, mix, torch.device(device)
        self.mipmaps = bool(mix["mipmaps"])
        self.meta, self.pools = inputs.fleet_assets(config, seed, device)
        self.assets = [TextureAsset(name, self.pools[key], codec,
                                    strategy=strategy)
                       for name, codec, strategy, key in self.meta]
        p = config["pipeline"]
        self.pipe = AssetPipeline(batch_size=p["batch_size"],
                                  max_inflight=p["max_inflight"],
                                  device=device)
        self.mpix = sum(a.image.shape[0] * a.image.shape[1]
                        for a in self.assets) / 1e6
        self.names = entry_names(self.meta, self.mipmaps)
        every = mix["sample_every"]
        self._samples = [self.names[k::every] for k in range(every)]
        self._offset = seed % every
        self.kept: list = []   # per pass: (entries returned, sampled entries)

    def warm(self) -> None:
        """``warmup`` passes as the window makes them, answers dropped."""
        for _ in range(self.mix["warmup"]):
            self.unit()
        self.kept.clear()

    def unit(self) -> None:
        out = self.pipe.run(self.assets, mipmaps=self.mipmaps)
        names = self._samples[(self._offset + len(self.kept))
                              % len(self._samples)]
        self.kept.append((len(out), kept_sample(out, names)))

    def stage_times(self):
        """Turn the pipeline's own stage timing on (traced span only)."""
        from texcomp_torch.dist.pipeline import StageTimes

        self.pipe.stage_times = StageTimes()
        return self.pipe.stage_times

    def stage_times_off(self) -> None:
        self.pipe.stage_times = None

    def release(self) -> None:
        """Drop the program's state; the kept answers stay."""
        self.pipe = self.assets = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, control: bool = False) -> dict:
        """Entry name -> (metadata, payload) from the reference's own
        encodes of the pool images, on this device. ``control``: the
        reference with ETC1 encoded under the heuristic strategy instead of
        the configured one, which breaks the byte-identity guarantee."""
        per_key = {}
        for key, img in self.pools.items():
            codec, side, _ = key
            strategy = next(c.get("strategy", 2) for c in self.config["codecs"]
                            if c["codec"] == codec)
            if control and codec == "etc1":
                strategy = 3
            x = torch.from_numpy(img).to(self.device)
            level0 = ref.encode(codec, x, strategy)
            levels = [(level0, side, side)]
            if self.mipmaps and codec != "pvrtc":
                levels += ref.chain(codec, level0, side, side, strategy)
            per_key[key] = [(ref.metadata(codec, h, w),
                             p.cpu().numpy().reshape(-1)) for p, h, w in levels]
        out = {}
        for name, codec, _, key in self.meta:
            levels = per_key[key]
            out[name] = levels[0]
            for lvl, entry in enumerate(levels[1:], start=1):
                out[f"{name}_mip{lvl}"] = entry
        return out

    def control_answers(self) -> None:
        """Put the control in the program's place: every entry of one pass
        from :meth:`expected` with ``control``."""
        out = self.expected(True)
        self.kept = [(len(out), {n: out[n] for n in names})
                     for names in self._samples]

    def check(self) -> tuple[dict, int, int, int]:
        """(readings, attempted, failed, answers compared): each reading is
        (value, limit). A pass that returned another number of entries
        than expected failed."""
        want = self.expected()
        missing = extra = wrong_payload = wrong_md = checked = 0
        failed = sum(n != len(want) for n, _ in self.kept)
        for n, sample in self.kept:
            extra += max(0, n - len(want))
            for name, got in sample.items():
                if got is None:
                    missing += 1
                    continue
                bad_p, bad_m = _wrong(got, *want[name])
                wrong_payload += bad_p
                wrong_md += bad_m
                checked += 1
        readings = {"wrong_payloads": (wrong_payload, 0),
                    "wrong_metadata": (wrong_md, 0),
                    "missing_entries": (missing, 0),
                    "extra_entries": (extra, 0)}
        return readings, len(self.kept), failed, checked


class Requests:
    """``compress()`` requests through one EtcCompressor."""

    label = "texbench.api.compress"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from texcomp_torch import EtcCompressor, Format

        if config["codec"] != "etc1":
            raise ValueError(f"no request client for {config['codec']!r}")
        self.config, self.mix, self.device = config, mix, torch.device(device)
        self.format = Format.RGB
        self.comp = EtcCompressor(config.get("strategy", 2),
                                  quality=config["quality"], device=device)
        self.images = inputs.request_pool(config, mix["pool"], seed, device)
        self.side = config["side"]
        self.mpix = self.side * self.side / 1e6
        self.answers: list = []  # (pool index, kept answer, ok)

    def _request(self, k: int):
        from texcomp_torch import CompressedImage

        ci = CompressedImage()
        ok = self.comp.compress(self.format, self.side, self.side, 0,
                                self.images[k], ci)
        return ci, ok

    def warm(self) -> None:
        for i in range(self.mix["warmup"]):
            self._request(i % len(self.images))

    def unit(self) -> None:
        k = len(self.answers) % len(self.images)
        ci, ok = self._request(k)
        self.answers.append((k, kept(ci), ok))

    def stage_times(self):
        return None

    def stage_times_off(self) -> None:
        pass

    def release(self) -> None:
        self.comp = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, fdt: torch.dtype = torch.float32) -> list:
        """Per pool image, (metadata, payload) from the reference."""
        c = self.config
        return [(ref.metadata(c["codec"], self.side, self.side),
                 ref.encode(c["codec"], torch.from_numpy(img).to(self.device),
                            c.get("strategy", 2), c["quality"], fdt)
                 .cpu().numpy().reshape(-1))
                for img in self.images]

    def control_answers(self) -> None:
        """The control in the program's place: each pool image once, by the
        reference one precision lower (the HQ fit in bfloat16)."""
        self.answers = [(k, a, True) for k, a
                        in enumerate(self.expected(torch.bfloat16))]

    def check(self) -> tuple[dict, int, int, int]:
        want = self.expected()
        failed = wrong_payload = wrong_md = 0
        for k, got, ok in self.answers:
            if not ok:
                failed += 1
                continue
            bad_p, bad_m = _wrong(got, *want[k])
            wrong_payload += bad_p
            wrong_md += bad_m
        readings = {"wrong_payloads": (wrong_payload, 0),
                    "wrong_metadata": (wrong_md, 0),
                    "failed_requests": (failed, 0)}
        return readings, len(self.answers), failed, len(self.answers) - failed


ENTRIES = {"pipeline.run": Fleet, "compress": Requests}


def make(config: dict, mix: dict, seed: int, device):
    return ENTRIES[mix["entry"]](config, mix, seed, device)
