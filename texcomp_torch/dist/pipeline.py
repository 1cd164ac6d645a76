"""Batched asset pipeline: encode fleets of textures over a device mesh.

BASELINE config 5 ("10k mixed DXT/ETC/PVRTC textures"). Assets are
grouped by (codec, strategy, quality, format, shape), and each batch of a
group is one device call:

  * DXT1, DXT5 and ETC1 in reference quality fold a (B, H, W, C) batch
    into one (B*H, W, C) tall image, whose row-major block grid is the
    concatenation of the images' grids (blocks are independent): one
    kernel launch a batch.
  * PVRTC 2bpp runs the batched encode, three launches a batch, each
    image falling back to its own pixel (0, 0); PVRTC 4bpp is plain
    PyTorch per image, as texcomp's is.
  * ``quality="high"`` flattens a batch into one block batch for the DXT
    and ETC1 HQ encoders; the HQ PVRTC encoders run per image.

With a mesh, each batch splits over the mesh's "data" devices and each
part runs on its own device, all driven by this process. ``run()`` keeps
up to ``max_inflight`` batches in flight: each is stacked into pinned host
memory, copied to its device without blocking, encoded on the device's
current stream and copied back into pinned memory behind a CUDA event, so
the host stacks the next batch while the card works. On the CPU the same
code runs the plain twins, synchronously.

Every payload and every Metadata equals texcomp's for the same assets.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from texcomp_torch.api.container import (CompressedImage, Format, Metadata,
                                         needs_red_and_blue_swapped)
from texcomp_torch.blocks import image_to_blocks, num_blocks
from texcomp_torch.codecs import dxt_hq, pvrtc, pvrtc4, pvrtc_hq
from texcomp_torch.dist.mesh import Mesh
from texcomp_torch.ops import dxt_cuda, etc_cuda, pvrtc_cuda
from texcomp_torch.ops.mipmap import mipmap_chain, num_chain_levels

_FORMATS = {"dxt1": Format.RGB, "dxt5": Format.RGBA, "etc1": Format.RGB,
            "pvrtc": Format.RGBA, "pvrtc4": Format.RGBA}
# Formats each codec accepts, matching the per-codec supports_format rules
# (DXTC all four, dxtc_compressor.cc:707-710; ETC RGB-only,
# etc_compressor.cc:713-717; PVRTC RGBA-only, pvrtc_compressor.cc:611-613).
_VALID_FORMATS = {"dxt1": (Format.RGB, Format.BGR),
                  "dxt5": (Format.RGBA, Format.BGRA),
                  "etc1": (Format.RGB,),
                  "pvrtc": (Format.RGBA,), "pvrtc4": (Format.RGBA,)}
_NAMES = {"dxt1": "dxtc", "dxt5": "dxtc", "etc1": "etc", "pvrtc": "pvrtc",
          "pvrtc4": "pvrtc4"}
_BGRA = [2, 1, 0, 3]


@dataclass
class TextureAsset:
    """One texture to encode. Image is (H, W, C) uint8 with H, W multiples
    of 4 (PVRTC additionally requires square power-of-two).

    ``format`` defaults to the codec's canonical format (RGB/RGBA); pass
    Format.BGR / Format.BGRA for swapped-channel sources, with the bytes of
    the per-asset API calls (compressed_image.h:202-204)."""

    name: str
    image: np.ndarray
    codec: str  # dxt1 | dxt5 | etc1 | pvrtc | pvrtc4
    strategy: int = 2  # ETC1 only
    quality: str = "reference"  # "high" -> the HQ extension encoders
    format: Format | None = None  # None -> _FORMATS[codec]


def _format(a: TextureAsset) -> Format:
    # Format.RGB is IntEnum 0: an explicit RGB must not become the default.
    return a.format if a.format is not None else _FORMATS[a.codec]


def _metadata(codec: str, fmt: Format, h: int, w: int) -> Metadata:
    if codec in ("pvrtc", "pvrtc4"):
        return Metadata(fmt, _NAMES[codec], h, w, h, w, 0)
    return Metadata(fmt, _NAMES[codec], h, w, 4 * num_blocks(h),
                    4 * num_blocks(w), 0)


def _compressed(md: Metadata, payload: np.ndarray) -> CompressedImage:
    ci = CompressedImage()
    ci.create_owned_data(md, payload.size)
    ci.get_mutable_data()[:] = payload.reshape(-1)
    return ci


def _batch_encode_hq(images: torch.Tensor, codec: str,
                     swap: bool = False) -> torch.Tensor:
    """quality="high": (B, H, W, C) uint8 -> (B, N, block_bytes) uint8.
    The DXT and ETC1 HQ encoders are per block, so the batch flattens into
    one block batch (the tall image's blocks); PVRTC HQ runs per image."""
    if codec == "pvrtc":
        return torch.stack([pvrtc_hq.encode_pvrtc_2bpp_hq(im) for im in images])
    if codec == "pvrtc4":
        return torch.stack([pvrtc_hq.encode_pvrtc_4bpp_hq(im) for im in images])
    b, h, w, c = images.shape
    blocks = image_to_blocks(images.reshape(b * h, w, c))
    if codec == "dxt1":
        rgb = blocks[:, :, :3]
        out = dxt_hq.encode_dxt1_hq_blocks(rgb.flip(-1) if swap else rgb, swap)
    elif codec == "dxt5":
        rgba = blocks[:, :, _BGRA] if swap else blocks
        outside = torch.zeros(rgba.shape[0], dtype=torch.bool,
                              device=rgba.device)
        out = dxt_hq.encode_dxt5_hq_blocks(rgba, outside, swap)
    else:
        out = etc_cuda.etc1_hq_encode_blocks(blocks[:, :, :3])
    return out.reshape(b, (h // 4) * (w // 4), -1)


def _batch_encode(images: torch.Tensor, codec: str, strategy: int,
                  quality: str = "reference",
                  swap: bool = False) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, num_blocks, block_bytes) uint8 on the
    images' device.

    ``swap``: input channels are BGR/BGRA; bytes match the per-asset API
    with the swapped format, including the const-path double-swap quirk
    (dxtc_compressor.cc:360)."""
    if quality == "high":
        return _batch_encode_hq(images, codec, swap)
    if codec == "pvrtc":
        return pvrtc_cuda.pvrtc_encode_batched(images)
    if codec == "pvrtc4":
        return torch.stack([pvrtc4.encode_pvrtc_4bpp(im) for im in images])
    b, h, w, c = images.shape
    tall = images.reshape(b * h, w, c)
    if codec == "dxt1":
        out = dxt_cuda.dxt1_encode_image(tall, swap=swap)
    elif codec == "dxt5":
        out = dxt_cuda.dxt5_encode_image(tall, swap=swap)
    else:
        out = etc_cuda.etc1_encode_image(tall, strategy)
    return out.reshape(b, (h // 4) * (w // 4), -1)


def _decode_batch(payloads: torch.Tensor, codec: str, h: int,
                  w: int) -> torch.Tensor:
    """(B, N, block_bytes) -> (B, H, W, 4) uint8: the 4x4 codecs decode the
    tall payload at once, the PVRTC decodes (plain PyTorch) per image."""
    b = payloads.shape[0]
    if codec in ("pvrtc", "pvrtc4"):
        dec = (pvrtc.decode_pvrtc_2bpp if codec == "pvrtc"
               else pvrtc4.decode_pvrtc_4bpp)
        return torch.stack([dec(p, h, w) for p in payloads])
    decode = {"dxt1": dxt_cuda.dxt1_decode_image,
              "dxt5": dxt_cuda.dxt5_decode_image,
              "etc1": etc_cuda.etc1_decode_image}[codec]
    flat = payloads.reshape(-1, payloads.shape[-1])
    return decode(flat, height=b * h, width=w).reshape(b, h, w, 4)


def _tail_can_downsample(h: int, w: int) -> bool:
    """Whether one more Downsample succeeds at uncompressed (h, w): the
    acceptance rules of compressor4x4_helper.h:281-284 (even block counts
    unless single-block) and :344-350 (3-pixel dims fail)."""
    if max(h, w) <= 1:
        return False
    nbr, nbc = num_blocks(h), num_blocks(w)
    if (nbr > 1 and nbr % 2 != 0) or (nbc > 1 and nbc % 2 != 0):
        return False
    if nbr == 1 and nbc == 1 and (h == 3 or w == 3):
        return False
    return True


def _tail_step_batched(payloads: torch.Tensor, *, codec: str, strategy: int,
                       h: int, w: int) -> torch.Tensor:
    """One Downsample level for a whole same-shape batch: (B, N, bb)
    payloads at uncompressed (h, w) -> (B, N', bb) at ((h+1)//2,
    (w+1)//2), byte-equal to helper4x4.downsample per asset: one decode of
    the tall payload, the 1- and 2-pixel replication (:344-388), the
    truncating 2x2 average, the quadrant tiling (:357-387, :610-636) and
    one swap-free encode of the tall result."""
    b = payloads.shape[0]
    nbr, nbc = num_blocks(h), num_blocks(w)
    c = 4 if codec == "dxt5" else 3
    img = _decode_batch(payloads, codec, 4 * nbr, 4 * nbc)[..., :c]
    img = img.to(torch.int32)
    if nbr == 1 and nbc == 1:
        if w == 1:
            img = img[:, :, 0:1].repeat(1, 1, 4, 1)
        elif w == 2:
            img = img[:, :, 0:2].repeat(1, 1, 2, 1)
        if h == 1:
            img = img[:, 0:1].repeat(1, 4, 1, 1)
        elif h == 2:
            img = img[:, 0:2].repeat(1, 2, 1, 1)
    h2, w2 = img.shape[1] // 2, img.shape[2] // 2
    avg = img.reshape(b, h2, 2, w2, 2, c).sum(dim=(2, 4)) >> 2
    if avg.shape[2] < 4:
        avg = avg.repeat(1, 1, 4 // avg.shape[2], 1)
    if avg.shape[1] < 4:
        avg = avg.repeat(1, 4 // avg.shape[1], 1, 1)
    gh, gw = avg.shape[1], avg.shape[2]
    tall = avg.to(torch.uint8).reshape(b * gh, gw, c).contiguous()
    if codec == "dxt1":
        out = dxt_cuda.dxt1_encode_image(tall)
    elif codec == "dxt5":
        out = dxt_cuda.dxt5_encode_image(tall)
    else:
        out = etc_cuda.etc1_encode_image(tall, strategy)
    return out.reshape(b, (gh // 4) * (gw // 4), -1)


class StageTimes:
    """Where the host time of the batches of a run went: seconds stacking
    images into staging memory and packing containers."""

    def __init__(self):
        self.host_s = {"stack": 0.0, "pack": 0.0}

    @contextlib.contextmanager
    def host(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_s[stage] += time.perf_counter() - t0


class AssetPipeline:
    """Mesh-sharded batch encoder for mixed texture assets.

    ``mesh=None`` runs on a one-device mesh on ``device`` (the card unless
    the caller passes "cpu"). Set ``stage_times`` to a :class:`StageTimes`
    to have the host stages of later runs' batches timed."""

    def __init__(self, mesh: Mesh | None = None, batch_size: int = 64,
                 max_inflight: int = 4, *, device="cuda"):
        if mesh is None:
            mesh = Mesh([torch.device(device)], ("data",))
        self.mesh = mesh
        self.devices = mesh.data_devices
        self.ndev = len(self.devices)
        self.batch_size = max(batch_size, self.ndev)
        # How many batches run() keeps in flight (device input and output
        # and pinned staging alive) before it collects the oldest: peak
        # memory O(max_inflight x batch), not O(fleet); >= 2 keeps the
        # device busy while the host stacks the next batch.
        self.max_inflight = max(2, max_inflight)
        self.stage_times: StageTimes | None = None

    def _host(self, stage: str):
        return (self.stage_times.host(stage) if self.stage_times
                else contextlib.nullcontext())

    def _stage(self, arrays: Sequence[np.ndarray]):
        """Pad the batch to a multiple of the "data" devices (repeating its
        first array) and stack each device's part into one host tensor,
        pinned for a CUDA device. Returns [(device, host tensor)]."""
        rows = list(arrays)
        rows += [rows[0]] * ((-len(rows)) % self.ndev)
        per = len(rows) // self.ndev
        staged = []
        with self._host("stack"):
            for i, dev in enumerate(self.devices):
                part = rows[i * per:(i + 1) * per]
                host = torch.empty((per, *part[0].shape), dtype=torch.uint8,
                                   pin_memory=dev.type == "cuda")
                np.stack(part, out=host.numpy())
                staged.append((dev, host))
        return staged

    def _upload(self, staged) -> list[torch.Tensor]:
        return [host.to(dev, non_blocking=True) for dev, host in staged]

    def _fetch(self, out: torch.Tensor):
        """Start the copy of a device result into host memory; returns the
        host tensor and the CUDA event that marks the copy's end (None on
        the CPU)."""
        dev = out.device
        if dev.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return host, done

    @staticmethod
    def _wait(fetched) -> np.ndarray:
        parts = []
        for host, done in fetched:
            if done is not None:
                done.synchronize()
            parts.append(host.numpy())
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def encode_group_async(self, images, codec: str, strategy: int = 2,
                           quality: str = "reference",
                           fmt: Format | None = None) -> list[torch.Tensor]:
        """Start one same-shape batch encode and return the DEVICE results
        without waiting: one (b_i, N, block_bytes) tensor per "data"
        device, in order; together the batch padded to a multiple of the
        "data" size (slice [:B] after fetching). ``images`` is a (B, H, W,
        C) uint8 array or a sequence of (H, W, C) arrays."""
        fmt = _FORMATS[codec] if fmt is None else fmt
        if fmt not in _VALID_FORMATS[codec]:
            raise ValueError(f"{codec} cannot encode {fmt!r}")
        swap = needs_red_and_blue_swapped(fmt)
        return [_batch_encode(x, codec, strategy, quality, swap)
                for x in self._upload(self._stage(images))]

    def encode_group(self, images, codec: str, strategy: int = 2,
                     quality: str = "reference",
                     fmt: Format | None = None) -> np.ndarray:
        """Encode a same-shape batch: (B, H, W, C) -> (B, nblocks, bytes).
        Each "data" device encodes its part with one batched call."""
        outs = self.encode_group_async(images, codec, strategy, quality, fmt)
        return self._wait([self._fetch(o) for o in outs])[: len(images)]

    def run(self, assets: Sequence[TextureAsset],
            mipmaps: bool = False) -> dict[str, CompressedImage]:
        """Encode a mixed asset fleet. Returns name -> CompressedImage.

        With ``mipmaps=True``, every dxt1/dxt5/etc1 asset also gets its
        full mip chain as ``<name>_mip1..N`` entries, byte-equal to
        repeated Downsample calls. PVRTC has no downsample, like the
        reference (pvrtc_compressor.cc:669-705)."""
        groups: dict[tuple, list[int]] = {}
        for i, a in enumerate(assets):
            key = (a.codec, a.strategy, a.quality, _format(a), a.image.shape)
            groups.setdefault(key, []).append(i)

        results: dict[str, CompressedImage] = {}
        pending: deque = deque()

        def collect_one() -> None:
            chunk, codec, fmt, fetched = pending.popleft()
            encoded = self._wait(fetched)
            with self._host("pack"):
                for j, i in enumerate(chunk):
                    a = assets[i]
                    md = _metadata(codec, fmt, a.image.shape[0],
                                   a.image.shape[1])
                    results[a.name] = _compressed(md, encoded[j])

        for (codec, strategy, quality, fmt, _), idxs in groups.items():
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                outs = self.encode_group_async(
                    [assets[i].image for i in chunk], codec, strategy,
                    quality, fmt)
                pending.append((chunk, codec, fmt,
                                [self._fetch(o) for o in outs]))
                if len(pending) >= self.max_inflight:
                    collect_one()
        while pending:
            collect_one()

        if mipmaps:
            self._run_mipmaps(assets, results)
        return results

    def chain_group(self, payloads: np.ndarray, codec: str, strategy: int,
                    height: int, width: int, levels: int) -> list[np.ndarray]:
        """The fused mip chains of a same-shape batch: (B, N, block_bytes)
        level-0 payloads -> [(B, N1, bb), ...] per level.

        Each device's part folds into the image Y axis: a (b*H, W) tall
        payload's block grid is the concatenation of the per-image grids,
        and no 2x2 average crosses two images (H % 8 == 0 at every fused
        level), so one mipmap_chain per part makes every image's chain."""
        b = payloads.shape[0]
        per_level = [[] for _ in range(levels)]
        for x in self._upload(self._stage(payloads)):
            bb = x.shape[0]
            outs = mipmap_chain(x.reshape(-1, x.shape[-1]),
                                height=bb * height, width=width, codec=codec,
                                levels=levels, strategy=strategy)
            for lvl, o in enumerate(outs):
                per_level[lvl].append(self._fetch(o.reshape(bb, -1,
                                                            o.shape[-1])))
        return [self._wait(f)[:b] for f in per_level]

    def _batched_tail(self, chunk: Sequence[TextureAsset], codec: str,
                      strategy: int, payloads: np.ndarray, h: int, w: int,
                      results: dict[str, CompressedImage],
                      start_lvl: int) -> None:
        """Attach the ragged mip tail of a same-shape chunk: one batched
        step per level (see _tail_step_batched) on the first device."""
        cur = torch.from_numpy(np.ascontiguousarray(payloads)).to(
            self.devices[0])
        lvl, lh, lw = start_lvl, h, w
        while _tail_can_downsample(lh, lw):
            cur = _tail_step_batched(cur, codec=codec, strategy=strategy,
                                     h=lh, w=lw)
            arr = cur.cpu().numpy()
            lh, lw = (lh + 1) // 2, (lw + 1) // 2
            for j, a in enumerate(chunk):
                results[f"{a.name}_mip{lvl}"] = _compressed(
                    _metadata(codec, _format(a), lh, lw), arr[j])
            lvl += 1

    def _run_mipmaps(self, assets: Sequence[TextureAsset],
                     results: dict[str, CompressedImage]) -> None:
        from texcomp_torch.api.dxtc import DxtcCompressor
        from texcomp_torch.api.etc import EtcCompressor

        # Group by (codec, strategy, shape): one batched chain per group
        # for the fused prefix, then one batched step per level for the
        # ragged tail. quality="high" assets keep the per-asset chain (a
        # never-worse re-encode per level through the API compressors).
        # Swapped formats group together: downsample decodes and
        # re-encodes swap-free (compressor4x4_helper.h:602-607), so chain
        # bytes are format-independent; only the metadata differs.
        fused: dict[tuple, list[TextureAsset]] = {}
        tail: dict[tuple, list[TextureAsset]] = {}
        per_asset: list[TextureAsset] = []
        for a in assets:
            if a.codec in ("pvrtc", "pvrtc4"):
                continue
            h, w = a.image.shape[0], a.image.shape[1]
            if a.quality != "reference":
                per_asset.append(a)
            elif num_chain_levels(h, w) > 0:
                fused.setdefault((a.codec, a.strategy, h, w), []).append(a)
            else:
                tail.setdefault((a.codec, a.strategy, h, w), []).append(a)

        def payloads_of(chunk, nblk):
            return np.stack([results[a.name].get_data().reshape(nblk, -1)
                             for a in chunk])

        for (codec, strategy, h, w), group in fused.items():
            levels = num_chain_levels(h, w)
            nblk = num_blocks(h) * num_blocks(w)
            for start in range(0, len(group), self.batch_size):
                chunk = group[start:start + self.batch_size]
                outs = self.chain_group(payloads_of(chunk, nblk), codec,
                                        strategy, h, w, levels)
                for j, a in enumerate(chunk):
                    for lvl in range(levels):
                        md = _metadata(codec, _format(a), h >> (lvl + 1),
                                       w >> (lvl + 1))
                        results[f"{a.name}_mip{lvl + 1}"] = _compressed(
                            md, outs[lvl][j])
                self._batched_tail(chunk, codec, strategy, outs[-1],
                                   h >> levels, w >> levels, results,
                                   start_lvl=levels + 1)

        for (codec, strategy, h, w), group in tail.items():
            nblk = num_blocks(h) * num_blocks(w)
            for start in range(0, len(group), self.batch_size):
                chunk = group[start:start + self.batch_size]
                self._batched_tail(chunk, codec, strategy,
                                   payloads_of(chunk, nblk), h, w, results,
                                   start_lvl=1)

        device = self.devices[0]
        for a in per_asset:
            comp = (EtcCompressor(a.strategy, quality=a.quality, device=device)
                    if a.codec == "etc1"
                    else DxtcCompressor(quality=a.quality, device=device))
            for lvl, mip in enumerate(comp.downsample_chain(results[a.name]),
                                      start=1):
                results[f"{a.name}_mip{lvl}"] = mip


def quality_sums(pipeline: AssetPipeline, images: np.ndarray,
                 codec: str = "dxt1") -> tuple[float, float]:
    """Encode + decode a batch and return (sum of squared error, element
    count), the sufficient statistics behind the PSNR report.

    The squared error is summed exactly, in int64 per image, weighted to
    leave out the padding duplicates, and the devices' sums are combined
    on the host: every device gives the CPU's value to the last bit. A
    multi-process caller (multihost.fleet_quality) combines the processes'
    sums before the log. Every pipeline codec: dxt1 | dxt5 | etc1 |
    pvrtc | pvrtc4 (the PVRTC decodes are extensions; the reference
    cannot decode PVRTC, pvrtc_compressor.cc:669-705)."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    c = 4 if codec in ("dxt5", "pvrtc", "pvrtc4") else 3
    sums, start = [], 0
    for x in pipeline._upload(pipeline._stage(images)):
        n = x.shape[0]
        weights = (torch.arange(start, start + n, device=x.device) < b)
        start += n
        dec = _decode_batch(_batch_encode(x, codec, 2), codec, h, w)
        err = dec[..., :c].to(torch.int32) - x[..., :c].to(torch.int32)
        per_image = (err * err).sum(dim=(1, 2, 3), dtype=torch.int64)
        sums.append((per_image * weights).sum())
    se = sum(int(s) for s in sums)
    return float(se), float(b * h * w * c)


def psnr_from_sums(se: float, cnt: float) -> float:
    """PSNR (dB) from (sum squared error, element count) sums."""
    mse = se / max(cnt, 1.0)
    return float(10.0 * np.log10(255.0**2 / max(mse, 1e-9)))


def quality_report(pipeline: AssetPipeline, images: np.ndarray,
                   codec: str = "dxt1") -> float:
    """Encode + decode a batch and return the mean PSNR (dB); see
    quality_sums for the reduction."""
    return psnr_from_sums(*quality_sums(pipeline, images, codec))
