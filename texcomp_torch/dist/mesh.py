"""Device meshes for batched texture compression, driven by one process.

texcomp shards over a ``jax.sharding.Mesh``; here a :class:`Mesh` is a
(data, block) grid of torch devices and one process drives every one of
them, the single-controller analogue:

  * "data": a batch of images splits over the data devices. Encoding needs
    no communication; only quality sums are combined, on the host.
  * "block": the block axis of one image splits over the block devices of
    its data row. Blocks are independent in every 4x4 codec, so this is a
    pure split.

One PVRTC atlas splits its block rows over the "data" devices too, but a
strip needs one block row of each neighbour: the halo exchanges of
texcomp's ``ppermute`` pairs become device-to-device copies of one packed
row between neighbouring "data" devices, cyclic, made by the one process
that drives the mesh (``pvrtc_encode_atlas_sharded``,
``pvrtc4_encode_atlas_sharded``).

A device may appear more than once: a mesh of four ``cuda:0`` entries
runs four parts on one card, as the tests run eight parts on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from texcomp_torch.blocks import image_to_blocks, scatter_blocks
from texcomp_torch.codecs import pvrtc, pvrtc4
from texcomp_torch.ops import (dxt1_decode_image_op, dxt1_encode_image_op,
                               dxt5_encode_image_op, etc1_encode_image_op)
from texcomp_torch.ops import pvrtc_cuda


def _device_array(devices: Sequence) -> np.ndarray:
    """A 1-D object array of torch devices."""
    out = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        out[i] = torch.device(d)
    return out


class Mesh:
    """A grid of torch devices with named axes; "data" must be one of them.

    ``devices`` is an array (or nested list) of devices whose number of
    dimensions is ``len(axis_names)``."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data", "block")):
        arr = np.asarray(devices, dtype=object)
        flat = _device_array(list(arr.reshape(-1)))
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")
        if "data" not in self.axis_names:
            raise ValueError("a mesh needs a 'data' axis")
        if not self.devices.size:
            raise ValueError("a mesh needs at least one device")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def rows(self) -> list[list[torch.device]]:
        """The devices of each "data" index, in "block" order."""
        data_axis = self.axis_names.index("data")
        moved = np.moveaxis(self.devices, data_axis, 0)
        return [list(r) for r in moved.reshape(self.shape["data"], -1)]

    @property
    def data_devices(self) -> list[torch.device]:
        """Where each "data" part runs: the first device of its row."""
        return [row[0] for row in self.rows()]


def visible_devices() -> list[torch.device]:
    """Every CUDA device this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              block: int = 1, *, devices: Sequence | None = None) -> Mesh:
    """A (data, block) mesh over the first data * block of ``devices``
    (default: every visible CUDA device)."""
    devices = visible_devices() if devices is None else list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if data is None:
        data = n_devices // block
    if data < 1 or block < 1:
        raise ValueError(
            f"mesh axes must be positive, got data={data} block={block}")
    if data * block > len(devices):
        raise ValueError(
            f"mesh needs {data}x{block}={data * block} devices but only "
            f"{len(devices)} are available")
    dev = _device_array(devices[: data * block]).reshape(data, block)
    return Mesh(dev, ("data", "block"))


def _parts(x: torch.Tensor, mesh: Mesh):
    """(device, part) of each "data" device whose part of ``x`` (split
    along dim 0 into contiguous, near-equal parts) is not empty."""
    devs = mesh.data_devices
    return [(d, p) for d, p in zip(devs, x.tensor_split(len(devs)))
            if p.shape[0]]


def dxt1_encode_batch(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, N, 8) uint8 DXT1 payloads, one encode of
    the (B*H, W, 3) tall image."""
    b, h, w, c = images.shape
    return dxt1_encode_image_op(images.reshape(b * h, w, c)).reshape(b, -1, 8)


def dxt1_pipeline_sharded(images: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Encode a batch of images data-parallel over the mesh; the payloads
    are gathered on the mesh's first device."""
    home = mesh.data_devices[0]
    return torch.cat([dxt1_encode_batch(p.to(d)).to(home)
                      for d, p in _parts(images, mesh)])


def _step(images: torch.Tensor, mesh: Mesh):
    """One sharded pipeline step: DXT1 encode, decode and the PSNR.

    Images split over "data"; each image's blocks split over the "block"
    devices of its row, each part encoded and decoded as one block row
    (a (4, 4n) image).
    The squared errors are summed exactly and combined on the host.
    Returns the (B, N, 8) payloads on the mesh's first device and the
    PSNR (dB) of the whole batch."""
    home = mesh.data_devices[0]
    rows = mesh.rows()
    encoded, se = [], 0
    for i, part in enumerate(images.tensor_split(len(rows))):
        if not part.shape[0]:
            continue
        b = part.shape[0]
        blocks = image_to_blocks(part.reshape(-1, *part.shape[2:]))
        blocks = blocks.reshape(b, -1, 16, 3)
        pieces = []
        for dev, piece in zip(rows[i], blocks.tensor_split(len(rows[i]), 1)):
            n = piece.shape[1]
            if not n:
                continue
            flat = piece.reshape(b * n, 16, 3).to(dev)
            row = scatter_blocks(flat, height=4, width=4 * b * n)
            enc = dxt1_encode_image_op(row)
            dec = image_to_blocks(dxt1_decode_image_op(enc, 4, 4 * b * n))
            err = dec[:, :, :3] - flat
            se += int((err * err).sum(dtype=torch.int64))
            pieces.append(enc.reshape(b, n, 8).to(home))
        encoded.append(torch.cat(pieces, dim=1))
    mse = se / images.numel()
    return torch.cat(encoded), float(10.0 * np.log10(255.0**2 / max(mse, 1e-9)))


def encode_atlas_sharded(image: torch.Tensor, mesh: Mesh, codec: str = "dxt1",
                         strategy: int = 2) -> torch.Tensor:
    """Encode ONE atlas with its block rows split over the "data" devices.

    (H, W, C) uint8, H a multiple of 4 * the "data" size -> (N,
    block_bytes) uint8 in row-major block order on the mesh's first device.
    Each device encodes its strip of H / data rows through the op facade;
    blocks are independent in dxt1 | dxt5 | etc1, so there is no
    communication and the strips' blocks concatenate."""
    ndata = mesh.shape["data"]
    h = image.shape[0]
    if h % (4 * ndata) != 0:
        raise ValueError(
            f"atlas rows ({h}) must split into 4-row multiples across "
            f"{ndata} 'data' shards (need a multiple of {4 * ndata})")
    ops = {
        "dxt1": dxt1_encode_image_op,
        "dxt5": dxt5_encode_image_op,
        "etc1": lambda img: etc1_encode_image_op(img, strategy),
    }
    if codec not in ops:
        raise ValueError(f"unsupported atlas codec {codec!r}")
    home = mesh.data_devices[0]
    return torch.cat([ops[codec](strip.to(d)).to(home)
                      for d, strip in _parts(image, mesh)])


def dxt1_encode_atlas_sharded(image: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """DXT1 wrapper around :func:`encode_atlas_sharded`."""
    return encode_atlas_sharded(image, mesh, "dxt1")


def _atlas_strips(image: torch.Tensor, mesh: Mesh, min_side: int,
                  block_rows: int, what: str):
    """Check an atlas as texcomp does and cut it into one strip of block
    rows a "data" device, each on its device: [(device, strip)]."""
    ndata = mesh.shape["data"]
    h, w = int(image.shape[0]), int(image.shape[1])
    if h != w or h < min_side or h & (h - 1) or image.shape[2] != 4:
        raise ValueError(f"{what}, got {tuple(image.shape)}")
    nb = h // block_rows
    if nb % ndata != 0:
        raise ValueError(
            f"atlas block rows ({nb}) must split evenly over "
            f"{ndata} 'data' shards")
    return [(d, strip.to(d)) for d, strip in
            zip(mesh.data_devices, image.tensor_split(ndata))]


def _exchange(rows: list, devices: list, step: int) -> list:
    """Halo exchange: device i receives ``rows[(i - step) % n]``, copied to
    it (step 1: from the previous "data" device, texcomp's ``fwd``; step -1:
    from the next, ``bwd``)."""
    n = len(rows)
    return [rows[(i - step) % n].to(d) for i, d in enumerate(devices)]


def pvrtc_encode_atlas_sharded(image: torch.Tensor,
                               mesh: Mesh) -> torch.Tensor:
    """Encode ONE PVRTC 2bpp texture with its block rows split over the
    "data" devices. (S, S, 4) uint8, S a power of two >= 8 whose S / 4
    block rows split evenly over the "data" devices -> (NB, 8) uint8
    Z-order records on the mesh's first device, byte-equal to
    ``ops.pvrtc_cuda.pvrtc_encode_image``.

    Each strip runs the three stages on its device: the morph (with the
    whole image's pixel (0, 0) as the fallback), upscale + modulate with
    the low-res rows above and below from its neighbours, mode + pack with
    the next strip's first modulation row group, row-major. Between them,
    three exchanges of one row each, as texcomp's three ``ppermute``s: the
    packed (A, B) last rows forward, the first rows backward, then the
    first modulation row groups backward. The row-major records are
    gathered on the first device and permuted to Z-order once. The "block"
    axis of the mesh is replicated for this op."""
    strips = _atlas_strips(
        image, mesh, pvrtc.BLOCK_W, pvrtc.BLOCK_H,
        "PVRTC atlas must be square power-of-two RGBA with side >= 8 "
        "(one 8x4 block)")
    devices = [d for d, _ in strips]
    nbx = image.shape[1] // pvrtc.BLOCK_W
    origin = image[0, 0]
    ab = [pvrtc_cuda.pvrtc_morph_strip(s, origin.to(d)) for d, s in strips]
    tops = _exchange([a[-nbx:] for a in ab], devices, 1)
    bots = _exchange([a[:nbx] for a in ab], devices, -1)
    mod = [pvrtc_cuda.pvrtc_upscale_modulate_halo(s, a, t, b)
           for (_, s), a, t, b in zip(strips, ab, tops, bots)]
    halo_v = _exchange([m[:nbx, :8].contiguous() for m in mod], devices, -1)
    home = devices[0]
    words = [pvrtc_cuda.pvrtc_modes_pack_strip(
        m, a, v, a.shape[0] // nbx, nbx).to(home)
        for m, a, v in zip(mod, ab, halo_v)]
    nby = image.shape[0] // pvrtc.BLOCK_H
    return torch.cat(words)[pvrtc._perm(nbx, nby, home)]


def pvrtc4_encode_atlas_sharded(image: torch.Tensor,
                                mesh: Mesh) -> torch.Tensor:
    """Encode ONE PVRTC 4bpp texture (the extension codec) with its block
    rows split over the "data" devices: (S, S, 4) uint8, S a power of two
    >= 4 whose S / 4 block rows split evenly -> (NB, 8) uint8 Z-order
    records on the mesh's first device, byte-equal to
    ``codecs.pvrtc4.encode_pvrtc_4bpp``.

    As :func:`pvrtc_encode_atlas_sharded` without the modulation row (4bpp
    has no mode decision): two exchanges carry the packed (A, B) last and
    first low-res rows for the upscale's y-wrap. Plain PyTorch on each
    strip's device, as texcomp has no kernel for it."""
    strips = _atlas_strips(
        image, mesh, pvrtc4.BLOCK, pvrtc4.BLOCK,
        "PVRTC 4bpp atlas must be square power-of-two RGBA with side >= 4")
    devices = [d for d, _ in strips]
    origin = image[0, 0]
    ab = [pvrtc4.morph_4bpp(s, origin.to(d)) for d, s in strips]
    packed = [torch.stack([pvrtc.pack_words(a), pvrtc.pack_words(b)])
              for a, b in ab]  # (2, nby, nbx): A and B words
    tops = _exchange([p[:, -1] for p in packed], devices, 1)
    bots = _exchange([p[:, 0] for p in packed], devices, -1)
    home = devices[0]
    words = []
    for (_, s), (a, b), top, bot in zip(strips, ab, tops, bots):
        t, u = pvrtc.unpack_words(top), pvrtc.unpack_words(bot)
        mod_words, color_words = pvrtc4.encode_strip_words(
            s, a, b, ((t[0], t[1]), (u[0], u[1])))
        words.append(torch.stack([mod_words, color_words]).to(home))
    nb = image.shape[0] // pvrtc4.BLOCK
    both = torch.cat(words, dim=1)[:, pvrtc._perm(nb, nb, home)]
    return pvrtc._pack_records(both[0], both[1])


def training_step_multichip(n_devices: int, *,
                            devices: Sequence | None = None) -> None:
    """Dry run: build an n-device mesh over ``devices`` (default: every
    visible CUDA device) and run one sharded step on tiny shapes.

    Degrades to the largest usable mesh: with fewer than n_devices
    devices the step runs over all of them instead of failing."""
    devices = visible_devices() if devices is None else list(devices)
    n_devices = max(1, min(n_devices, len(devices)))
    block = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, data=n_devices // block, block=block,
                     devices=devices)
    b = max(1, n_devices // block)
    images = torch.arange(b * 16 * 16 * 3, dtype=torch.int32)
    images = images.to(torch.uint8).reshape(b, 16, 16, 3)
    encoded, _ = _step(images.to(mesh.data_devices[0]), mesh)
    if tuple(encoded.shape) != (b, 16, 8):
        raise RuntimeError(
            f"sharded step produced shape {tuple(encoded.shape)}, "
            f"expected {(b, 16, 8)}")
