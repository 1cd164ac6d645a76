"""Device meshes for batched texture compression, driven by one process.

texcomp shards over a ``jax.sharding.Mesh``; here a :class:`Mesh` is a
(data, block) grid of torch devices and one process drives every one of
them, the single-controller analogue:

  * "data": a batch of images splits over the data devices. Encoding needs
    no communication; only quality sums are combined, on the host.
  * "block": the block axis of one image splits over the block devices of
    its data row. Blocks are independent in every 4x4 codec, so this is a
    pure split.

A device may appear more than once: a mesh of four ``cuda:0`` entries
runs four parts on one card, as the tests run eight parts on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from texcomp_torch.blocks import image_to_blocks, scatter_blocks
from texcomp_torch.ops import (dxt1_decode_image_op, dxt1_encode_image_op,
                               dxt5_encode_image_op, etc1_encode_image_op)


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
