"""Texture archives: the "TXC1" container of texcomp's archive format.

A simple versioned binary container for fleets of compressed textures, so
that an asset pipeline run can be persisted and resumed. The bytes are
those of texcomp's archives, so either package loads the other's.

Format (little-endian):
  magic "TXC1" | u32 count
  per entry:
    u16 name_len | name utf-8
    u8 format | u16 compressor_name_len | compressor_name
    u32 uncompressed_h | u32 uncompressed_w
    u32 compressed_h | u32 compressed_w | u32 padding_bytes_per_row
    u64 payload_len | payload bytes
"""

from __future__ import annotations

import struct

import numpy as np

from texcomp_torch.api.container import CompressedImage, Format, Metadata

_MAGIC = b"TXC1"


def save_archive(path: str, images: dict[str, CompressedImage]) -> None:
    """Write ``images`` (name -> CompressedImage) to ``path``."""
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(images)))
        for name, ci in images.items():
            md = ci.get_metadata()
            nb = name.encode("utf-8")
            cn = md.compressor_name.encode("utf-8")
            f.write(struct.pack("<H", len(nb)))
            f.write(nb)
            f.write(struct.pack("<BH", int(md.format), len(cn)))
            f.write(cn)
            f.write(struct.pack(
                "<IIIII", md.uncompressed_height, md.uncompressed_width,
                md.compressed_height, md.compressed_width,
                md.padding_bytes_per_row,
            ))
            data = ci.get_data()
            f.write(struct.pack("<Q", data.size))
            f.write(data.tobytes())


def load_archive(path: str) -> dict[str, CompressedImage]:
    """Read an archive: name -> CompressedImage, in the file's order."""
    out: dict[str, CompressedImage] = {}
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not a texcomp archive")
        (count,) = struct.unpack("<I", f.read(4))
        for _ in range(count):
            (nlen,) = struct.unpack("<H", f.read(2))
            name = f.read(nlen).decode("utf-8")
            fmt, clen = struct.unpack("<BH", f.read(3))
            cname = f.read(clen).decode("utf-8")
            uh, uw, ch, cw, pad = struct.unpack("<IIIII", f.read(20))
            (plen,) = struct.unpack("<Q", f.read(8))
            payload = np.frombuffer(f.read(plen), dtype=np.uint8)
            ci = CompressedImage()
            ci.create_owned_data(
                Metadata(Format(fmt), cname, uh, uw, ch, cw, pad), plen
            )
            ci.get_mutable_data()[:] = payload
            out[name] = ci
    return out
