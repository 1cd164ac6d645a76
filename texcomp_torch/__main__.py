"""texcomp_torch command-line interface: texcomp's CLI on the port.

  python -m texcomp_torch encode  --codec dxt5 --input img.npy --archive out.txc
  python -m texcomp_torch decode  --archive out.txc --name img --output dec.npy
  python -m texcomp_torch info    --archive out.txc
  python -m texcomp_torch transcode-dxt1-etc1 --archive out.txc --name img
  python -m texcomp_torch mipmap  --archive out.txc --name img --levels 3

Images are .npy arrays of shape (H, W, C) uint8 (C = 3 for dxt1/etc1,
4 for dxt5/pvrtc/pvrtc4). Encoded textures live in "TXC1" archives
(utils/archive.py), which texcomp reads and writes too. Every command that
encodes or decodes runs on the card unless it is given --device cpu.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from texcomp_torch import (
    CompressedImage,
    CompressionStrategy,
    DxtcCompressor,
    EtcCompressor,
    Format,
    Pvrtc4bppCompressor,
    PvrtcCompressor,
    transcode_dxt1_to_etc1,
)
from texcomp_torch.api.container import num_format_components
from texcomp_torch.utils import load_archive, save_archive

_CODECS = {
    "dxt1": (Format.RGB, 3),
    "dxt5": (Format.RGBA, 4),
    "etc1": (Format.RGB, 3),
    "pvrtc": (Format.RGBA, 4),
    "pvrtc4": (Format.RGBA, 4),
}


def _compressor(codec: str, quality: str, strategy: int, device: str):
    if codec in ("dxt1", "dxt5"):
        return DxtcCompressor(quality=quality, device=device)
    if codec == "etc1":
        return EtcCompressor(CompressionStrategy(strategy), quality=quality,
                             device=device)
    if codec == "pvrtc":
        return PvrtcCompressor(quality=quality, device=device)
    return Pvrtc4bppCompressor(quality=quality, device=device)


def _compressor_for(ci: CompressedImage, device: str):
    name = ci.get_metadata().compressor_name
    return {"dxtc": DxtcCompressor, "etc": EtcCompressor,
            "pvrtc": PvrtcCompressor,
            "pvrtc4": Pvrtc4bppCompressor}[name](device=device)


def cmd_encode(args) -> int:
    img = np.load(args.input)
    fmt, comps = _CODECS[args.codec]
    if img.ndim != 3 or img.dtype != np.uint8 or img.shape[2] != comps:
        print(f"error: expected (H, W, {comps}) uint8 array for "
              f"{args.codec}; got {img.shape} {img.dtype}", file=sys.stderr)
        return 1
    comp = _compressor(args.codec, args.quality, args.strategy, args.device)
    ci = CompressedImage()
    h, w = img.shape[:2]
    if not comp.compress(fmt, h, w, 0, img.tobytes(), ci):
        print("error: compression failed (check size constraints)",
              file=sys.stderr)
        return 1
    archive = Path(args.archive)
    textures = load_archive(archive) if archive.exists() else {}
    name = args.name or Path(args.input).stem
    textures[name] = ci
    save_archive(str(archive), textures)
    ratio = img.nbytes / max(1, ci.get_data_size())
    print(f"{name}: {h}x{w} {args.codec} -> {ci.get_data_size()} bytes "
          f"({ratio:.1f}x)")
    return 0


def cmd_decode(args) -> int:
    textures = load_archive(args.archive)
    if args.name not in textures:
        print(f"error: {args.name!r} not in archive "
              f"(has: {sorted(textures)})", file=sys.stderr)
        return 1
    ci = textures[args.name]
    comp = _compressor_for(ci, args.device)
    md = ci.get_metadata()
    buf = bytearray()
    ok = comp.decompress(ci, buf)
    if not ok and isinstance(comp, PvrtcCompressor):
        ok = comp.decompress_extension(ci, buf)
    if not ok:
        print("error: decode failed", file=sys.stderr)
        return 1
    c = num_format_components(md.format)
    h, w = md.uncompressed_height, md.uncompressed_width
    # Decompress emits rows at the padded stride (with no padding after the
    # final row); strip the per-row padding.
    flat = np.frombuffer(bytes(buf), np.uint8)
    stride = w * c + md.padding_bytes_per_row
    img = np.lib.stride_tricks.as_strided(
        flat, shape=(h, w * c), strides=(stride, 1)
    ).reshape(h, w, c).copy()
    np.save(args.output, img)
    print(f"{args.name}: decoded {img.shape} -> {args.output}")
    return 0


def cmd_info(args) -> int:
    textures = load_archive(args.archive)
    print(f"{args.archive}: {len(textures)} textures")
    for name, ci in sorted(textures.items()):
        md = ci.get_metadata()
        print(f"  {name}: {md.compressor_name} {md.format.name} "
              f"{md.uncompressed_height}x{md.uncompressed_width} "
              f"({ci.get_data_size()} bytes)")
    return 0


def cmd_transcode(args) -> int:
    textures = load_archive(args.archive)
    if args.name not in textures:
        print(f"error: {args.name!r} not in archive "
              f"(has: {sorted(textures)})", file=sys.stderr)
        return 1
    ci = textures[args.name]
    md = ci.get_metadata()
    # DXT5 textures also carry compressor_name "dxtc" but hold 16-byte
    # RGBA blocks; transcoding those would corrupt the entry in place.
    if md.compressor_name != "dxtc" or num_format_components(md.format) != 3:
        print("error: transcode source must be a DXT1 (RGB dxtc) texture",
              file=sys.stderr)
        return 1
    transcode_dxt1_to_etc1(ci, quality=args.quality, device=args.device)
    md = ci.get_metadata()
    md.compressor_name = "etc"
    save_archive(args.archive, textures)
    print(f"{args.name}: transcoded to ETC1 in place")
    return 0


def cmd_mipmap(args) -> int:
    textures = load_archive(args.archive)
    if args.name not in textures:
        print(f"error: {args.name!r} not in archive "
              f"(has: {sorted(textures)})", file=sys.stderr)
        return 1
    ci = textures[args.name]
    comp = _compressor_for(ci, args.device)
    if not hasattr(comp, "downsample_chain"):
        print(f"error: {ci.get_metadata().compressor_name} does not "
              "support mipmap chains", file=sys.stderr)
        return 1
    chain = comp.downsample_chain(ci, args.levels)
    if not chain:
        print("error: downsample failed (check size constraints)",
              file=sys.stderr)
        return 1
    for i, mip in enumerate(chain, start=1):
        textures[f"{args.name}_mip{i}"] = mip
    save_archive(args.archive, textures)
    md = chain[-1].get_metadata()
    print(f"{args.name}: {len(chain)} mip levels (down to "
          f"{md.uncompressed_height}x{md.uncompressed_width})")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m texcomp_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")

    e = sub.add_parser("encode", parents=[common],
                       help="encode a .npy image into an archive")
    e.add_argument("--codec", choices=sorted(_CODECS), required=True)
    e.add_argument("--input", required=True, help=".npy (H, W, C) uint8")
    e.add_argument("--archive", required=True)
    e.add_argument("--name", default=None)
    e.add_argument("--quality", choices=["reference", "high"],
                   default="reference")
    e.add_argument("--strategy", type=int, default=2,
                   help="ETC1 strategy 0-3 (default kSmallerError)")
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", parents=[common],
                       help="decode a texture to .npy")
    d.add_argument("--archive", required=True)
    d.add_argument("--name", required=True)
    d.add_argument("--output", required=True)
    d.set_defaults(fn=cmd_decode)

    i = sub.add_parser("info", help="list archive contents")
    i.add_argument("--archive", required=True)
    i.set_defaults(fn=cmd_info)

    t = sub.add_parser("transcode-dxt1-etc1", parents=[common],
                       help="transcode a DXT1 texture to ETC1 in place")
    t.add_argument("--archive", required=True)
    t.add_argument("--name", required=True)
    t.add_argument("--quality", choices=["reference", "high"],
                   default="reference",
                   help="high: HQ ETC1 re-encode (never worse)")
    t.set_defaults(fn=cmd_transcode)

    m = sub.add_parser("mipmap", parents=[common],
                       help="add a mipmap chain for a texture to the archive")
    m.add_argument("--archive", required=True)
    m.add_argument("--name", required=True)
    m.add_argument("--levels", type=int, default=None,
                   help="number of levels (default: all the way to 1x1)")
    m.set_defaults(fn=cmd_mipmap)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
