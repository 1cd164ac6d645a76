"""CompressedImage container.

Python equivalent of image_compression/public/compressed_image.h:32-208:
a packed-payload container with Metadata{format, compressor_name,
uncompressed_h/w, compressed_h/w, padding_bytes_per_row} and owned vs
external storage. External storage lets callers hand in a preallocated
buffer (e.g. a memory-mapped asset file) that compression writes into.

:meth:`CompressedImage.to_arrays` and :meth:`CompressedImage.from_arrays`
carry a payload across packages as a metadata dict (with ``format`` as an
int) and a uint8 array.
"""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass, replace

import numpy as np


class Format(enum.IntEnum):
    """Supported image formats (compressed_image.h:35-40)."""

    RGB = 0
    BGR = 1  # used by DirectX
    RGBA = 2
    BGRA = 3


def num_format_components(fmt: Format) -> int:
    """3 for RGB/BGR, 4 for RGBA/BGRA (compressed_image.h:188-199)."""
    return 3 if fmt in (Format.RGB, Format.BGR) else 4


def needs_red_and_blue_swapped(fmt: Format) -> bool:
    """True for BGR/BGRA (compressed_image.h:202-204)."""
    return fmt in (Format.BGR, Format.BGRA)


@dataclass
class Metadata:
    """All metadata of a compressed image (compressed_image.h:43-81)."""

    format: Format = Format.RGB
    compressor_name: str = ""
    uncompressed_height: int = 0
    uncompressed_width: int = 0
    compressed_height: int = 0
    compressed_width: int = 0
    padding_bytes_per_row: int = 0

    def copy(self) -> "Metadata":
        return replace(self)


class CompressedImage:
    """A compressed image payload plus its metadata.

    Storage model (compressed_image.h:84-134): a default-constructed
    instance owns its data (reallocated by each producing operation); an
    instance constructed with ``external_data`` wraps caller-owned storage
    whose size must match exactly what the producing operation needs
    (compressor4x4_helper.cc:36-40).
    """

    def __init__(self, external_data: np.ndarray | memoryview | bytearray | None = None):
        self._metadata = Metadata()
        if external_data is None:
            self._data: np.ndarray = np.zeros(0, dtype=np.uint8)
            self._owns_data = True
        else:
            buf = np.frombuffer(external_data, dtype=np.uint8) if not isinstance(
                external_data, np.ndarray
            ) else external_data.view(np.uint8).reshape(-1)
            self._data = buf
            self._owns_data = False

    @classmethod
    def from_arrays(cls, metadata: dict, data: np.ndarray) -> "CompressedImage":
        """An owning instance from a metadata dict (the fields of
        :class:`Metadata`, ``format`` as an int) and the payload bytes."""
        md = Metadata(**{**metadata, "format": Format(int(metadata["format"]))})
        payload = np.asarray(data, dtype=np.uint8).reshape(-1)
        image = cls()
        image.create_owned_data(md, payload.size)
        image._data[:] = payload
        return image

    def to_arrays(self) -> tuple[dict, np.ndarray]:
        """(metadata dict with ``format`` as an int, copy of the payload)."""
        md = asdict(self._metadata)
        md["format"] = int(md["format"])
        return md, self._data.copy()

    # -- storage management ------------------------------------------------

    def owns_data(self) -> bool:
        return self._owns_data

    def create_owned_data(self, metadata: Metadata, data_size: int) -> None:
        """Allocate owned storage (compressed_image.h:127-134)."""
        self._metadata = metadata.copy()
        self._data = np.zeros(data_size, dtype=np.uint8)
        self._owns_data = True

    def set_metadata(self, metadata: Metadata) -> None:
        """Set metadata on an external-storage instance
        (compressed_image.h:139-142)."""
        if self._owns_data:
            raise ValueError(
                "set_metadata is for external-storage instances; "
                "use create_owned_data for owned storage")
        self._metadata = metadata.copy()

    def duplicate(self, other: "CompressedImage") -> None:
        """Deep-copy metadata + data from ``other``; this instance ends up
        owning its data (compressed_image.h:112-122)."""
        if other is self and self._owns_data:
            return
        src = other._data
        self.create_owned_data(other._metadata, src.size)
        self._data[:] = src

    # -- accessors -----------------------------------------------------------

    def get_metadata(self) -> Metadata:
        return self._metadata

    def get_data_size(self) -> int:
        return int(self._data.size)

    def get_data(self) -> np.ndarray:
        """Read-only uint8 view of the payload."""
        v = self._data.view()
        if v.flags.writeable:
            v.flags.writeable = False
        return v

    def get_mutable_data(self) -> np.ndarray:
        return self._data

    def tobytes(self) -> bytes:
        return self._data.tobytes()
