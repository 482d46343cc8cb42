"""Content compression helpers (weed/util/compression.go:19-111).

The port's copy of ``seaweedfs_tpu/util/compression.py``.

The reference gzips compressible mime types on upload and negotiates
Accept-Encoding on read; zstd support is gated the same way it is
gated there (optional, used only when the codec exists). Stored bytes
carry no codec tag — `decompress` sniffs the magic (zstd 28 B5 2F FD,
gzip 1F 8B), exactly like util.DecompressData.
"""

from __future__ import annotations

import gzip

try:  # gated, like the reference's zstd dependency
    import zstandard as _zstd

    HAS_ZSTD = True
except ImportError:  # pragma: no cover - env without zstd
    _zstd = None
    HAS_ZSTD = False

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
GZIP_MAGIC = b"\x1f\x8b"

COMPRESSIBLE_PREFIXES = ("text/",)
COMPRESSIBLE_TYPES = {
    "application/json",
    "application/javascript",
    "application/xml",
    "application/x-ndjson",
    "image/svg+xml",
}
COMPRESSIBLE_EXTS = {
    ".txt", ".json", ".js", ".css", ".html", ".htm", ".xml", ".csv",
    ".log", ".md", ".svg",
}


def is_compressible(mime: str = "", name: str = "") -> bool:
    if mime:
        base = mime.split(";")[0].strip()
        if base.startswith(COMPRESSIBLE_PREFIXES):
            return True
        if base in COMPRESSIBLE_TYPES:
            return True
    if name and "." in name:
        ext = name[name.rfind(".") :].lower()
        if ext in COMPRESSIBLE_EXTS:
            return True
    return False


def compress(data: bytes, codec: str = "gzip") -> bytes:
    if codec == "zstd":
        if not HAS_ZSTD:
            raise RuntimeError("zstd codec not available")
        return _zstd.ZstdCompressor(level=3).compress(data)
    return gzip.compress(data, 6)


def decompress(data: bytes) -> bytes:
    """Codec-sniffing decompress (util.DecompressData)."""
    if data[:4] == ZSTD_MAGIC:
        if not HAS_ZSTD:
            raise RuntimeError("zstd-compressed data, codec missing")
        return _zstd.ZstdDecompressor().decompress(data)
    return gzip.decompress(data)


def maybe_compress(
    data: bytes, mime: str = "", name: str = "",
    min_gain: float = 0.9, codec: str = "gzip",
) -> tuple[bytes, bool]:
    """Compress when the type suggests it AND it actually shrinks
    (compression.go wants >10% gain)."""
    if len(data) < 128 or not is_compressible(mime, name):
        return data, False
    packed = compress(data, codec)
    if len(packed) < len(data) * min_gain:
        return packed, True
    return data, False
