"""File ids: "volumeId,needleIdHexCookieHex" strings.

The port's copy of ``seaweedfs_tpu/storage/file_id.py``.

Reference format (weed/storage/needle/file_id.go:64-72): the 12-byte
big-endian concat of needle id (8B) and cookie (4B), leading zero BYTES of
the id stripped (never into the cookie), hex-encoded.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{self.needle_id_cookie}"

    @property
    def needle_id_cookie(self) -> str:
        raw = struct.pack(">QI", self.key, self.cookie & 0xFFFFFFFF)
        i = 0
        while i < 8 and raw[i] == 0:
            i += 1
        return raw[i:].hex()

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        comma = fid.find(",")
        if comma <= 0:
            raise ValueError(f"wrong fid format: {fid!r}")
        vid = int(fid[:comma])
        key, cookie = parse_needle_id_cookie(fid[comma + 1 :])
        return cls(vid, key, cookie)


def parse_needle_id_cookie(s: str) -> tuple[int, int]:
    """Hex key+cookie (cookie = last 8 hex chars) → (key, cookie).

    The reference strips a "_altKey" suffix used by chunked uploads
    (file_id.go ParseNeedleIdCookie via splitVolumeId callers).
    """
    if "_" in s:
        s = s.split("_", 1)[0]
    if len(s) < 8:
        raise ValueError(f"needle id+cookie too short: {s!r}")
    if len(s) % 2 == 1:
        s = "0" + s
    raw = bytes.fromhex(s)
    cookie = struct.unpack(">I", raw[-4:])[0]
    key = int.from_bytes(raw[:-4], "big")
    return key, cookie
