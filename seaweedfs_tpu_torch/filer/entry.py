"""Filer entries: paths, attributes, chunk lists.

Behavioral model: weed/filer/entry.go, weed/pb/filer.proto Entry/FileChunk.

The port's copy of ``seaweedfs_tpu/filer/entry.py``.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field


@dataclass
class FileChunk:
    file_id: str  # "vid,keyhexcookiehex" on a volume server
    offset: int  # position in the logical file
    size: int
    mtime: int = 0  # ns; ordering resolves overlaps
    etag: str = ""
    is_chunk_manifest: bool = False
    cipher_key: str = ""  # base64 AES-GCM key; stored bytes encrypted
    is_compressed: bool = False

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class Attr:
    mtime: float = field(default_factory=time.time)
    crtime: float = field(default_factory=time.time)
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    group_names: list[str] = field(default_factory=list)
    symlink_target: str = ""
    md5: str = ""
    file_size: int = 0

    @property
    def is_directory(self) -> bool:
        return bool(self.mode & 0o40000)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Attr":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


DIR_MODE = 0o40000 | 0o770


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)
    hard_link_id: str = ""
    # link count for hardlinked entries (weed/pb/filer.proto Entry
    # HardLinkCounter); filled from the shared hardlink meta on read
    hard_link_counter: int = 0

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    @property
    def name(self) -> str:
        return self.full_path.rstrip("/").rsplit("/", 1)[-1]

    @property
    def parent(self) -> str:
        p = self.full_path.rstrip("/").rsplit("/", 1)[0]
        return p or "/"

    @property
    def size(self) -> int:
        from .filechunks import total_size

        return max(self.attr.file_size, total_size(self.chunks))

    def to_dict(self) -> dict:
        return {
            "full_path": self.full_path,
            "attr": self.attr.to_dict(),
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": self.extended,
            "hard_link_id": self.hard_link_id,
            "hard_link_counter": self.hard_link_counter,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        return cls(
            full_path=d["full_path"],
            attr=Attr.from_dict(d.get("attr", {})),
            chunks=[
                FileChunk.from_dict(c) for c in d.get("chunks", [])
            ],
            extended=d.get("extended", {}),
            hard_link_id=d.get("hard_link_id", ""),
            hard_link_counter=d.get("hard_link_counter", 0),
        )


def new_directory_entry(path: str) -> Entry:
    return Entry(full_path=path, attr=Attr(mode=DIR_MODE))
