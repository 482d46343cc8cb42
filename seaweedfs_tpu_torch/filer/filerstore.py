"""FilerStore SPI (weed/filer/filerstore.go:18-41): 13-method contract.

Stores register themselves in STORE_REGISTRY, mirroring the reference's
side-effect driver imports (weed/server/filer_server.go:23-37).

The port's copy of ``seaweedfs_tpu/filer/filerstore.py``.
"""

from __future__ import annotations

from typing import Iterator, Protocol

from .entry import Entry

STORE_REGISTRY: dict[str, type] = {}


def register_store(name: str):
    def deco(cls):
        STORE_REGISTRY[name] = cls
        return cls

    return deco


class FilerStore(Protocol):
    name: str

    def insert_entry(self, entry: Entry) -> None: ...

    def update_entry(self, entry: Entry) -> None: ...

    def find_entry(self, path: str) -> Entry | None: ...

    def delete_entry(self, path: str) -> None: ...

    def delete_folder_children(self, path: str) -> None: ...

    def list_directory_entries(
        self,
        dir_path: str,
        start_file: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]: ...

    # KV store (weed/filer SPI KvPut/KvGet/KvDelete)
    def kv_put(self, key: bytes, value: bytes) -> None: ...

    def kv_get(self, key: bytes) -> bytes | None: ...

    def kv_delete(self, key: bytes) -> None: ...

    def begin_transaction(self) -> None: ...

    def commit_transaction(self) -> None: ...

    def rollback_transaction(self) -> None: ...

    def close(self) -> None: ...
