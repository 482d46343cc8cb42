"""Storage backends: where a volume's .dat bytes physically live.

The port's copy of ``seaweedfs_tpu/storage/backend.py`` (SeaweedFS
weed/storage/backend/backend.go:15-45: the BackendStorageFile
abstraction, a local disk file or a remote tier). A volume whose .dat
was moved to a remote tier keeps serving reads through a remote
ReaderAt and is readonly; the remote here is any HTTP server honoring
Range. The ``.vif`` volume-info file (JSON, the analog of
weed/pb/volume_info.go) records the tier and the idx/ecx offset width a
volume was written with.

The S3 tier waits for the port of ``s3/`` (its reads are sigv4-signed
by ``s3.auth``): a ``.vif`` naming one raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Protocol

from ..util import http
from ..util.config import Configuration
from . import types as t


_backend_conf: Configuration | None = None


def _backend_configuration() -> Configuration:
    # cache the file discovery + parse; env overrides stay live because
    # Configuration.get consults os.environ on every lookup
    global _backend_conf
    if _backend_conf is None:
        _backend_conf = Configuration.load("backend")
    return _backend_conf


def resolve_backend_credentials(name: str) -> dict:
    """Look up a named backend in backend.json (the backend.toml
    analog: weed/storage/backend/backend.go LoadFromPbStorageBackends +
    BackendNameToTypeId). Credentials live here, master/volume-side —
    never in per-volume .vif files. Keys: s3.<name>.{endpoint,
    access_key,secret_key}; env-overridable as
    WEED_S3_<NAME>_ACCESS_KEY etc."""
    conf = _backend_configuration()
    return {
        "endpoint": conf.get_string(f"s3.{name}.endpoint"),
        "access_key": conf.get_string(f"s3.{name}.access_key"),
        "secret_key": conf.get_string(f"s3.{name}.secret_key"),
    }


class BackendStorageFile(Protocol):
    def read_at(self, offset: int, n: int) -> bytes: ...

    def size(self) -> int: ...

    def close(self) -> None: ...


class DiskFile:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")

    def read_at(self, offset: int, n: int) -> bytes:
        return os.pread(self._f.fileno(), n, offset)

    def size(self) -> int:
        return os.path.getsize(self.path)

    def close(self) -> None:
        self._f.close()


class HttpRangeBackend:
    """Remote .dat served over HTTP Range requests (S3-tier analog)."""

    def __init__(self, url: str, total_size: int | None = None):
        self.url = url if url.startswith("http") else f"http://{url}"
        self._size = total_size

    def read_at(self, offset: int, n: int) -> bytes:
        if n <= 0:
            return b""
        return http.request(
            "GET",
            self.url,
            headers={"Range": f"bytes={offset}-{offset + n - 1}"},
            timeout=60,
        )

    def size(self) -> int:
        if self._size is None:
            self._size = len(http.request("GET", self.url, timeout=300))
        return self._size

    def close(self) -> None:
        pass


def remote_backend_from_vif(remote: dict):
    """Build the right backend for a .vif 'remote' entry."""
    if remote.get("type") == "s3":
        raise NotImplementedError(
            f"s3 remote tier {remote.get('bucket')}/{remote.get('key')}: "
            "the port has no S3 backend yet (it comes with s3/)"
        )
    return HttpRangeBackend(remote["url"], remote.get("size"))


# -- .vif volume info (weed/pb/volume_info.go analog, json) ------------------


def volume_offset_width(base_file_name: str) -> int:
    """The idx/ecx offset width this volume was written with, from its
    .vif stamp; a missing stamp means the legacy/default 4 bytes."""
    return int(
        load_volume_info(base_file_name).get("offset_size") or 4
    )


def check_volume_offset_width(
    base_file_name: str, what: str
) -> None:
    """Refuse to open width-mismatched volume files — misparsing a
    16-byte-entry index as 17 (or vice versa) corrupts silently, the
    reference's 5BytesOffset build-tag mismatch failure mode."""
    vif_osz = volume_offset_width(base_file_name)
    if vif_osz != t.OFFSET_SIZE:
        raise RuntimeError(
            f"{what}: written with {vif_osz}-byte offsets but this "
            f"process runs {t.OFFSET_SIZE}-byte (WEED_LARGE_DISK "
            "mismatch)"
        )


def load_volume_info(base_file_name: str) -> dict:
    path = base_file_name + ".vif"
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def save_volume_info(base_file_name: str, info: dict) -> None:
    with open(base_file_name + ".vif", "w") as f:
        json.dump(info, f)
