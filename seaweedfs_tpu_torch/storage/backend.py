"""Storage backends: where a volume's .dat bytes physically live.

The port's copy of ``seaweedfs_tpu/storage/backend.py`` (SeaweedFS
weed/storage/backend/backend.go:15-45: the BackendStorageFile
abstraction, a local disk file or a remote tier). A volume whose .dat
was moved to a remote tier keeps serving reads through a remote
ReaderAt and is readonly; the remote here is any HTTP server honoring
Range. The ``.vif`` volume-info file (JSON, the analog of
weed/pb/volume_info.go) records the tier and the idx/ecx offset width a
volume was written with.

The S3 tier (:class:`S3Backend`) keeps the .dat as one object in an
S3-compatible store, read with sigv4-signed ranged GETs (``s3.auth``).
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


def reload_backend_configuration() -> None:
    global _backend_conf
    _backend_conf = None


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


class S3Backend:
    """Cloud-tier backend: the volume's .dat lives as one object in an
    S3-compatible store (weed/storage/backend/s3_backend/s3_backend.go:
    20-50). Reads are sigv4-signed ranged GETs; upload is a single
    signed PUT (UNSIGNED-PAYLOAD, streamed from disk). Works against
    any S3 endpoint, including this build's own gateway."""

    def __init__(
        self,
        endpoint: str,
        bucket: str,
        key: str,
        access_key: str = "",
        secret_key: str = "",
        total_size: int | None = None,
        backend_name: str = "default",
    ):
        if not access_key or not endpoint:
            creds = resolve_backend_credentials(backend_name)
            endpoint = endpoint or creds["endpoint"]
            if not access_key:
                access_key = creds["access_key"]
                secret_key = creds["secret_key"]
        if not endpoint:
            raise ValueError(
                f"s3 backend {backend_name!r}: no endpoint — pass "
                "-s3.endpoint or set "
                f"s3.{backend_name}.endpoint in backend.json"
            )
        self.endpoint = (
            endpoint if endpoint.startswith("http")
            else f"http://{endpoint}"
        )
        self.bucket = bucket
        self.key = key.lstrip("/")
        self.backend_name = backend_name
        self.access_key = access_key
        self.secret_key = secret_key
        self._size = total_size

    def spec(self) -> dict:
        """Serializable .vif form. Carries only the backend *name* plus
        non-secret locators — credentials are resolved from backend.json
        at load time (the reference stores backend type/id in the .vif
        RemoteFile and keeps keys in backend.toml,
        weed/storage/backend/s3_backend/s3_backend.go)."""
        return {
            "type": "s3",
            "backend": self.backend_name,
            "endpoint": self.endpoint,
            "bucket": self.bucket,
            "key": self.key,
            "size": self._size,
        }

    @classmethod
    def from_spec(cls, spec: dict) -> "S3Backend":
        name = spec.get("backend", "default")
        creds = resolve_backend_credentials(name)
        return cls(
            endpoint=spec.get("endpoint") or creds["endpoint"],
            bucket=spec["bucket"],
            key=spec["key"],
            # legacy .vif files carried inline credentials; honor them
            # so pre-existing tiered volumes keep serving
            access_key=spec.get("access_key") or creds["access_key"],
            secret_key=spec.get("secret_key") or creds["secret_key"],
            total_size=spec.get("size"),
            backend_name=name,
        )

    @property
    def _path(self) -> str:
        return f"/{self.bucket}/{self.key}"

    def _headers(self, method: str, extra: dict | None = None) -> dict:
        import time as time_mod
        import urllib.parse as up

        headers = dict(extra or {})
        if not self.access_key:
            return headers
        from ..s3.auth import Identity, sign_request_v4

        amz_date = time_mod.strftime(
            "%Y%m%dT%H%M%SZ", time_mod.gmtime()
        )
        host = up.urlsplit(self.endpoint).netloc
        headers.update(
            {
                "Host": host,
                "X-Amz-Date": amz_date,
                "X-Amz-Content-Sha256": "UNSIGNED-PAYLOAD",
            }
        )
        headers["Authorization"] = sign_request_v4(
            Identity("tier", self.access_key, self.secret_key),
            method,
            self._path,
            {},
            headers,
            b"",
            amz_date,
        )
        return headers

    def read_at(self, offset: int, n: int) -> bytes:
        if n <= 0:
            return b""
        return http.request(
            "GET",
            f"{self.endpoint}{self._path}",
            headers=self._headers(
                "GET",
                {"Range": f"bytes={offset}-{offset + n - 1}"},
            ),
            timeout=60,
            tls="public",
        )

    def size(self) -> int:
        if self._size is None:
            # HEAD (or a 1-byte ranged GET's Content-Range total) —
            # never download a multi-GB object just to measure it
            try:
                with http.request_stream(
                    "HEAD",
                    f"{self.endpoint}{self._path}",
                    headers=self._headers("HEAD"),
                    timeout=60,
                    tls="public",
                ) as r:
                    n = int(r.headers.get("Content-Length") or 0)
                if n:
                    self._size = n
                    return n
            except (http.HttpError, ValueError):
                pass
            with http.request_stream(
                "GET",
                f"{self.endpoint}{self._path}",
                headers=self._headers("GET", {"Range": "bytes=0-0"}),
                timeout=60,
                tls="public",
            ) as r:
                total = (r.headers.get("Content-Range") or "").rsplit(
                    "/", 1
                )[-1]
                r.read()
                self._size = int(total)
        return self._size

    def upload_file(self, path: str) -> int:
        """PUT the .dat as the object, streamed from disk (the tier-up
        half of volume_grpc_tier_upload.go)."""
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            http.request(
                "PUT",
                f"{self.endpoint}{self._path}",
                f,
                self._headers("PUT"),
                timeout=3600,
                tls="public",
            )
        self._size = size
        return size

    def download_file(self, path: str) -> int:
        with http.request_stream(
            "GET",
            f"{self.endpoint}{self._path}",
            headers=self._headers("GET"),
            timeout=3600,
            tls="public",
        ) as r, open(path, "wb") as f:
            n = 0
            for piece in r.iter(1 << 20):
                f.write(piece)
                n += len(piece)
        return n

    def delete_object(self) -> None:
        try:
            http.request(
                "DELETE",
                f"{self.endpoint}{self._path}",
                headers=self._headers("DELETE"),
                timeout=60,
                tls="public",
            )
        except http.HttpError:
            pass

    def close(self) -> None:
        pass


def remote_backend_from_vif(remote: dict):
    """Build the right backend for a .vif 'remote' entry."""
    if remote.get("type") == "s3":
        return S3Backend.from_spec(remote)
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
            f"process runs {t.OFFSET_SIZE}-byte (set_offset_size / "
            "WEED_LARGE_DISK mismatch)"
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
