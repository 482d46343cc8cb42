"""Replication sinks: where meta events get applied.

Behavioral model: weed/replication/sink/ — filersink (re-upload content
to a target filer), localsink (materialize to a local directory). The
s3/gcs/azure/b2 sinks of the reference reduce to the filer sink pointed
at an S3 gateway's backing filer in this build.

The port's copy of ``seaweedfs_tpu/replication/sink.py``.
"""

from __future__ import annotations

import os

from ..util import http

SYNC_MARKER_HEADER = "Seaweed-Sync-Source"


class FilerSink:
    """Applies events to another filer over HTTP, re-uploading content.

    Tags every write with the source id so active-active sync loops
    terminate (the reference's signature loop-breaking,
    weed/command/filer_sync.go:89-320)."""

    def __init__(self, filer_url: str, source_id: str = ""):
        self.filer_url = filer_url
        self.source_id = source_id

    def create_entry(
        self, path: str, content: bytes, mime: str = "",
        extended: dict | None = None,
    ) -> None:
        headers = {"Content-Type": mime or "application/octet-stream"}
        for k, v in (extended or {}).items():
            if k.lower().startswith(("seaweed-", "x-amz-")):
                headers[k] = v
        if self.source_id:
            headers[SYNC_MARKER_HEADER] = self.source_id
        http.request(
            "POST", f"{self.filer_url}{path}", content, headers
        )

    def delete_entry(self, path: str, is_directory: bool) -> None:
        qs = "?recursive=true" if is_directory else ""
        try:
            http.request(
                "DELETE", f"{self.filer_url}{path}{qs}"
            )
        except http.HttpError:
            pass

    def fetch(self, path: str) -> bytes:
        return http.request("GET", f"{self.filer_url}{path}")


class LocalSink:
    """Materializes the replicated tree on the local filesystem
    (weed/replication/sink/localsink)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def create_entry(
        self, path: str, content: bytes, mime: str = "",
        extended: dict | None = None,
    ) -> None:
        dst = os.path.join(self.root, path.lstrip("/"))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(content)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        dst = os.path.join(self.root, path.lstrip("/"))
        if os.path.isdir(dst):
            import shutil

            shutil.rmtree(dst, ignore_errors=True)
        elif os.path.exists(dst):
            os.remove(dst)
