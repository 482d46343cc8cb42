"""Client-side auto-split submit (weed/operation/submit.go:121-216).

`weed upload` of a file larger than maxMB produces a chunk manifest
WITHOUT a filer in the path: each chunk is assigned + uploaded
independently (with per-chunk retry), then a ChunkManifest JSON is
stored under the primary fid with the IsChunkManifest needle flag; the
volume server read path resolves the manifest back into one stream.

The port's copy of ``seaweedfs_tpu/operation/submit.py``.
"""

from __future__ import annotations

import json
import os
from typing import BinaryIO

from ..util import http
from . import client as op


def upload_chunk_data(
    master_url: str,
    data: bytes,
    collection: str = "",
    replication: str = "",
    ttl: str = "",
    retries: int = 3,
) -> tuple[str, int]:
    """One chunk: assign + upload with re-assign retry
    (submit.go upload_one_chunk)."""
    return op.upload_data(
        master_url, data,
        collection=collection, replication=replication, ttl=ttl,
        retries=retries,
    )


def submit_file(
    master_url: str,
    path: str | os.PathLike | None = None,
    reader: BinaryIO | None = None,
    name: str = "",
    mime: str = "",
    collection: str = "",
    replication: str = "",
    ttl: str = "",
    max_mb: int = 4,
) -> tuple[str, int]:
    """Upload one file, auto-splitting past max_mb (submit.go:121-216).

    Returns (fid, total size). Small files take the plain single-needle
    path; large files become N independently-placed chunks + a manifest
    needle under the primary fid. Failed submissions clean up any chunks
    already uploaded.
    """
    if reader is None:
        if path is None:
            raise ValueError("need path or reader")
        reader = open(path, "rb")
        close_reader = True
        name = name or os.path.basename(os.fspath(path))
    else:
        close_reader = False
    chunk_size = max_mb * 1024 * 1024
    try:
        first = reader.read(chunk_size)
        rest_probe = reader.read(1)
        if not rest_probe:  # fits in one needle
            return op.upload_data(
                master_url, first, name=name, mime=mime,
                collection=collection, replication=replication, ttl=ttl,
            )
        # multi-chunk: primary fid carries the manifest
        primary = op.assign(
            master_url, collection=collection,
            replication=replication, ttl=ttl,
        )
        chunks: list[dict] = []
        offset = 0
        piece, carry = first, rest_probe
        try:
            while piece:
                fid, _ = upload_chunk_data(
                    master_url, piece,
                    collection=collection, replication=replication,
                    ttl=ttl,
                )
                chunks.append(
                    {"fid": fid, "offset": offset, "size": len(piece)}
                )
                offset += len(piece)
                piece = carry + reader.read(chunk_size - len(carry))
                carry = b""
            manifest = {
                "name": name,
                "mime": mime or "application/octet-stream",
                "size": offset,
                "chunks": chunks,
            }
            import urllib.parse

            params = {"cm": "true"}
            if name:
                params["name"] = name
            qs = "?" + urllib.parse.urlencode(params)
            headers = {}
            if primary.auth:
                headers["Authorization"] = f"BEARER {primary.auth}"
            http.request(
                "POST",
                f"{primary.url}/{primary.fid}{qs}",
                json.dumps(manifest).encode(),
                headers,
                timeout=120,
            )
            return primary.fid, offset
        except Exception:
            # don't leak orphan chunks on a failed submit
            for c in chunks:
                try:
                    op.delete_file(master_url, c["fid"])
                except Exception:
                    pass
            raise
    finally:
        if close_reader:
            reader.close()


def submit_files(
    master_url: str,
    paths: list[str],
    collection: str = "",
    replication: str = "",
    ttl: str = "",
    max_mb: int = 4,
) -> list[dict]:
    """SubmitFiles (submit.go:44): one result dict per input file."""
    results = []
    for p in paths:
        fid, size = submit_file(
            master_url, p,
            collection=collection, replication=replication,
            ttl=ttl, max_mb=max_mb,
        )
        results.append(
            {"fileName": os.fspath(p), "fid": fid, "size": size}
        )
    return results
