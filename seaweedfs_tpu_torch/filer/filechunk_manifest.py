"""Chunk manifests: chunks-of-chunks for huge files.

Behavioral model: weed/filer/filechunk_manifest.go — entries whose chunk
list grows past the batch size fold batches into manifest blobs stored in
the volume tier; readers expand manifests (recursively) before interval
resolution. Keeps filer metadata O(1) for terabyte files.

The port's copy of ``seaweedfs_tpu/filer/filechunk_manifest.py``.
"""

from __future__ import annotations

import json
from typing import Callable

from .entry import FileChunk

MANIFEST_BATCH = 1000  # reference mergeFactor


def maybe_manifestize(
    upload_fn: Callable[[bytes], str],
    chunks: list[FileChunk],
    batch: int = MANIFEST_BATCH,
) -> list[FileChunk]:
    """Fold plain chunks into manifest chunks when there are > batch."""
    plain = [c for c in chunks if not c.is_chunk_manifest]
    manifests = [c for c in chunks if c.is_chunk_manifest]
    if len(plain) <= batch:
        return chunks
    plain.sort(key=lambda c: c.offset)
    out = list(manifests)
    for i in range(0, len(plain), batch):
        group = plain[i : i + batch]
        if len(group) == 1:
            out.append(group[0])
            continue
        blob = json.dumps(
            {"chunks": [c.to_dict() for c in group]}
        ).encode()
        fid = upload_fn(blob)
        start = min(c.offset for c in group)
        stop = max(c.offset + c.size for c in group)
        out.append(
            FileChunk(
                file_id=fid,
                offset=start,
                size=stop - start,
                mtime=max(c.mtime for c in group),
                is_chunk_manifest=True,
            )
        )
    return out


def resolve_chunk_manifest(
    fetch_fn: Callable[[str], bytes],
    chunks: list[FileChunk],
    depth: int = 0,
) -> list[FileChunk]:
    """Expand manifest chunks (recursively) into their data chunks."""
    if depth > 8:
        raise ValueError("chunk manifest nesting too deep")
    out: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        doc = json.loads(fetch_fn(c.file_id))
        inner = [FileChunk.from_dict(d) for d in doc["chunks"]]
        out.extend(
            resolve_chunk_manifest(fetch_fn, inner, depth + 1)
        )
    return out
