"""Incremental volume backup over the tail API.

Behavioral model: weed/storage/volume_backup.go:65-235 — find the local
replica's latest append timestamp, fetch only newer records from the
source server, append them, and fold the new records into the .idx.

The port's copy of ``seaweedfs_tpu/storage/volume_backup.py``: a backup
it writes replays byte for byte as the reference's does.
"""

from __future__ import annotations

import os

from ..util import http
from . import needle as needle_mod, types as t
from .volume import Volume


def last_append_at_ns(vol: Volume) -> int:
    """append_at_ns of the record at the highest .dat offset."""
    best_off = 0
    for _, nv in vol.nm.ascending_visit():
        if nv.offset > best_off:
            best_off = nv.offset
    if best_off == 0:
        return 0
    try:
        return vol._read_record_at(best_off).append_at_ns
    except Exception:
        return 0


def incremental_backup(
    directory: str, collection: str, vid: int, source_url: str
) -> int:
    """Pull new records from `source_url` into the local replica;
    creates the volume from scratch on first run. Returns bytes added."""
    base = os.path.join(
        directory,
        f"{collection}_{vid}" if collection else str(vid),
    )
    if not os.path.exists(base + ".dat"):
        for ext in (".dat", ".idx"):
            data = http.request(
                "GET",
                f"{source_url}/admin/ec/download?volume={vid}"
                f"&collection={collection}&ext={ext}",
                timeout=3600,
            )
            with open(base + ext, "wb") as f:
                f.write(data)
        return os.path.getsize(base + ".dat")

    vol = Volume(directory, collection, vid)
    try:
        since = last_append_at_ns(vol)
        tail = http.request(
            "GET",
            f"{source_url}/admin/tail?volume={vid}"
            f"&since_ns={since + 1}",
            timeout=3600,
        )
        if not tail:
            return 0
        # append + replay records into the needle map
        vol._dat.seek(0, os.SEEK_END)
        start = vol._dat.tell()
        vol._dat.write(tail)
        vol._dat.flush()
        offset = start
        end = start + len(tail)
        while offset + t.NEEDLE_HEADER_SIZE <= end:
            n = needle_mod.Needle.parse_header(
                vol._pread(offset, t.NEEDLE_HEADER_SIZE)
            )
            total = needle_mod.get_actual_size(n.size, vol.version)
            if offset + total > end:
                break
            if n.size > 0:
                vol.nm.put(n.id, offset, n.size)
            else:
                vol.nm.delete(n.id, offset)
            offset += total
        return len(tail)
    finally:
        vol.close()
