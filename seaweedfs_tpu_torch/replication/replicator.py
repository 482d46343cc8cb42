"""Replicator: maps meta events through a path prefix onto a sink.

Behavioral model: weed/replication/replicator.go:18-60.

The port's copy of ``seaweedfs_tpu/replication/replicator.py``.
"""

from __future__ import annotations

from ..util import http


class Replicator:
    def __init__(
        self,
        source_filer_url: str,
        sink,
        source_path_prefix: str = "/",
        sink_path_prefix: str = "/",
    ):
        self.source_filer_url = source_filer_url
        self.sink = sink
        self.source_prefix = source_path_prefix.rstrip("/") or ""
        self.sink_prefix = sink_path_prefix.rstrip("/") or ""

    def _map_path(self, path: str) -> str | None:
        if self.source_prefix and not path.startswith(
            self.source_prefix + "/"
        ):
            if path != self.source_prefix:
                return None
        suffix = path[len(self.source_prefix) :]
        return (self.sink_prefix + suffix) or "/"

    def replicate_event(self, event: dict) -> bool:
        """Apply one /meta/events record; returns True if it applied."""
        new, old = event.get("new_entry"), event.get("old_entry")
        entry = new or old
        if entry is None:
            return False
        path = self._map_path(entry["full_path"])
        if path is None:
            return False
        is_dir = bool(entry["attr"]["mode"] & 0o40000)
        if new is None:  # delete
            self.sink.delete_entry(path, is_dir)
            return True
        if is_dir:
            return False  # directories materialize implicitly
        content = http.request(
            "GET", f"{self.source_filer_url}{entry['full_path']}"
        )
        self.sink.create_entry(
            path,
            content,
            mime=entry["attr"].get("mime", ""),
            extended=entry.get("extended") or {},
        )
        return True
