"""Filer server: HTTP object API over the filer metadata + volume data.

Behavioral model: weed/server/filer_server.go,
filer_server_handlers_read.go / _write.go / _write_autochunk.go:
GET streams chunks, POST/PUT auto-chunk uploads, DELETE recursive,
directory listing JSON, rename via mv.from, extended attrs from
Seaweed-* headers, /meta/events for subscribers.

The port's copy of ``seaweedfs_tpu/server/filer.py``. ``filer_peers``
is the meta aggregator: one ``replication/sync.py`` ``FilerSync`` from
each peer into this filer. One difference: a write uploads each piece
under a budget (``WRITE_BUDGET_SECONDS``; ``operation.upload_data``
leaves a quarter of it for a fresh assignment), so no piece holds the
writing client past its own timeout; a write that
fails deletes the chunks it had uploaded, and its span carries each
try's hop seconds (``hops``, shown in ``/debug/slow``).
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
import time
import urllib.parse

from .. import fault, operation, tracing
from ..operation import masters as masters_mod
from ..filer import Entry, Filer, MemoryStore, SqliteStore
from ..filer.entry import Attr, FileChunk
from ..filer.filechunks import (
    non_overlapping_visible_intervals,
    read_resolved_chunks,
    total_size,
)
from ..telemetry.reporter import TelemetryReporter
from ..telemetry.snapshot import (
    FILER_SHARDS,
    mark_started,
    metrics_response,
)
from ..tracing import middleware as trace_mw
from ..util import http
from ..util import retry as retry_mod
from ..util.http import Request, Response, Router


# seconds one piece's upload (assign, volume write, and any re-assigns)
# may take: well inside the 30 s the filer's clients wait on a silent
# socket, since the client is blocked sending the next piece meanwhile
WRITE_BUDGET_SECONDS = 20.0


class FilerServer:
    def __init__(
        self,
        master_url: str,
        host: str = "127.0.0.1",
        port: int = 0,
        store=None,
        chunk_size: int = 8 * 1024 * 1024,
        collection: str = "",
        replication: str = "",
        manifest_batch: int = 1000,
        filer_peers: list[str] | None = None,
        jwt_signing_key: str = "",
        meta_log_dir: str | None = None,
        chunk_cache_dir: str | None = None,
        chunk_cache_mem: int = 64 * 1024 * 1024,
        watch_locations: bool = True,
        ssl_context=None,
        telemetry_interval: float = 10.0,
        shard: tuple[int, int] | None = None,
    ):
        # push-based location cache (wdclient KeepConnected analog):
        # chunk reads resolve moved volumes without a failed request
        self.watch_locations = watch_locations
        self.manifest_batch = manifest_batch
        # Shared write-signing key (security.toml model): lets the filer
        # mint its own fid-scoped tokens for chunk deletes.
        self.jwt_signing_key = jwt_signing_key
        # MetaAggregator analog (weed/filer/meta_aggregator.go): pull
        # every peer filer's meta events into this one for multi-filer
        # HA; loop prevention via the sync source markers.
        self.filer_peers = filer_peers or []
        self._peer_syncs = []
        # every master round-trip (assign proxy, chunk upload/delete,
        # manifest resolution) rides the ring's leader re-resolution:
        # a leader failover costs writers a latency spike, not an
        # error burst (masterclient.go model). Accepts one URL or the
        # full candidate list.
        self.master_ring = masters_mod.ring_of(master_url)
        self.master_url = self.master_ring.leader()
        self.chunk_size = chunk_size
        self.collection = collection
        self.replication = replication
        # (index, of): this server's slot in a sharded filer tier
        # (filer/sharding). None = unsharded. The metadata-op ledger
        # label is the BOUNDED shard index, never a URL or path.
        self.shard = shard
        self._shard_label = (
            f"shard{shard[0]}" if shard is not None else "shard0"
        )
        self.filer = Filer(
            store if store is not None else MemoryStore(),
            delete_chunks_fn=self._delete_chunks,
            event_log_dir=meta_log_dir,
        )
        from ..util.chunk_cache import TieredChunkCache

        self.chunk_cache = TieredChunkCache(
            mem_limit=chunk_cache_mem, disk_dir=chunk_cache_dir
        )
        router = Router()
        fault.install_routes(router)
        router.add("GET", r"/metrics", self._h_metrics)
        router.add("GET", r"/meta/events", self._h_meta_events)
        router.add("GET", r"/__assign", self._h_assign)
        router.add("*", r"/__kv/.+", self._h_kv)
        router.add("*", r"/.*", self._h_object)
        self.server = http.HttpServer(
            trace_mw.instrument(router, "filer"),
            host, port, ssl_context=ssl_context,
        )
        # the filer has no heartbeat: its telemetry snapshot is pushed
        # to the master periodically instead (telemetry/reporter.py);
        # 0 disables
        self.telemetry_interval = telemetry_interval
        self._telemetry_reporter: TelemetryReporter | None = None

    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> None:
        self.server.start()
        mark_started("filer")
        if self.telemetry_interval > 0:
            extra = None
            if self.shard is not None:
                # shard identity rides every pushed snapshot: the
                # master assembles the FilerShards map from these
                extra = {"filer_shard": {
                    "index": self.shard[0],
                    "of": self.shard[1],
                    "url": self.url,
                }}
            self._telemetry_reporter = TelemetryReporter(
                "filer", self.url, self.master_url,
                interval=self.telemetry_interval,
                extra=extra,
                tally=self.server.router.tally,
            )
            self._telemetry_reporter.start()
        if self.watch_locations:
            operation.start_location_watch(self.master_url)
        if self.filer_peers:
            from ..replication.sync import FilerSync

            for peer in self.filer_peers:
                if peer == self.url:
                    continue
                sync = FilerSync(
                    peer, self.url, bidirectional=False,
                    poll_seconds=1.0,
                )
                sync.start()
                self._peer_syncs.append(sync)

    def stop(self) -> None:
        if self._telemetry_reporter is not None:
            self._telemetry_reporter.stop()
        for sync in self._peer_syncs:
            sync.stop()
        if self.watch_locations:
            operation.stop_location_watch(self.master_url)
        self.server.stop()
        self.filer.close()

    # -- chunk plumbing --------------------------------------------------

    def _delete_chunks(self, chunks: list[FileChunk]) -> None:
        for c in chunks:
            try:
                operation.delete_file(
                    self.master_ring, c.file_id,
                    jwt_signing_key=self.jwt_signing_key,
                )
            except Exception:
                pass

    def _resolve_chunks(self, entry: Entry) -> list[FileChunk]:
        chunks = entry.chunks
        if any(c.is_chunk_manifest for c in chunks):
            from ..filer.filechunk_manifest import resolve_chunk_manifest

            chunks = resolve_chunk_manifest(
                lambda fid: operation.read_file(self.master_ring, fid),
                chunks,
            )
        return chunks

    def _stream_chunks(self, entry: Entry, offset: int, size: int):
        """Yield [offset, offset+size) of the entry chunk-by-chunk —
        the filer never holds more than one chunk in memory
        (weed/filer/stream.go:16-213 StreamContent). Sparse holes are
        zero-filled in bounded pieces."""
        chunks = self._resolve_chunks(entry)
        visibles = non_overlapping_visible_intervals(chunks)
        pieces = read_resolved_chunks(visibles, offset, size)
        keys = {
            c.file_id: (c.cipher_key, c.is_compressed) for c in chunks
        }
        pos = offset
        stop = offset + size
        for v, chunk_off, n in pieces:
            lo = max(offset, v.start)
            while pos < lo:  # hole before this interval
                gap = min(lo - pos, 1 << 20)
                yield bytes(gap)
                pos += gap
            data = self._fetch_chunk(v.file_id, keys.get(v.file_id))
            yield bytes(data[chunk_off : chunk_off + n])
            pos += n
        while pos < stop:  # trailing hole
            gap = min(stop - pos, 1 << 20)
            yield bytes(gap)
            pos += gap

    def _fetch_chunk(self, file_id: str, crypt) -> bytes:
        """Chunk fetch through the tiered cache with singleflight:
        concurrent readers of the same chunk share ONE upstream fetch
        (weed/filer/reader_at.go:18-80 + util/chunk_cache)."""

        def fetch() -> bytes:
            data = operation.read_file(self.master_ring, file_id)
            if crypt:
                cipher_key, is_compressed = crypt
                if cipher_key:
                    import base64

                    from ..util import cipher

                    data = cipher.decrypt(
                        data, base64.b64decode(cipher_key)
                    )
                if is_compressed:
                    from ..util import compression

                    data = compression.decompress(data)
            return data

        return self.chunk_cache.get_or_fetch(file_id, fetch)

    def _h_metrics(self, req: Request) -> Response:
        return metrics_response()

    # -- handlers --------------------------------------------------------

    def _h_assign(self, req: Request) -> Response:
        """Proxy volume assignment to the master, so mount/gateway
        clients only ever need the filer address
        (weed/server/filer_grpc_server.go AssignVolume)."""
        tracing.set_op("assign")
        qs = {
            k: v[0]
            for k, v in req.query.items()
            if k in ("count", "collection", "replication", "ttl")
        }
        qs.setdefault("collection", self.collection)
        qs.setdefault("replication", self.replication)
        qs = {k: v for k, v in qs.items() if v}
        # through the ring: a mid-election assign WAITS for the new
        # leader (election_patience_s) instead of erroring — mount and
        # gateway writers never see the failover
        out = self.master_ring.get_json(
            "/dir/assign?" + urllib.parse.urlencode(qs)
        )
        return Response.json(out)

    def _h_object(self, req: Request) -> Response:
        # object paths are unbounded: refine the span op to the verb
        op = {"POST": "write", "PUT": "write", "DELETE": "delete"}.get(
            req.method, "read"
        )
        tracing.set_op(op)
        t0 = time.monotonic()
        ok = False
        try:
            fault.point("filer.store.op", op=op, path=req.path)
            resp = self._object_inner(req)
            ok = resp.status < 500
            return resp
        except (fault.FaultInjected, sqlite3.OperationalError) as e:
            # a TRANSIENT metadata-store failure is retriable by the
            # client — 503, never a 500 or a silently wrong answer
            # (the broker's _recover_next_offset discipline)
            return Response.error(
                f"filer store transient error: {e}", 503
            )
        finally:
            # per-shard metadata-op golden signals (bounded label)
            FILER_SHARDS.record(
                self._shard_label, time.monotonic() - t0, ok
            )

    def _object_inner(self, req: Request) -> Response:
        path = urllib.parse.unquote(req.path)
        if req.method in ("POST", "PUT"):
            if mv_from := req.param("mv.from"):
                tracing.set_op("rename")
                self.filer.rename(mv_from, path)
                return Response.json({"ok": True})
            if ln_from := req.param("ln.from"):
                # hardlink: path becomes another name for ln.from's
                # inode (weed/filesys/dir_link.go Link over gRPC)
                try:
                    e = self.filer.link(ln_from, path)
                except FileNotFoundError:
                    return Response.error("source not found", 404)
                except FileExistsError:
                    return Response.error("target exists", 409)
                except IsADirectoryError:
                    return Response.error(
                        "cannot hardlink a directory", 400
                    )
                return Response.json(
                    {"ok": True, "nlink": e.hard_link_counter}
                )
            if req.param("entry") == "true":
                return self._write_entry(req, path)
            return self._write(req, path)
        if req.method == "DELETE":
            try:
                self.filer.delete_entry(
                    path,
                    recursive=req.param("recursive") == "true",
                    # gc=false: metadata-only delete — the cross-shard
                    # rename source side, where the moved entry on the
                    # destination shard still owns the chunks
                    gc_chunks=req.param("gc") != "false",
                )
            except IsADirectoryError as e:
                return Response.error(str(e), 409)
            return Response(status=204)
        if req.method in ("GET", "HEAD"):
            return self._read(req, path)
        return Response.error("method not allowed", 405)

    def _write_entry(self, req: Request, path: str) -> Response:
        """Create an entry directly from a JSON chunk list — the HTTP
        analog of the filer gRPC CreateEntry used by the FUSE mount's
        dirty-page flush (weed/server/filer_grpc_server.go CreateEntry):
        chunk data was already uploaded to volume servers; only the
        metadata commit happens here."""
        d = req.json()
        d["full_path"] = path
        entry = Entry.from_dict(d)
        self.filer.create_entry(entry)
        return Response.json({"name": entry.name, "size": entry.size})

    def _read_piece(self, reader, n: int) -> bytes:
        """Read exactly n bytes from the request body reader (short only
        at end-of-body)."""
        parts = []
        got = 0
        while got < n:
            piece = reader.read(n - got)
            if not piece:
                break
            parts.append(piece)
            got += len(piece)
        return b"".join(parts)

    def _write(self, req: Request, path: str) -> Response:
        if path.endswith("/"):
            self.filer.mkdir(path.rstrip("/") or "/")
            return Response.json({"name": path, "size": 0})
        use_cipher = req.param("cipher") == "true"
        mime_hdr = req.headers.get("Content-Type", "")
        chunks: list[FileChunk] = []
        # one row a try of each piece's upload, on the request's span
        hops: list[dict] = []
        span = tracing.current()
        if span is not None:
            span.attrs["hops"] = hops
        md5 = hashlib.md5()
        # Incremental auto-chunking: read one chunk at a time off the
        # socket and upload it before reading the next, so filer memory
        # stays O(chunk_size) regardless of object size
        # (weed/server/filer_server_handlers_write_autochunk.go:232-301).
        off = 0
        while True:
            piece = self._read_piece(req.reader, self.chunk_size)
            if not piece and off > 0:
                break
            md5.update(piece)
            plain_len = len(piece)
            cipher_key_b64 = ""
            compressed = False
            if not use_cipher:
                from ..util import compression

                piece, compressed = compression.maybe_compress(
                    piece, mime_hdr, path
                )
            else:
                import base64

                from ..util import cipher

                key = cipher.gen_cipher_key()
                piece = cipher.encrypt(piece, key)
                cipher_key_b64 = base64.b64encode(key).decode()
            tries: list[dict] = []
            try:
                with retry_mod.deadline_scope(WRITE_BUDGET_SECONDS):
                    fid, _ = operation.upload_data(
                        self.master_ring,
                        piece,
                        collection=(
                            req.param("collection") or self.collection
                        ),
                        replication=(
                            req.param("replication") or self.replication
                        ),
                        ttl=req.param("ttl"),
                        hops=tries,
                    )
            except (http.HttpError, RuntimeError) as e:
                # nothing of a failed write stays behind it
                self._delete_chunks(chunks)
                return Response.error(f"{type(e).__name__}: {e}", 500)
            finally:
                hops.extend(
                    dict(t, piece=len(chunks)) for t in tries
                )
            chunks.append(
                FileChunk(
                    file_id=fid,
                    offset=off,
                    size=plain_len,
                    mtime=time.time_ns(),
                    cipher_key=cipher_key_b64,
                    is_compressed=compressed,
                )
            )
            off += plain_len
            if plain_len < self.chunk_size:
                break
        total_len = off
        if req.reader.truncated:
            # body ended before its framing said it should — never
            # commit a half-received object as a complete entry
            self._delete_chunks(chunks)
            return Response.error("request body truncated", 400)
        if len(chunks) > self.manifest_batch:
            from ..filer.filechunk_manifest import maybe_manifestize

            chunks = maybe_manifestize(
                lambda blob: operation.upload_data(
                    self.master_ring, blob
                )[0],
                chunks,
                batch=self.manifest_batch,
            )
        mime = req.headers.get("Content-Type", "")
        extended = {
            k: v
            for k, v in req.headers.items()
            if k.lower().startswith("seaweed-")
            or k.lower().startswith("x-amz-")
        }
        entry = Entry(
            full_path=path,
            attr=Attr(
                mime=mime,
                md5=md5.hexdigest(),
                file_size=total_len,
            ),
            chunks=chunks,
            extended=extended,
        )
        self.filer.create_entry(entry)
        return Response.json(
            {"name": entry.name, "size": total_len,
             "eTag": md5.hexdigest()}
        )

    def _read(self, req: Request, path: str) -> Response:
        entry = self.filer.find_entry(path)
        if entry is None:
            return Response.error("not found", 404)
        if req.param("meta") == "true":
            # raw entry metadata (chunk list included) — the HTTP
            # analog of filer gRPC LookupDirectoryEntry, used by the
            # mount to merge dirty-page chunks into existing entries
            return Response.json(entry.to_dict())
        if entry.is_directory:
            limit = int(req.param("limit", "100"))
            last = req.param("lastFileName")
            entries = self.filer.list_entries(
                path.rstrip("/") or "/", start_file=last, limit=limit
            )
            return Response.json(
                {
                    "Path": path,
                    "Entries": [
                        {
                            "FullPath": e.full_path,
                            "Mode": e.attr.mode,
                            "Mime": e.attr.mime,
                            "FileSize": e.size,
                            "Mtime": e.attr.mtime,
                            "IsDirectory": e.is_directory,
                            "Extended": e.extended,
                            "SymlinkTarget": e.attr.symlink_target,
                            "HardLinkCounter": e.hard_link_counter,
                        }
                        for e in entries
                    ],
                    "ShouldDisplayLoadMore": len(entries) >= limit,
                }
            )
        size = entry.size
        headers = {
            "Content-Type": entry.attr.mime
            or "application/octet-stream",
            "ETag": f'"{entry.attr.md5}"',
            "Last-Modified-Ts": str(int(entry.attr.mtime)),
        }
        for k, v in entry.extended.items():
            headers[k] = v
        if req.method == "HEAD":
            headers["Content-Length-Hint"] = str(size)
            return Response(status=200, headers=headers)
        # range requests (single range)
        rng = req.headers.get("Range", "")
        if rng.startswith("bytes="):
            spec = rng[len("bytes=") :].split(",")[0]
            lo_s, _, hi_s = spec.partition("-")
            lo = int(lo_s) if lo_s else max(0, size - int(hi_s))
            hi = min(int(hi_s), size - 1) if (hi_s and lo_s) else size - 1
            if lo > hi or lo >= size:
                return Response.error(
                    "requested range not satisfiable", 416
                )
            headers["Content-Range"] = f"bytes {lo}-{hi}/{size}"
            return Response(
                status=206,
                stream=self._stream_chunks(entry, lo, hi - lo + 1),
                content_length=hi - lo + 1,
                headers=headers,
            )
        return Response(
            status=200,
            stream=self._stream_chunks(entry, 0, size),
            content_length=size,
            headers=headers,
        )

    def _h_kv(self, req: Request) -> Response:
        """Filer KV API (filer_grpc_server_kv.go analog) — used by
        filer.sync to checkpoint per-direction offsets in the TARGET
        filer, so a restarted sync resumes instead of replaying.

        Lives on the reserved /__kv/ prefix (the reference exposes KV
        only over gRPC, never on the public object namespace) so user
        files named /kv/... stay reachable; when the cluster signs
        writes, KV requests must carry a token minted with the shared
        signing key."""
        tracing.set_op("kv")  # arbitrary key paths, bounded label
        if self.jwt_signing_key:
            from ..security.jwt import decode_jwt

            token = req.headers.get("Authorization", "").removeprefix(
                "BEARER "
            ).strip()
            try:
                decode_jwt(self.jwt_signing_key, token)
            except Exception:
                return Response.error("kv: unauthorized", 401)
        key = urllib.parse.unquote(req.path[len("/__kv/") :]).encode()
        if req.method == "GET":
            v = self.filer.store.kv_get(key)
            if v is None:
                return Response.error("key not found", 404)
            return Response(status=200, body=v)
        if req.method in ("PUT", "POST"):
            self.filer.store.kv_put(key, req.body)
            return Response.json({"ok": True})
        if req.method == "DELETE":
            self.filer.store.kv_delete(key)
            return Response.json({"ok": True})
        return Response.error("method not allowed", 405)

    def _h_meta_events(self, req: Request) -> Response:
        since = int(req.param("since", "0"))
        limit = int(req.param("limit", "8192"))
        if req.param("wait") == "true":
            # long-poll: block until the next mutation (or timeout) so
            # subscribers get push latency without a timer poll
            timeout = min(float(req.param("timeout", "10")), 30.0)
            events = self.filer.wait_for_events(since, timeout, limit)
        else:
            events = self.filer.events_since(since, limit)
        return Response.json(
            {
                # server clock: subscribers bootstrap their cursor here
                # (client clocks may be skewed vs the event timestamps)
                "now_ns": time.time_ns(),
                "events": [
                    {
                        "ts_ns": e.ts_ns,
                        "directory": e.directory,
                        "old_entry": e.old_entry,
                        "new_entry": e.new_entry,
                    }
                    for e in events
                ]
            }
        )
