"""Volume server: HTTP data plane + admin/EC lifecycle endpoints.

Behavioral model: weed/server/volume_server.go, volume_server_handlers_*,
volume_grpc_admin.go, volume_grpc_erasure_coding.go,
volume_grpc_client_to_master.go (heartbeat loop),
weed/topology/store_replicate.go (synchronous replication fan-out).

The 36 gRPC rpcs of the reference map onto JSON/HTTP admin endpoints; the
EC generate/rebuild handlers call straight into the encoder.

The port's copy of ``seaweedfs_tpu/server/volume.py``: the same routes,
statuses and bodies, with its EC work on the port's codec. The server
resolves its device once, at construction (``device=None`` is the card
and raises without one; ``"cpu"`` the kernels' plain versions), and
every codec it builds — one a ``write_ec_files``, ``rebuild_ec_files``
and lane-packed ``write_ec_files_batch`` call, and one an ``EcVolume``
its store mounts — takes that device with the server's
``device_min_bytes`` and ``link_aware``.

Its heartbeats carry the telemetry snapshot (``telemetry/snapshot.py``),
with the EC-encode ledger each generate folds its ``timing`` into, and
``/admin/volume_copy`` pulls a volume from a peer over
``/admin/ec/download``; ``/admin/fsck`` checks every live needle,
``/admin/tail`` serves the records ``storage/volume_backup.py`` replays,
``/ui`` the status page of ``server/ui.py``, ``/admin/query`` the JSON
filter of ``query/`` and ``/admin/tier/{upload,download}`` move a .dat to
a plain-HTTP or an S3 tier and back. A chunk-manifest
needle resolves through the port's ``operation/`` client, as the reference's does. The server routes
through the request-tracing middleware, which serves ``/debug/*``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import fault, resolve_device, tracing
from ..ops.codec import DEVICE_MIN_BYTES, RSCodec
from ..storage import needle as needle_mod
from ..storage import types as t
from ..storage.erasure_coding import (
    constants as C,
    decoder,
    encoder,
    rebuild as rebuild_mod,
)
from ..storage.file_id import FileId, parse_needle_id_cookie
from ..storage.store import Store
from ..storage.volume import (
    DeletedError,
    NotFoundError,
    VolumeReadOnlyError,
)
from ..telemetry.snapshot import (
    TelemetryCollector,
    mark_started,
    metrics_response,
)
from ..tracing import middleware as trace_mw
from ..util import glog, http
from ..util import retry as retry_mod
from ..util.http import Request, Response, Router


class VolumeServer:
    def __init__(
        self,
        master_url: str,
        dirs: list[str],
        max_volume_counts: list[int] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        public_url: str = "",
        data_center: str = "",
        rack: str = "",
        pulse_seconds: float = 1.0,
        read_redirect: bool = True,
        jwt_signing_key: str = "",
        master_peers: list[str] | None = None,
        needle_map_kind: str = "memory",
        ssl_context=None,
        replicate_quorum: int | None = None,
        replicate_pool: ThreadPoolExecutor | None = None,
        telemetry_interval: float = 0.0,
        device: str | torch.device | None = None,
        device_min_bytes: int = DEVICE_MIN_BYTES,
        link_aware: bool = True,
    ):
        from ..security import Guard
        from ..stats import metrics as stats

        self.device = resolve_device(device)
        self.device_min_bytes = device_min_bytes
        self.link_aware = link_aware
        self.master_url = master_url
        self.master_peers = master_peers or [master_url]
        self.pulse_seconds = pulse_seconds
        self.read_redirect = read_redirect
        self.guard = Guard(signing_key=jwt_signing_key)
        self.stats = stats
        # Degraded-write quorum: a replicated write succeeds once this
        # many COPIES (local included) land; None = every copy (the
        # strict store_replicate.go semantics). Failed peers are
        # tracked under-replicated and re-pushed by the master's
        # repair loop once the peer returns.
        if replicate_quorum is None:
            env_q = os.environ.get("SEAWEEDFS_REPLICATE_QUORUM", "")
            replicate_quorum = int(env_q) if env_q else None
        self.replicate_quorum = replicate_quorum
        self._ur_lock = threading.Lock()
        # fid -> original method (POST/DELETE)  # guarded-by: self._ur_lock
        self._under_replicated: dict[str, str] = {}
        # one long-lived fan-out pool: per-request executor construction
        # churned two threads per write on the hot path. A caller may
        # inject a shared pool (the scale harness runs 100 servers in
        # one process — 100 × 16 idle replicate threads is pure waste);
        # only an owned pool is shut down in stop().
        self._own_replicate_pool = replicate_pool is None
        self._replicate_pool = replicate_pool or ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="vs-replicate"
        )
        router = Router()
        fault.install_routes(router)
        router.add("POST", r"/admin/repair", self._h_repair)
        router.add("GET", r"/metrics", self._h_metrics)
        # admin plane first (more specific paths)
        router.add("POST", r"/admin/assign_volume", self._h_assign_volume)
        router.add("POST", r"/admin/delete_volume", self._h_delete_volume)
        router.add("POST", r"/admin/readonly", self._h_readonly)
        router.add("POST", r"/admin/vacuum/check", self._h_vacuum_check)
        router.add("POST", r"/admin/vacuum/compact", self._h_vacuum_compact)
        router.add("POST", r"/admin/vacuum/commit", self._h_vacuum_commit)
        router.add("POST", r"/admin/batch_delete", self._h_batch_delete)
        router.add("POST", r"/admin/ec/generate", self._h_ec_generate)
        router.add(
            "POST", r"/admin/ec/generate_batch", self._h_ec_generate_batch
        )
        router.add("POST", r"/admin/ec/rebuild", self._h_ec_rebuild)
        router.add("POST", r"/admin/ec/copy", self._h_ec_copy)
        router.add("GET", r"/admin/ec/download", self._h_ec_download)
        router.add("POST", r"/admin/ec/mount", self._h_ec_mount)
        router.add("POST", r"/admin/ec/unmount", self._h_ec_unmount)
        router.add("GET", r"/admin/ec/read", self._h_ec_read)
        router.add(
            "POST", r"/admin/ec/delete_shards", self._h_ec_delete_shards
        )
        router.add("POST", r"/admin/ec/to_volume", self._h_ec_to_volume)
        router.add("POST", r"/admin/ec/blob_delete", self._h_ec_blob_delete)
        router.add("POST", r"/admin/volume_copy", self._h_volume_copy)
        router.add("POST", r"/admin/volume_mount", self._h_volume_mount)
        router.add(
            "POST", r"/admin/volume_unmount", self._h_volume_unmount
        )
        router.add(
            "POST", r"/admin/volume_configure_replication",
            self._h_volume_configure_replication,
        )
        router.add("POST", r"/admin/leave", self._h_leave)
        router.add("POST", r"/admin/fsck", self._h_fsck)
        router.add("POST", r"/admin/query", self._h_query)
        router.add("POST", r"/admin/tier/upload", self._h_tier_upload)
        router.add(
            "POST", r"/admin/tier/download", self._h_tier_download
        )
        router.add("GET", r"/admin/tail", self._h_tail)
        router.add("GET", r"/status", self._h_status)
        router.add("GET", r"/ui", self._h_ui)
        router.add("GET", r"/healthz", lambda r: Response.json({"ok": 1}))
        # data plane
        router.add("GET", r"/.*", self._h_read)
        router.add("HEAD", r"/.*", self._h_read)
        router.add("POST", r"/.*", self._h_write)
        router.add("PUT", r"/.*", self._h_write)
        router.add("DELETE", r"/.*", self._h_delete)
        self.server = http.HttpServer(
            trace_mw.instrument(router, "volume"),
            host, port, ssl_context=ssl_context,
        )
        self.store = Store(
            dirs,
            max_volume_counts,
            ip=host,
            port=self.server.port,
            public_url=public_url,
            data_center=data_center,
            rack=rack,
            needle_map_kind=needle_map_kind,
            device=self.device,
            device_min_bytes=device_min_bytes,
            link_aware=link_aware,
        )
        # minimum seconds between telemetry collections (0 = every
        # pulse): at 100 servers × 2 Hz pulses, per-pulse histogram
        # scans contend on the shared stats registry — the aggregator
        # keeps the last snapshot, so riding only some pulses is safe
        # as long as the interval stays well under its staleness horizon
        self.telemetry_interval = telemetry_interval
        self._last_telemetry = 0.0  # monotonic; 0 = never collected
        self._running = False
        self._hb_stream = None  # bidi stream conn (SendHeartbeat analog)
        # one heartbeat at a time: the pulse loop and the admin handlers
        # (mount, assign, delete, decode) all send one, and two senders
        # on the one stream connection can each read the other's answer
        # line, leaving one waiting out the socket timeout while the
        # master holds a stale view
        self._hb_lock = threading.Lock()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True
        )
        self._ec_loc_cache: dict[int, tuple[float, dict]] = {}
        # telemetry snapshot piggybacked on every heartbeat; the url
        # is filled in at start() once the listener port is bound
        self._telemetry = TelemetryCollector("volume")

    # -- lifecycle -------------------------------------------------------

    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> None:
        self._running = True
        self.server.start()
        mark_started("volume")
        self._telemetry.url = self.url
        self.heartbeat_once()  # register before serving traffic
        self._hb_thread.start()

    def stop(self) -> None:
        self._running = False
        self._close_hb_stream()
        if self._own_replicate_pool:
            self._replicate_pool.shutdown(wait=False)
        self.server.stop()
        self.store.close()

    def heartbeat_once(self) -> None:
        with self._hb_lock:
            self._heartbeat_once()  # weedcheck: ignore[lock-held-across-blocking]: the lock EXISTS to serialize heartbeat sends on the one stream connection; a contender must wait its turn

    def _heartbeat_once(self) -> None:
        hb = self.store.collect_heartbeat()
        # report degraded writes so the master's repair loop can drive
        # re-replication once the missing peer returns
        with self._ur_lock:
            hb.under_replicated = sorted(self._under_replicated)
        # telemetry piggyback: the periodic snapshot rides the pulse
        # (telemetry/snapshot.py) — the master aggregates it into the
        # /cluster/telemetry view. With telemetry_interval set, only
        # some pulses carry a snapshot (hb.telemetry stays None and
        # the aggregator keeps the last one) — collection scans the
        # process-global histograms, which contends at 100 servers
        now = time.monotonic()
        if (
            self.telemetry_interval <= 0
            or now - self._last_telemetry >= self.telemetry_interval
        ):
            self._last_telemetry = now  # weedcheck: ignore[unguarded-shared-write]: snapshot throttle stamp: a torn read worst-case costs one extra (or one skipped) telemetry snapshot on a racing pulse
            hb.telemetry = self._telemetry.collect()
        # preferred transport: the long-lived bidi stream
        # (volume_grpc_client_to_master.go:50-97) — one connection per
        # master, a pulse per send; any failure falls back to the
        # plain POST below (which also handles peer rotation) and the
        # next pulse re-dials the stream
        try:
            if self._hb_stream is None:
                from .heartbeat_stream import HeartbeatStreamConn

                # timeout matched to the POST path so a hung leader
                # fails over as fast as the pulse transport did
                self._hb_stream = HeartbeatStreamConn(  # weedcheck: ignore[unguarded-shared-write]: heartbeat re-home: atomic reference swap, close() is idempotent; racing pulses tolerate a torn re-dial
                    self.master_url, timeout=10
                )
            out = self._hb_stream.send(hb.to_dict())
            self._process_heartbeat_response(out)
            return
        except (OSError, ValueError, ConnectionError):
            self._close_hb_stream()
        try:
            out = http.post_json(
                f"{self.master_url}/heartbeat", hb.to_dict(),
                timeout=10, retry=retry_mod.LOOKUP,
            )
        except http.HttpError:
            # leader unreachable: fail over to any configured peer
            # (single-attempt per peer — the pulse loop IS the retry)
            for peer in self.master_peers:
                if peer == self.master_url:
                    continue
                try:
                    out = http.post_json(
                        f"{peer}/heartbeat", hb.to_dict(), timeout=10
                    )
                    self.master_url = peer  # weedcheck: ignore[unguarded-shared-write]: heartbeat re-home: atomic reference swap, close() is idempotent; racing pulses tolerate a torn re-dial
                    break
                except http.HttpError:
                    continue
            else:
                return
        self._process_heartbeat_response(out)

    def _close_hb_stream(self) -> None:
        if self._hb_stream is not None:
            try:
                self._hb_stream.close()
            except Exception:
                pass
            self._hb_stream = None  # weedcheck: ignore[unguarded-shared-write]: heartbeat re-home: atomic reference swap, close() is idempotent; racing pulses tolerate a torn re-dial

    def _process_heartbeat_response(self, out: dict) -> None:
        # re-home to the announced leader (masterclient.go:57-80)
        leader = out.get("leader")
        if leader and leader != self.master_url:
            self.master_url = leader  # weedcheck: ignore[unguarded-shared-write]: heartbeat re-home: atomic reference swap, close() is idempotent; racing pulses tolerate a torn re-dial
            self._close_hb_stream()  # re-dial the new leader
        elif out.get("is_leader") is False and not leader:
            # current master is not leader and knows no leader (election
            # in progress / partitioned): advance around the peer ring so
            # every master is eventually tried, not just the first two
            self._close_hb_stream()
            ring = self.master_peers
            if ring:
                try:
                    i = ring.index(self.master_url)
                except ValueError:
                    i = -1
                nxt = ring[(i + 1) % len(ring)]
                if nxt != self.master_url:
                    self.master_url = nxt  # weedcheck: ignore[unguarded-shared-write]: heartbeat re-home: atomic reference swap, close() is idempotent; racing pulses tolerate a torn re-dial

    def _heartbeat_loop(self) -> None:
        while self._running:
            time.sleep(self.pulse_seconds)
            if self._running:
                self.heartbeat_once()

    # -- fid helpers -----------------------------------------------------

    def _parse_fid_path(self, path: str) -> FileId:
        # /3,01637037d6 or /3/01637037d6[/name] (+ optional .ext)
        parts = path.strip("/").split("/")
        if len(parts) >= 2 and "," not in parts[0]:
            fid = f"{parts[0]},{parts[1]}"
        else:
            fid = parts[0]
        base = fid.split(".")[0]
        return FileId.parse(base)

    # -- data plane ------------------------------------------------------

    def _h_metrics(self, req: Request) -> Response:
        return metrics_response()

    def _jwt_of(self, req: Request) -> str:
        auth = req.headers.get("Authorization", "")
        if auth.startswith("BEARER "):
            return auth[len("BEARER ") :]
        return req.param("jwt")

    def _h_read(self, req: Request) -> Response:
        tracing.set_op("read")  # fid paths are unbounded label values
        self.stats.VOLUME_SERVER_REQUESTS.inc("get")
        with self.stats.VOLUME_SERVER_LATENCY.time("get"):
            return self._read_inner(req)

    def _read_inner(self, req: Request) -> Response:
        try:
            fid = self._parse_fid_path(req.path)
        except ValueError as e:
            return Response.error(str(e), 400)
        vol = self.store.find_volume(fid.volume_id)
        if vol is not None:
            try:
                n = vol.read_needle(fid.key, fid.cookie)
            except NotFoundError:
                return Response.error("not found", 404)
            except DeletedError:
                return Response.error("deleted", 404)
            except needle_mod.ChecksumError as e:
                return Response.error(str(e), 500)
            return self._needle_response(n, req)
        ev = self.store.find_ec_volume(fid.volume_id)
        if ev is not None:
            try:
                n = ev.read_needle(
                    fid.key, self._remote_shard_reader(fid.volume_id)
                )
            except KeyError:
                return Response.error("not found", 404)
            if n.cookie != fid.cookie:
                return Response.error("cookie mismatch", 404)
            return self._needle_response(n, req)
        # not local: redirect via master lookup
        if self.read_redirect:
            try:
                info = http.get_json(
                    f"{self.master_url}/dir/lookup"
                    f"?volumeId={fid.volume_id}"
                )
                locations = [
                    loc["url"]
                    for loc in info.get("locations", [])
                    if loc["url"] != self.url
                ]
            except http.HttpError:
                locations = []
            if locations:
                return Response(
                    status=302,
                    headers={
                        "Location": f"http://{locations[0]}{req.path}"
                    },
                )
        return Response.error(
            f"volume {fid.volume_id} not found", 404
        )

    def _needle_response(
        self, n: needle_mod.Needle, req: Request | None = None
    ) -> Response:
        if n.has(needle_mod.FLAG_IS_CHUNK_MANIFEST) and not (
            req is not None and req.param("cm") == "false"
        ):
            return self._chunk_manifest_response(n)
        headers = {"ETag": f'"{n.etag}"'}
        if n.mime:
            headers["Content-Type"] = n.mime.decode("ascii", "replace")
        if n.name:
            headers["Content-Disposition"] = (
                f'inline; filename="{n.name.decode("utf8", "replace")}"'
            )
        if n.last_modified:
            headers["Last-Modified-Ts"] = str(n.last_modified)
        body = n.data
        if n.has(needle_mod.FLAG_IS_COMPRESSED):
            accepts = (
                req is not None
                and "gzip" in req.headers.get("Accept-Encoding", "")
            )
            if accepts:
                headers["Content-Encoding"] = "gzip"
            else:
                from ..util import compression

                body = compression.decompress(body)
        if req is not None and (
            req.param("width") or req.param("height")
        ):
            from ..images import resize_image

            body = resize_image(
                body,
                int(req.param("width", "0")),
                int(req.param("height", "0")),
                req.param("mode"),
            )
        return Response(status=200, body=body, headers=headers)

    def _chunk_manifest_response(self, n: needle_mod.Needle) -> Response:
        """Resolve a chunk-manifest needle into one streamed body:
        fetch each chunk from its volume server in offset order
        (volume_server_handlers_read.go chunked-manifest resolution +
        operation/chunked_file.go)."""
        manifest = json.loads(n.data)
        chunks = sorted(
            manifest.get("chunks", []), key=lambda c: c["offset"]
        )

        def gen():
            from .. import operation

            for c in chunks:
                yield operation.read_file(self.master_url, c["fid"])

        headers = {
            "Content-Type": manifest.get("mime")
            or "application/octet-stream",
            "X-Chunk-Manifest": "true",
        }
        if manifest.get("name"):
            headers["Content-Disposition"] = (
                f'inline; filename="{manifest["name"]}"'
            )
        return Response(
            status=200,
            stream=gen(),
            content_length=int(manifest.get("size", 0)),
            headers=headers,
        )

    def _h_write(self, req: Request) -> Response:
        tracing.set_op("write")
        self.stats.VOLUME_SERVER_REQUESTS.inc("post")
        with self.stats.VOLUME_SERVER_LATENCY.time("post"):
            return self._write_inner(req)

    def _write_inner(self, req: Request) -> Response:
        try:
            fid = self._parse_fid_path(req.path)
        except ValueError as e:
            return Response.error(str(e), 400)
        if denied := self._check_write_jwt(req, str(fid)):
            return denied
        vol = self.store.find_volume(fid.volume_id)
        if vol is None:
            return Response.error(
                f"volume {fid.volume_id} not local", 404
            )
        body = req.body
        part_name = ""
        part_mime = ""
        ctype = req.headers.get("Content-Type", "")
        if ctype.startswith("multipart/form-data"):
            # curl -F / browser uploads: store only the file part's bytes
            # (needle_parse_upload.go parseMultipart)
            try:
                parts = http.parse_multipart(body, ctype)
            except ValueError as e:
                return Response.error(str(e), 400)
            if parts:
                p = next(
                    (p for p in parts if p.filename is not None), parts[0]
                )
                body = p.data
                if p.filename:
                    part_name = p.filename.rsplit("/", 1)[-1]
                if p.mime and p.mime != "application/octet-stream":
                    part_mime = p.mime
        if (
            ctype.startswith("image/jpeg")
            or part_mime.startswith("image/jpeg")
            or req.param("mime", "").startswith("image/jpeg")
        ):
            from ..images import fix_orientation

            body = fix_orientation(body)
        n = needle_mod.Needle(
            cookie=fid.cookie, id=fid.key, data=body
        )
        if req.param("gzipped") == "true":
            n.flags |= needle_mod.FLAG_IS_COMPRESSED
        if req.param("cm") == "true":
            # chunk-manifest needle (operation/submit.go auto-split):
            # the read path resolves it back into one stream
            n.flags |= needle_mod.FLAG_IS_CHUNK_MANIFEST
        if name := (req.param("name") or part_name):
            n.set_name(name.encode())
        if mime := (req.param("mime") or part_mime):
            n.set_mime(mime.encode())
        if ts := req.param("ts"):
            n.set_last_modified(int(ts))
        else:
            n.set_last_modified(int(time.time()))
        if ttl := req.param("ttl"):
            n.set_ttl(t.TTL.parse(ttl))
        try:
            _, size = vol.write_needle(
                n, fsync=req.param("fsync") == "true"
            )
        except VolumeReadOnlyError as e:
            return Response.error(str(e), 409)
        if req.param("type") != "replicate":
            err = self._replicate(req, fid, "POST")
            if err:
                return Response.error(
                    f"replication failed: {err}", 500
                )
        return Response.json({"size": len(body), "eTag": n.etag})

    def _check_write_jwt(self, req: Request, fid_str: str) -> Response | None:
        """JWT gate shared by write AND delete mutations — the reference
        guards both (volume_server_handlers_write.go:91
        maybeCheckJwtAuthorization on the delete handler too)."""
        if not self.guard.is_active:
            return None
        from ..security.jwt import JwtError

        try:
            self.guard.check_jwt(self._jwt_of(req), fid_str)
        except JwtError as e:
            return Response.error(str(e), 401)
        return None

    def _h_delete(self, req: Request) -> Response:
        tracing.set_op("delete")
        try:
            fid = self._parse_fid_path(req.path)
        except ValueError as e:
            return Response.error(str(e), 400)
        if denied := self._check_write_jwt(req, str(fid)):
            return denied
        vol = self.store.find_volume(fid.volume_id)
        if vol is None:
            ev = self.store.find_ec_volume(fid.volume_id)
            if ev is not None:
                ev.delete_needle(fid.key)
                return Response.json({"size": 0})
            return Response.error(
                f"volume {fid.volume_id} not local", 404
            )
        # a chunk-manifest delete fans out to its chunks first
        # (volume_server_handlers_write.go DeleteHandler resolves
        # manifests so auto-split uploads don't orphan chunk needles);
        # only the PRIMARY delete fans out — replicas deleting their
        # manifest copy must not re-issue cluster-wide chunk deletes
        if req.param("cm") != "false" and req.param("type") != "replicate":
            try:
                n = vol.read_needle(fid.key, cookie=fid.cookie)
                if n.has(needle_mod.FLAG_IS_CHUNK_MANIFEST):
                    from .. import operation

                    for c in json.loads(n.data).get("chunks", []):
                        try:
                            operation.delete_file(
                                self.master_url, c["fid"],
                                jwt_signing_key=self.guard.signing_key,
                            )
                        except Exception:
                            pass
            except Exception:
                pass  # manifest resolution must not block the delete
        size = vol.delete_needle(fid.key)
        if req.param("type") != "replicate":
            err = self._replicate(req, fid, "DELETE")
            if err:
                return Response.error(
                    f"replicated delete failed: {err}", 500
                )
        return Response.json({"size": size})

    def _quorum(self, copy_count: int) -> int:
        """Copies (local included) required before a replicated write
        acks; clamped so a misconfigured quorum can neither exceed the
        placement nor drop below the local copy."""
        q = self.replicate_quorum or copy_count
        return max(1, min(q, copy_count))

    def _mark_under_replicated(self, fid: FileId, method: str) -> None:
        with self._ur_lock:
            self._under_replicated[str(fid)] = method

    def _settle_fanout(
        self,
        fid: FileId,
        method: str,
        acks: int,
        copy_count: int,
        quorum: int,
        errors: list[str],
    ) -> str | None:
        """Decide a fan-out's fate from the copies that actually
        landed, on EVERY path (peers failed, peers missing, lookup
        failed). Below copy_count the fid is always queued for the
        master's repair loop — even when the request fails, the local
        copy exists and repair must converge it; below quorum the
        request fails."""
        if acks >= copy_count:
            return None
        self._mark_under_replicated(fid, method)
        detail = "; ".join(errors) or "replica peers not registered"
        if acks < quorum:
            return (
                f"{acks}/{quorum} copies (quorum not met): {detail}"
            )
        # degraded success: ack the client, queue the repair
        glog.warningf(
            "degraded %s of %s: %d/%d copies (%s)",
            method, fid, acks, copy_count, detail,
        )
        return None

    def _replicate(
        self, req: Request, fid: FileId, method: str
    ) -> str | None:
        """Synchronous fan-out to the other replicas
        (store_replicate.go:21-93,147-162). Returns None when enough
        copies landed (quorum semantics — see _quorum); a shortfall
        that still meets quorum is recorded under-replicated for the
        master's repair loop instead of failing the request."""
        vol = self.store.find_volume(fid.volume_id)
        if vol is None or vol.super_block.replica_placement.copy_count <= 1:
            return None
        copy_count = vol.super_block.replica_placement.copy_count
        quorum = self._quorum(copy_count)
        try:
            info = http.get_json(
                f"{self.master_url}/dir/lookup?volumeId={fid.volume_id}",
                retry=retry_mod.LOOKUP,
            )
        except http.HttpError as e:
            # no peer is reachable through the master: only the local
            # copy landed
            return self._settle_fanout(
                fid, method, 1, copy_count, quorum, [f"lookup: {e}"]
            )
        peers = [
            loc["url"]
            for loc in info.get("locations", [])
            if loc["url"] != self.url
        ]
        if not peers:
            # replicas expected but none registered (peer down before
            # the write): single-copy from the start
            return self._settle_fanout(
                fid, method, 1, copy_count, quorum, []
            )
        qs = "type=replicate"
        for key in ("name", "mime", "ttl", "ts", "gzipped"):
            if v := req.param(key):
                qs += f"&{key}={v}"
        if token := self._jwt_of(req):  # forward write auth to peers
            qs += f"&jwt={token}"
        errors: list[str] = []
        # pool workers have no thread-local span or deadline; carry the
        # request's explicitly so replica writes stay in this trace and
        # inside the caller's X-Seaweed-Deadline budget
        span = tracing.current()
        budget = retry_mod.deadline()

        def send(peer):
            prev = retry_mod.set_deadline(budget)
            try:
                with tracing.attach(span):
                    fault.point(
                        "volume.replicate.send", peer=peer,
                        fid=str(fid), method=method,
                    )
                    http.request(
                        method,
                        f"{peer}{req.path}?{qs}",
                        req.body if method != "DELETE" else None,
                        retry=retry_mod.REPLICATE,
                    )
            except (http.HttpError, fault.FaultInjected) as e:
                errors.append(f"{peer}: {e}")
            finally:
                retry_mod.set_deadline(prev)

        # long-lived pool; futures (not map) so one slow peer doesn't
        # hide the others' results on teardown
        list(self._replicate_pool.map(send, peers))
        acks = 1 + len(peers) - len(errors)
        return self._settle_fanout(
            fid, method, acks, copy_count, quorum, errors
        )

    def _h_repair(self, req: Request) -> Response:
        """Re-replicate one under-replicated fid to its peers — driven
        by the master's repair loop once the missing replica returns.
        Idempotent: a replica that already holds the needle just
        overwrites it with identical bytes."""
        tracing.set_op("repair")
        fid_str = req.json().get("fid", "")
        with self._ur_lock:
            method = self._under_replicated.get(fid_str)
        if method is None:
            return Response.json({"ok": True, "repaired": False})
        try:
            fid = FileId.parse(fid_str)
        except ValueError as e:
            with self._ur_lock:
                self._under_replicated.pop(fid_str, None)
            return Response.error(str(e), 400)
        vol = self.store.find_volume(fid.volume_id)
        if vol is None:
            with self._ur_lock:
                self._under_replicated.pop(fid_str, None)
            return Response.json(
                {"ok": True, "repaired": False, "reason": "volume gone"}
            )
        try:
            info = http.get_json(
                f"{self.master_url}/dir/lookup?volumeId={fid.volume_id}",
                retry=retry_mod.LOOKUP,
            )
        except http.HttpError as e:
            return Response.error(f"lookup: {e}", 503)
        peers = [
            loc["url"]
            for loc in info.get("locations", [])
            if loc["url"] != self.url
        ]
        if not peers:
            return Response.error("no replica peers yet", 503)
        headers = {}
        if self.guard.is_active:
            from ..security.jwt import gen_jwt

            headers["Authorization"] = (
                f"BEARER {gen_jwt(self.guard.signing_key, fid_str)}"
            )
        if method == "DELETE":
            body, qs = None, "type=replicate&cm=false"
        else:
            try:
                n = vol.read_needle(fid.key, fid.cookie)
            except (NotFoundError, DeletedError):
                # deleted since the degraded write: nothing to repair
                with self._ur_lock:
                    self._under_replicated.pop(fid_str, None)
                return Response.json(
                    {"ok": True, "repaired": False, "reason": "deleted"}
                )
            body = n.data
            qs = "type=replicate"
            if n.name:
                qs += "&name=" + urllib.parse.quote(
                    n.name.decode("utf8", "replace")
                )
            if n.mime:
                qs += "&mime=" + urllib.parse.quote(
                    n.mime.decode("ascii", "replace")
                )
            if n.last_modified:
                qs += f"&ts={n.last_modified}"
            if n.has(needle_mod.FLAG_IS_COMPRESSED):
                qs += "&gzipped=true"
        failures = []
        for peer in peers:
            try:
                # a repair push IS a replicate send: the same fault
                # point applies, so a still-partitioned peer keeps the
                # fid queued until the partition actually heals
                fault.point(
                    "volume.replicate.send", peer=peer,
                    fid=fid_str, method=method,
                )
                http.request(
                    method, f"{peer}/{fid_str}?{qs}", body, headers,
                    retry=retry_mod.REPLICATE,
                )
            except fault.FaultInjected as e:
                failures.append(f"{peer}: {e}")
            except http.HttpError as e:
                if method == "DELETE" and e.status == 404:
                    continue  # already absent on the peer: repaired
                failures.append(f"{peer}: {e}")
        if failures:
            return Response.error("; ".join(failures), 503)
        copy_count = vol.super_block.replica_placement.copy_count
        if 1 + len(peers) < copy_count:
            # every registered peer took the push, but the placement
            # still has replicas missing: the fid stays queued (and
            # keeps riding the heartbeat) until all of them register
            # and take a copy
            return Response.json({
                "ok": True, "repaired": False, "pending": True,
                "copies": 1 + len(peers), "want": copy_count,
            })
        with self._ur_lock:
            self._under_replicated.pop(fid_str, None)
        return Response.json({"ok": True, "repaired": True})

    # -- EC remote shard reads ------------------------------------------

    def _remote_shard_reader(self, vid: int):
        def read(shard_id: int, offset: int, n: int) -> bytes | None:
            locs = self._cached_ec_locations(vid)
            for loc in locs.get(str(shard_id), []):
                url = loc["url"]
                if url == self.url:
                    continue
                try:
                    fault.point(
                        "ec.shard.read", peer=url,
                        volume=vid, shard=shard_id,
                    )
                    return http.request(
                        "GET",
                        f"{url}/admin/ec/read?volume={vid}"
                        f"&shard={shard_id}&offset={offset}&size={n}",
                    )
                except (http.HttpError, fault.FaultInjected, OSError):
                    # connection drops and injected faults fall
                    # through to the remaining locations exactly like
                    # HTTP errors — the decoder reconstructs around a
                    # shard with no reachable location at all
                    continue
            return None

        return read

    def _cached_ec_locations(self, vid: int) -> dict:
        now = time.monotonic()
        hit = self._ec_loc_cache.get(vid)
        if hit and now - hit[0] < 10:
            return hit[1]
        try:
            info = http.get_json(
                f"{self.master_url}/ec/lookup?volumeId={vid}",
                retry=retry_mod.LOOKUP,
            )
            shards = info.get("shards", {})
        except http.HttpError:
            # a transient master blip must NOT poison degraded reads
            # for the whole TTL: serve the stale entry (re-asking in
            # ~1s instead of 10) and cache nothing when there is no
            # stale entry to serve
            if hit is not None:
                self._ec_loc_cache[vid] = (now - 9.0, hit[1])
                return hit[1]
            return {}
        self._ec_loc_cache[vid] = (now, shards)
        return shards

    # -- admin handlers --------------------------------------------------

    def _h_status(self, req: Request) -> Response:
        hb = self.store.collect_heartbeat()
        # collect_heartbeat drains deltas; re-add them for the real loop
        self.store.new_volumes = hb.new_volumes + self.store.new_volumes
        self.store.deleted_volumes = (
            hb.deleted_volumes + self.store.deleted_volumes
        )
        self.store.new_ec_shards = (
            hb.new_ec_shards + self.store.new_ec_shards
        )
        self.store.deleted_ec_shards = (
            hb.deleted_ec_shards + self.store.deleted_ec_shards
        )
        return Response.json(
            {
                "Version": "seaweedfs-tpu",
                "Volumes": [v.to_dict() for v in hb.volumes],
                "EcShards": [e.to_dict() for e in hb.ec_shards],
            }
        )

    def _h_ui(self, req: Request) -> Response:
        from . import ui

        status = json.loads(self._h_status(req).body)
        return Response(
            status=200,
            body=ui.volume_ui(status, self.url).encode(),
            headers={"Content-Type": "text/html"},
        )

    def _h_assign_volume(self, req: Request) -> Response:
        body = req.json()
        self.store.add_volume(
            int(body["volume"]),
            body.get("collection", ""),
            body.get("replication") or "000",
            body.get("ttl", ""),
        )
        self.heartbeat_once()
        return Response.json({"ok": True})

    def _h_delete_volume(self, req: Request) -> Response:
        self.store.delete_volume(int(req.json()["volume"]))
        self.heartbeat_once()
        return Response.json({"ok": True})

    def _h_readonly(self, req: Request) -> Response:
        body = req.json()
        vid = int(body["volume"])
        if body.get("readonly", True):
            self.store.mark_volume_readonly(vid)
        else:
            self.store.mark_volume_writable(vid)
        return Response.json({"ok": True})

    def _h_vacuum_check(self, req: Request) -> Response:
        vol = self._require_volume(int(req.json()["volume"]))
        return Response.json({"garbage_ratio": vol.garbage_level()})

    def _h_vacuum_compact(self, req: Request) -> Response:
        body = req.json()
        vol = self._require_volume(int(body["volume"]))
        vol.compact(
            bytes_per_second=int(
                body.get("compaction_byte_per_second", 0)
            )
        )
        return Response.json({"ok": True})

    def _h_vacuum_commit(self, req: Request) -> Response:
        vol = self._require_volume(int(req.json()["volume"]))
        vol.commit_compact()
        return Response.json({"ok": True})

    def _h_batch_delete(self, req: Request) -> Response:
        results = []
        for fid_str in req.json().get("fids", []):
            try:
                fid = FileId.parse(fid_str)
                if self._check_write_jwt(req, str(fid)):
                    results.append(
                        {"fid": fid_str, "status": 401,
                         "error": "unauthorized"}
                    )
                    continue
                vol = self.store.find_volume(fid.volume_id)
                if vol is None:
                    results.append(
                        {"fid": fid_str, "status": 404,
                         "error": "volume not local"}
                    )
                    continue
                size = vol.delete_needle(fid.key)
                results.append({"fid": fid_str, "status": 200,
                                "size": size})
            except Exception as e:
                results.append(
                    {"fid": fid_str, "status": 500, "error": str(e)}
                )
        return Response.json({"results": results})

    def _require_volume(self, vid: int):
        vol = self.store.find_volume(vid)
        if vol is None:
            raise KeyError(f"volume {vid} not found")
        return vol

    # -- EC lifecycle (volume_grpc_erasure_coding.go) --------------------

    def _base_for(self, vid: int, collection: str) -> str | None:
        for loc in self.store.locations:
            base = loc.base_file_name(collection, vid)
            if os.path.exists(base + ".dat") or os.path.exists(
                base + ".ecx"
            ):
                return base
        return None

    def _h_ec_generate(self, req: Request) -> Response:
        """VolumeEcShardsGenerate: .dat → 14 shards + .ecx + .vif.

        Every encode runs under a PhaseTimer, so the response carries
        the read/stage/h2d/codec/write waterfall (telemetry/phases.py)
        and the decomposition lands as tracing child spans +
        ``seaweedfs_phase_seconds`` observations on this server."""
        from ..telemetry.phases import PhaseTimer

        tracing.set_op("ec.generate")
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        base = self._base_for(vid, collection)
        if base is None:
            return Response.error(f"volume {vid} not local", 404)
        pt = PhaseTimer("ec.encode")
        # batch_bytes: optional per-request slab-size override; absent
        # → adaptive sizing from the link EWMAs (encoder.choose_pipeline)
        encoder.write_ec_files(
            base, rs=self._codec(), phases=pt,
            batch_bytes=self._batch_bytes(body),
        )
        with pt.phase("index"):
            encoder.write_sorted_file_from_idx(base)
            # Persist the source volume's actual needle version in the
            # .vif so nodes holding only shards 1-13 still parse
            # needles correctly.
            self._write_vif(base)
        timing = pt.finish()
        # fleet EC observatory: fold the encode into this server's
        # telemetry ledger so the next heartbeat carries it
        self._telemetry.ec.record(timing, volumes=1)
        return Response.json({"ok": True, "timing": timing})

    def _codec(self) -> RSCodec:
        """A fresh RS(10,4) codec on this server's device and routing
        options: one a call, as the reference builds one."""
        return RSCodec(
            C.DATA_SHARDS, C.PARITY_SHARDS, self.device,
            device_min_bytes=self.device_min_bytes,
            link_aware=self.link_aware,
        )

    @staticmethod
    def _batch_bytes(body: dict) -> int | None:
        """Optional encode slab-size override riding the generate RPC
        (shell/maintenance tuning seam); None = adaptive."""
        raw = body.get("batch_bytes")
        return int(raw) if raw else None

    def _write_vif(self, base: str) -> None:
        from ..storage import backend as backend_mod
        from ..storage.erasure_coding import decoder as decoder_mod

        # merge, never clobber: the .vif also carries the offset-width
        # stamp the volume/EC load guards depend on
        vif = backend_mod.load_volume_info(base)
        vif["version"] = decoder_mod.read_ec_volume_version(base)
        backend_mod.save_volume_info(base, vif)

    def _h_ec_generate_batch(self, req: Request) -> Response:
        """Volume-parallel VolumeEcShardsGenerate: encodes several local
        volumes in lockstep through the device mesh
        (storage/erasure_coding/encoder.write_ec_files_batch; BASELINE
        config 4). Single-device stores fall back to the serial loop."""
        from ..telemetry.phases import PhaseTimer

        tracing.set_op("ec.generate_batch")
        body = req.json()
        vids = [int(v) for v in body["volumes"]]
        collection = body.get("collection", "")
        bases = {}
        for vid in vids:
            base = self._base_for(vid, collection)
            if base is None:
                return Response.error(f"volume {vid} not local", 404)
            bases[vid] = base
        pt = PhaseTimer("ec.encode")
        # two or more cards: the mesh branch; one card (or the CPU): the
        # lane-packed path, on a codec with this server's options
        mesh = encoder.default_mesh(self.device)
        encoder.write_ec_files_batch(
            list(bases.values()), phases=pt,
            batch_bytes=self._batch_bytes(body), mesh=mesh,
            rs=None if mesh is not None else self._codec(),
        )
        with pt.phase("index"):
            for base in bases.values():
                encoder.write_sorted_file_from_idx(base)
                self._write_vif(base)
        timing = pt.finish()
        self._telemetry.ec.record(timing, volumes=len(vids))
        return Response.json(
            {"ok": True, "volumes": vids, "timing": timing}
        )

    def _h_ec_rebuild(self, req: Request) -> Response:
        tracing.set_op("ec.rebuild")
        body = req.json()
        vid = int(body["volume"])
        base = self._base_for(vid, body.get("collection", ""))
        if base is None:
            return Response.error(f"ec volume {vid} not local", 404)
        rebuilt = rebuild_mod.rebuild_ec_files(base, rs=self._codec())
        return Response.json({"rebuilt_shards": rebuilt})

    def _h_ec_copy(self, req: Request) -> Response:
        """VolumeEcShardsCopy: pull shard files from a source server."""
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        shard_ids = body.get("shard_ids", [])
        source = body["source"]
        loc = self.store.find_free_location() or self.store.locations[0]
        base = loc.base_file_name(collection, vid)
        exts = [C.to_ext(int(s)) for s in shard_ids]
        if body.get("copy_ecx_file", True):
            exts += [".ecx", ".vif"]
            if body.get("copy_ecj_file", True):
                exts += [".ecj"]
        for ext in exts:
            try:
                data = http.request(
                    "GET",
                    f"{source}/admin/ec/download?volume={vid}"
                    f"&collection={collection}&ext={ext}",
                    timeout=600,
                )
            except http.HttpError as e:
                if ext in (".ecj", ".vif"):
                    continue  # optional files
                return Response.error(f"copy {ext}: {e}", 500)
            with open(base + ext, "wb") as f:
                f.write(data)
        return Response.json({"ok": True})

    def _h_ec_download(self, req: Request) -> Response:
        vid = int(req.param("volume"))
        collection = req.param("collection")
        ext = req.param("ext")
        allowed = {C.to_ext(i) for i in range(C.TOTAL_SHARDS)}
        allowed |= {".ecx", ".ecj", ".vif", ".dat", ".idx"}
        if ext not in allowed:
            return Response.error(f"bad ext {ext}", 400)
        base = self._base_for(vid, collection)
        if base is None or not os.path.exists(base + ext):
            return Response.error(f"{ext} for {vid} not here", 404)
        with open(base + ext, "rb") as f:
            return Response(status=200, body=f.read())

    def _h_ec_mount(self, req: Request) -> Response:
        body = req.json()
        self.store.mount_ec_shards(
            int(body["volume"]),
            body.get("collection", ""),
            [int(s) for s in body.get("shard_ids", [])],
        )
        self.heartbeat_once()
        return Response.json({"ok": True})

    def _h_ec_unmount(self, req: Request) -> Response:
        body = req.json()
        self.store.unmount_ec_shards(
            int(body["volume"]),
            [int(s) for s in body.get("shard_ids", [])],
        )
        self.heartbeat_once()
        return Response.json({"ok": True})

    def _h_ec_read(self, req: Request) -> Response:
        vid = int(req.param("volume"))
        sid = int(req.param("shard"))
        offset = int(req.param("offset"))
        size = int(req.param("size"))
        ev = self.store.find_ec_volume(vid)
        if ev is None or sid not in ev.shards:
            return Response.error(
                f"shard {vid}.{sid} not here", 404
            )
        return Response(
            status=200, body=ev.shards[sid].read_at(offset, size)
        )

    def _h_ec_delete_shards(self, req: Request) -> Response:
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        shard_ids = [int(s) for s in body.get("shard_ids", [])]
        self.store.unmount_ec_shards(vid, shard_ids)
        base = self._base_for(vid, collection)
        if base:
            for sid in shard_ids:
                p = base + C.to_ext(sid)
                if os.path.exists(p):
                    os.remove(p)
            # drop index files once no shards remain
            if not any(
                os.path.exists(base + C.to_ext(i))
                for i in range(C.TOTAL_SHARDS)
            ):
                for ext in (".ecx", ".ecj", ".vif"):
                    if os.path.exists(base + ext):
                        os.remove(base + ext)
        return Response.json({"ok": True})

    def _h_ec_to_volume(self, req: Request) -> Response:
        """VolumeEcShardsToVolume: shards → normal volume (ec.decode)."""
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        base = self._base_for(vid, collection)
        if base is None:
            return Response.error(f"ec volume {vid} not local", 404)
        missing = [
            i
            for i in range(C.DATA_SHARDS)
            if not os.path.exists(base + C.to_ext(i))
        ]
        if missing:
            return Response.error(
                f"missing data shards {missing}", 400
            )
        dat_size = decoder.find_dat_file_size(base)
        # unmount before files are replaced
        self.store.unmount_ec_shards(vid, list(range(C.TOTAL_SHARDS)))
        decoder.write_dat_file(base, dat_size)
        decoder.write_idx_file_from_ec_index(base)
        for sid in range(C.TOTAL_SHARDS):
            p = base + C.to_ext(sid)
            if os.path.exists(p):
                os.remove(p)
        for ext in (".ecx", ".ecj"):
            if os.path.exists(base + ext):
                os.remove(base + ext)
        # load the reborn volume
        for loc in self.store.locations:
            if base.startswith(loc.directory):
                from ..storage.volume import Volume

                loc.volumes[vid] = Volume(
                    loc.directory, collection, vid
                )
                break
        self.heartbeat_once()
        return Response.json({"ok": True, "dat_size": dat_size})

    def _h_volume_mount(self, req: Request) -> Response:
        body = req.json()
        try:
            self.store.mount_volume(
                int(body["volume"]), body.get("collection", "")
            )
        except KeyError as e:
            return Response.error(str(e), 404)
        self.heartbeat_once()  # master must learn the location NOW
        return Response.json({"ok": True})

    def _h_volume_unmount(self, req: Request) -> Response:
        body = req.json()
        try:
            self.store.unmount_volume(int(body["volume"]))
        except KeyError as e:
            return Response.error(str(e), 404)
        self.heartbeat_once()  # drop the location before replying
        return Response.json({"ok": True})

    def _h_volume_configure_replication(self, req: Request) -> Response:
        """VolumeConfigure: rewrite the superblock's replica placement
        (volume_grpc_admin.go VolumeConfigure +
        super_block.ReplicaPlacement)."""
        body = req.json()
        vol = self._require_volume(int(body["volume"]))
        rp = t.ReplicaPlacement.parse(body["replication"])
        vol.set_replica_placement(rp)
        return Response.json({"ok": True, "replication": str(rp)})

    def _h_leave(self, req: Request) -> Response:
        """VolumeServerLeave: stop heartbeating so the master
        gracefully unregisters this server; data keeps serving until
        the process stops (volume_grpc_admin.go VolumeServerLeave)."""
        self._running = False  # ends the heartbeat loop
        self._close_hb_stream()
        return Response.json({"ok": True})

    def _h_fsck(self, req: Request) -> Response:
        """Verify every live needle's checksum (volume.fsck support)."""
        checked, issues = 0, []
        for loc in self.store.locations:
            for vol in loc.volumes.values():
                for key, nv in vol.nm.ascending_visit():
                    if not t.size_is_valid(nv.size):
                        continue
                    checked += 1
                    try:
                        vol.read_needle(key)
                    except Exception as e:
                        issues.append(
                            f"volume {vol.id} needle {key:x}: {e}"
                        )
        return Response.json({"checked": checked, "issues": issues})

    def _h_volume_copy(self, req: Request) -> Response:
        """VolumeCopy: pull a whole volume (.dat + .idx) from a source
        server and load it (volume_grpc_copy.go analog)."""
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        source = body["source"]
        if self.store.find_volume(vid) is not None:
            return Response.error(f"volume {vid} already here", 409)
        loc = self.store.find_free_location()
        if loc is None:
            return Response.error("no free slots", 500)
        base = loc.base_file_name(collection, vid)
        for ext in (".dat", ".idx"):
            data = http.request(
                "GET",
                f"{source}/admin/ec/download?volume={vid}"
                f"&collection={collection}&ext={ext}",
                timeout=3600,
            )
            with open(base + ext, "wb") as f:
                f.write(data)
        from ..storage.volume import Volume

        loc.volumes[vid] = Volume(loc.directory, collection, vid)
        self.store.new_volumes.append(
            self.store._volume_message(loc.volumes[vid])
        )
        self.heartbeat_once()
        return Response.json({"ok": True})

    def _h_query(self, req: Request) -> Response:
        """The Query rpc: JSON filter/projection over needle contents
        (volume_grpc_query.go:13-62). Scope = one fid or a whole
        volume; returns NDJSON."""
        from ..query import query_json_lines

        body = req.json()
        flt = body.get("filter")
        projections = body.get("projections")
        limit = int(body.get("limit", 10_000))
        blobs: list[bytes] = []
        if fid_str := body.get("fid"):
            fid = FileId.parse(fid_str)
            vol = self.store.find_volume(fid.volume_id)
            if vol is None:
                return Response.error("volume not local", 404)
            blobs.append(vol.read_needle(fid.key, fid.cookie).data)
        elif vid := body.get("volume"):
            vol = self.store.find_volume(int(vid))
            if vol is None:
                return Response.error("volume not local", 404)
            for key, nv in vol.nm.ascending_visit():
                if t.size_is_valid(nv.size):
                    blobs.append(vol.read_needle(key).data)
        out_lines = []
        for blob in blobs:
            for doc in query_json_lines(blob, flt, projections):
                out_lines.append(json.dumps(doc))
                if len(out_lines) >= limit:
                    break
            if len(out_lines) >= limit:
                break
        return Response(
            status=200,
            body=("\n".join(out_lines) + "\n").encode(),
            headers={"Content-Type": "application/x-ndjson"},
        )

    def _h_tier_upload(self, req: Request) -> Response:
        """VolumeTierMoveDatToRemote: push .dat to a remote HTTP store
        (filer or S3 gateway path), keep serving via Range reads
        (volume_grpc_tier_upload.go analog)."""
        from ..storage import backend as backend_mod
        from ..storage.volume import Volume

        body = req.json()
        vid = int(body["volume"])
        keep_local = bool(body.get("keep_local", False))
        vol = self._require_volume(vid)
        vol.readonly = True
        vol.sync()
        dat_path = vol.data_file_name
        size = os.path.getsize(dat_path)
        if s3_spec := body.get("s3"):
            # cloud tier: .dat becomes one sigv4-signed S3 object
            # (s3_backend.go:20-50); key defaults to the dat name.
            # Credentials come ONLY from the named backend config
            # (backend.json / WEED_S3_* env) — never from the request
            # and never into the persisted .vif, so the upload and
            # every later read resolve identically.
            if s3_spec.get("access_key") or s3_spec.get("secret_key"):
                return Response.error(
                    "inline S3 credentials are not accepted; configure "
                    "a named backend (backend.json s3.<name>.* or "
                    "WEED_S3_<NAME>_* env) and pass its name as "
                    '"backend"',
                    400,
                )
            # pick up backend.json edits made since startup — tiering
            # is rare, so re-reading config here keeps rotated keys
            # usable without a server restart
            backend_mod.reload_backend_configuration()
            be = backend_mod.S3Backend(
                endpoint=s3_spec["endpoint"],
                bucket=s3_spec["bucket"],
                key=s3_spec.get("key")
                or os.path.basename(dat_path),
                backend_name=s3_spec.get("backend", "default"),
            )
            be.upload_file(dat_path)
            remote = be.spec()
        else:
            dest_url = body["dest_url"]  # full URL to PUT the .dat at
            with open(dat_path, "rb") as f:
                http.request("POST", dest_url, f, timeout=3600)
            remote = {"url": dest_url, "size": size}
        vif = backend_mod.load_volume_info(vol.base_file_name)
        vif.update({"version": vol.version, "remote": remote})
        backend_mod.save_volume_info(vol.base_file_name, vif)
        collection, directory = vol.collection, vol.dir
        # reload in remote mode
        for loc in self.store.locations:
            if vid in loc.volumes:
                loc.volumes[vid].close()
                if not keep_local:
                    os.remove(dat_path)
                loc.volumes[vid] = Volume(directory, collection, vid)
                break
        return Response.json({"ok": True, "size": size})

    def _h_tier_download(self, req: Request) -> Response:
        """VolumeTierMoveDatFromRemote: pull the .dat back to disk."""
        from ..storage import backend as backend_mod
        from ..storage.volume import Volume

        body = req.json()
        vid = int(body["volume"])
        vol = self._require_volume(vid)
        be = vol.remote_backend
        if be is None:
            return Response.error(f"volume {vid} is not remote", 400)
        dat_path = vol.data_file_name
        if isinstance(be, backend_mod.S3Backend):
            be.download_file(dat_path)
        else:
            with http.request_stream(
                "GET", be.url, timeout=3600
            ) as r, open(dat_path, "wb") as f:
                for piece in r.iter(1 << 20):
                    f.write(piece)
        os.remove(vol.base_file_name + ".vif")
        collection, directory = vol.collection, vol.dir
        for loc in self.store.locations:
            if vid in loc.volumes:
                loc.volumes[vid].close()
                loc.volumes[vid] = Volume(directory, collection, vid)
                loc.volumes[vid].readonly = False
                break
        return Response.json({"ok": True})

    def _h_tail(self, req: Request) -> Response:
        """VolumeTailSender: raw .dat bytes appended at/after since_ns
        (volume_grpc_tail.go + volume_backup.go:170)."""
        vid = int(req.param("volume"))
        since_ns = int(req.param("since_ns", "0"))
        vol = self._require_volume(vid)
        start = (
            vol.binary_search_by_append_at_ns(since_ns)
            if since_ns
            else vol.super_block.block_size
        )
        end = vol.data_file_size()
        if start >= end:
            return Response(status=200, body=b"")
        return Response(
            status=200,
            body=vol._pread(start, end - start),
            headers={"X-Tail-Offset": str(start)},
        )

    def _h_ec_blob_delete(self, req: Request) -> Response:
        body = req.json()
        vid = int(body["volume"])
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            return Response.error(f"ec volume {vid} not here", 404)
        key, _ = parse_needle_id_cookie(body["needle_id_cookie"]) if isinstance(
            body.get("needle_id_cookie"), str
        ) else (int(body["needle_id"]), 0)
        ev.delete_needle(key)
        return Response.json({"ok": True})
