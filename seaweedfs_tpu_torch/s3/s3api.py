"""S3 API server: buckets/objects/multipart/tagging/list over the filer.

Behavioral model: weed/s3api/s3api_server.go:44-130 (route semantics),
s3api_bucket_handlers.go, s3api_object_handlers.go, filer_multipart.go
(multipart completion = chunk-list concatenation, no data copy),
s3api_objects_list_handlers.go (list v1/v2 with prefix/delimiter/
common-prefixes). Objects live under /buckets/<bucket>/<key> in the
filer namespace, like the reference's filer-backed layout.

The port's copy of ``seaweedfs_tpu/s3/s3api.py``.
"""

from __future__ import annotations

import hashlib
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

from .. import fault, tracing
from ..filer import Entry, Filer, sharding
from ..filer.entry import Attr, FileChunk
from ..filer.filechunks import total_size
from ..telemetry.reporter import TelemetryReporter
from ..telemetry.snapshot import mark_started, metrics_response
from ..tracing import middleware as trace_mw
from ..util import http
from ..util.http import Request, Response, Router
from .auth import (
    ACTION_ADMIN,
    ACTION_LIST,
    ACTION_READ,
    ACTION_TAGGING,
    ACTION_WRITE,
    AuthError,
    Identity,
    IdentityAccessManagement,
)

BUCKETS_PREFIX = "/buckets"
MULTIPART_DIR = ".uploads"


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def _err_xml(code: str, message: str, status: int) -> Response:
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = code
    ET.SubElement(root, "Message").text = message
    return Response(
        status=status,
        body=_xml(root),
        headers={"Content-Type": "application/xml"},
    )


def _iso(ts: float) -> str:
    return time.strftime(
        "%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts)
    )


def _s3_op(req: Request, bucket: str, key: str, q) -> str:
    """AWS API operation name for one request — mirrors `_route`'s
    branching; used as the span/histogram op label."""
    m = req.method
    if not bucket:
        return "ListBuckets"
    if key:
        if m == "GET" and "uploadId" in q:
            return "ListParts"
        if m == "GET" and "tagging" in q:
            return "GetObjectTagging"
        if m == "GET":
            return "GetObject"
        if m == "HEAD":
            return "HeadObject"
        if m == "PUT" and "partNumber" in q:
            return "UploadPart"
        if m == "PUT" and "tagging" in q:
            return "PutObjectTagging"
        if m == "PUT" and req.headers.get("X-Amz-Copy-Source"):
            return "CopyObject"
        if m == "PUT":
            return "PutObject"
        if m == "POST" and "uploads" in q:
            return "CreateMultipartUpload"
        if m == "POST" and "uploadId" in q:
            return "CompleteMultipartUpload"
        if m == "DELETE" and "uploadId" in q:
            return "AbortMultipartUpload"
        if m == "DELETE" and "tagging" in q:
            return "DeleteObjectTagging"
        if m == "DELETE":
            return "DeleteObject"
    else:
        if m == "PUT":
            return "CreateBucket"
        if m == "DELETE":
            return "DeleteBucket"
        if m == "HEAD":
            return "HeadBucket"
        if m == "POST" and "delete" in q:
            return "DeleteObjects"
        if m == "POST":
            return "PostObject"
        if m == "GET" and "uploads" in q:
            return "ListMultipartUploads"
        if m == "GET":
            return "ListObjects"
    return m


class S3ApiServer:
    def __init__(
        self,
        filer_url: str,
        host: str = "127.0.0.1",
        port: int = 0,
        identities: list[Identity] | None = None,
        filer: Filer | None = None,
        ssl_context=None,
        master_url: str = "",
        telemetry_interval: float = 10.0,
    ):
        """Runs against a filer address — one URL, an ordered shard
        list, or a FilerRing (filer/sharding): every metadata call is
        routed to the shard owning its path. `filer` may additionally
        be passed for in-proc deployments (same process as
        FilerServer) to skip HTTP on the metadata path. When
        `master_url` is given the gateway pushes its telemetry
        snapshot there periodically (telemetry/reporter.py) so it
        appears in /cluster/telemetry."""
        self.ring = sharding.ring_of(filer_url)
        # back-compat: the plain primary URL for single-URL consumers
        self.filer_url = self.ring.primary
        self.master_url = master_url
        self.telemetry_interval = telemetry_interval
        self._telemetry_reporter: TelemetryReporter | None = None
        self.iam = IdentityAccessManagement(identities)
        # hot-reload identities written by `s3.configure` into the filer
        # (auth_credentials.go meta-subscription analog, poll-based)
        self._iam_path = "/etc/iam/identities.json"
        self._iam_checked = 0.0
        self._iam_static = bool(identities)
        router = Router()
        # prepended so the catch-all object route can't shadow it
        fault.install_routes(router)
        # reserved path ahead of the bucket catch-all, like the debug
        # plane the middleware prepends: a bucket literally named
        # "metrics" loses to the operator surface
        router.add("GET", r"/metrics", self._h_metrics)
        router.add("*", r"/.*", self._dispatch)
        self.server = http.HttpServer(
            trace_mw.instrument(router, "s3"),
            host, port, ssl_context=ssl_context,
        )

    def _maybe_reload_identities(self) -> None:
        if self._iam_static:
            return
        now = time.monotonic()
        if now - self._iam_checked < 2.0:
            return
        self._iam_checked = now
        import json as _json

        try:
            cfg = _json.loads(
                self.ring.request(
                    "GET", self._iam_path, timeout=5,
                )
            )
        except Exception:
            return
        idents = [
            Identity(
                name=i["name"],
                access_key=i["credentials"][0]["accessKey"],
                secret_key=i["credentials"][0]["secretKey"],
                actions=i.get("actions", ["Admin"]),
            )
            for i in cfg.get("identities", [])
        ]
        self.iam = IdentityAccessManagement(idents)

    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> None:
        self.server.start()
        mark_started("s3")
        if self.master_url and self.telemetry_interval > 0:
            self._telemetry_reporter = TelemetryReporter(
                "s3", self.url, self.master_url,
                interval=self.telemetry_interval,
                tally=self.server.router.tally,
            )
            self._telemetry_reporter.start()

    def stop(self) -> None:
        if self._telemetry_reporter is not None:
            self._telemetry_reporter.stop()
        self.server.stop()

    def _h_metrics(self, req: Request) -> Response:
        return metrics_response()

    # -- filer client ----------------------------------------------------

    def _fpath(self, bucket: str, key: str = "") -> str:
        p = f"{BUCKETS_PREFIX}/{bucket}"
        if key:
            p += f"/{key}"
        return p

    # every call below rides the ring's retry.Policy (reads LOOKUP,
    # writes DEFAULT) and routes to the shard owning the path — a
    # filer blip retries instead of failing the S3 request, and a
    # bucket listing of /buckets fans out across the shard tier

    def _filer_get(self, path: str, raw: bool = False):
        return self.ring.request("GET", path)

    def _filer_put(self, path: str, body: bytes, headers=None):
        return self.ring.request("POST", path, body, headers or {})

    def _filer_delete(self, path: str, recursive: bool = False):
        qs = "?recursive=true" if recursive else ""
        if recursive and self.ring.fans_out(path):
            self.ring.delete(path, recursive=True)
            return b""
        return self.ring.request("DELETE", path, qs=qs)

    def _filer_list(
        self, path: str, last: str = "", limit: int = 1000
    ) -> list[dict]:
        return self.ring.list_page(path, last=last, limit=limit)

    def _filer_head(self, path: str) -> dict | None:
        try:
            self.ring.request("GET", path, qs="?limit=1")
        except http.HttpError:
            return None
        return {}

    # -- dispatch --------------------------------------------------------

    def _dispatch(self, req: Request) -> Response:
        self._maybe_reload_identities()
        path = urllib.parse.unquote(req.path)
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        q = req.query
        # AWS-style operation name BEFORE auth, so even rejected
        # requests carry a bounded span op (keys are unbounded)
        tracing.set_op(_s3_op(req, bucket, key, q))
        ctype = req.headers.get("Content-Type", "")
        if (
            req.method == "POST"
            and bucket
            and not key
            and ctype.startswith("multipart/form-data")
        ):
            # browser form upload: auth comes from the signed policy
            # in the form fields, not the Authorization header
            # (weed/s3api/s3api_object_handlers_postpolicy.go)
            try:
                return self._post_policy_upload(req, bucket)
            except AuthError as e:
                return _err_xml(e.code, e.message, e.status)
        action = self._classify(req, bucket, key)
        try:
            identity = self.iam.authenticate(
                req.method, req.path, req.query, req.headers, req.body
            )
            decoded = self.iam.decode_streaming_upload(
                req.headers, req.body
            )
            if decoded is not None:
                # aws-chunked streaming sigv4 (aws-cli / SDK large
                # PUTs): chunk signatures verified, body replaced by
                # the decoded payload
                req._body = decoded
        except AuthError as e:
            return _err_xml(e.code, e.message, e.status)
        if identity is not None and not identity.allows(action, bucket):
            return _err_xml(
                "AccessDenied",
                f"{identity.name} may not {action} on {bucket}",
                403,
            )
        try:
            return self._route(req, bucket, key, q)
        except http.HttpError as e:
            if e.status == 404:
                return _err_xml("NoSuchKey", key or bucket, 404)
            return _err_xml("InternalError", str(e), 500)

    def _classify(self, req: Request, bucket: str, key: str) -> str:
        if req.method in ("GET", "HEAD"):
            return ACTION_LIST if not key else ACTION_READ
        if "tagging" in req.query:
            return ACTION_TAGGING
        if req.method == "PUT" and not key:
            return ACTION_ADMIN
        return ACTION_WRITE

    def _route(
        self, req: Request, bucket: str, key: str, q
    ) -> Response:
        m = req.method
        if not bucket:
            if m == "GET":
                return self._list_buckets()
            return _err_xml("MethodNotAllowed", m, 405)
        if key:
            if m == "GET" and "uploadId" in q:
                return self._list_parts(bucket, key, q)
            if m == "GET" and "tagging" in q:
                return self._get_tagging(bucket, key)
            if m in ("GET", "HEAD"):
                return self._get_object(req, bucket, key)
            if m == "PUT" and "partNumber" in q:
                return self._put_part(req, bucket, key, q)
            if m == "PUT" and "tagging" in q:
                return self._put_tagging(req, bucket, key)
            if m == "PUT" and req.headers.get("X-Amz-Copy-Source"):
                return self._copy_object(req, bucket, key)
            if m == "PUT":
                return self._put_object(req, bucket, key)
            if m == "POST" and "uploads" in q:
                return self._new_multipart(bucket, key)
            if m == "POST" and "uploadId" in q:
                return self._complete_multipart(req, bucket, key, q)
            if m == "DELETE" and "uploadId" in q:
                return self._abort_multipart(bucket, key, q)
            if m == "DELETE" and "tagging" in q:
                return self._delete_tagging(bucket, key)
            if m == "DELETE":
                return self._delete_object(bucket, key)
        else:
            if m == "PUT":
                return self._put_bucket(bucket)
            if m == "DELETE":
                return self._delete_bucket(bucket)
            if m == "HEAD":
                return self._head_bucket(bucket)
            if m == "POST" and "delete" in q:
                return self._delete_multiple(req, bucket)
            if m == "GET" and "uploads" in q:
                return self._list_multipart_uploads(bucket)
            if m == "GET":
                return self._list_objects(req, bucket, q)
        return _err_xml("MethodNotAllowed", m, 405)

    def _post_policy_upload(self, req: Request, bucket: str) -> Response:
        """POST policy (browser form) upload: verify the signed policy,
        then store the file part under the form's key
        (weed/s3api/policy/post-policy.go conditions +
        s3api_object_handlers_postpolicy.go)."""
        try:
            parts = http.parse_multipart(
                req.body, req.headers.get("Content-Type", "")
            )
        except ValueError as e:
            return _err_xml("MalformedPOSTRequest", str(e), 400)
        fields = {
            p.name.lower(): p.data.decode("utf-8", "replace")
            for p in parts
            if p.filename is None
        }
        file_part = next(
            (p for p in parts if p.filename is not None), None
        )
        if file_part is None or "key" not in fields:
            return _err_xml(
                "MalformedPOSTRequest", "missing file or key", 400
            )
        key = fields["key"].replace(
            "${filename}", file_part.filename or ""
        )
        identity = self.iam.verify_post_policy(
            fields, bucket, key, len(file_part.data)
        )
        if identity is not None and not identity.allows(
            ACTION_WRITE, bucket
        ):
            return _err_xml(
                "AccessDenied",
                f"{identity.name} may not Write on {bucket}", 403,
            )
        headers = {}
        if ct := fields.get("content-type"):
            headers["Content-Type"] = ct
        self._filer_put(
            self._fpath(bucket, key), file_part.data, headers
        )
        try:
            status = int(fields.get("success_action_status", "204"))
        except ValueError:
            status = 204  # AWS ignores invalid values
        if status not in (200, 201, 204):
            status = 204
        if status == 201:
            root = ET.Element("PostResponse")
            ET.SubElement(root, "Bucket").text = bucket
            ET.SubElement(root, "Key").text = key
            return Response(
                status=201, body=_xml(root),
                headers={"Content-Type": "application/xml"},
            )
        return Response(status=status)

    # -- buckets ---------------------------------------------------------

    def _list_buckets(self) -> Response:
        entries = self._filer_list(BUCKETS_PREFIX)
        root = ET.Element("ListAllMyBucketsResult")
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "seaweedfs"
        buckets = ET.SubElement(root, "Buckets")
        for e in entries:
            if not e["IsDirectory"]:
                continue
            b = ET.SubElement(buckets, "Bucket")
            ET.SubElement(b, "Name").text = e["FullPath"].rsplit(
                "/", 1
            )[-1]
            ET.SubElement(b, "CreationDate").text = _iso(e["Mtime"])
        return Response(
            status=200, body=_xml(root),
            headers={"Content-Type": "application/xml"},
        )

    def _put_bucket(self, bucket: str) -> Response:
        self._filer_put(self._fpath(bucket) + "/", b"")
        return Response(status=200)

    def _delete_bucket(self, bucket: str) -> Response:
        self._filer_delete(self._fpath(bucket), recursive=True)
        return Response(status=204)

    def _head_bucket(self, bucket: str) -> Response:
        entries = self._filer_list(BUCKETS_PREFIX)
        names = {
            e["FullPath"].rsplit("/", 1)[-1]
            for e in entries
            if e["IsDirectory"]
        }
        if bucket not in names:
            return _err_xml("NoSuchBucket", bucket, 404)
        return Response(status=200)

    # -- objects ---------------------------------------------------------

    def _put_object(self, req: Request, bucket: str, key: str) -> Response:
        headers = {}
        if ct := req.headers.get("Content-Type"):
            headers["Content-Type"] = ct
        if tags := req.headers.get("X-Amz-Tagging"):
            headers["X-Amz-Tagging"] = tags
        for k, v in req.headers.items():
            if k.lower().startswith("x-amz-meta-"):
                headers[k] = v
        out = self._filer_put(
            self._fpath(bucket, key), req.body, headers
        )
        import json

        etag = json.loads(out).get("eTag", "")
        return Response(status=200, headers={"ETag": f'"{etag}"'})

    def _get_object(self, req: Request, bucket: str, key: str) -> Response:
        fpath = self._fpath(bucket, key)
        url = f"{self.ring.url_for(fpath)}{fpath}"
        headers = {}
        if rng := req.headers.get("Range"):
            headers["Range"] = rng
        try:
            # stream filer → gateway → client: the gateway holds
            # O(piece) memory for any object size, like the filer
            # itself (weed/filer/stream.go pass-through)
            upstream = http.request_stream(
                req.method, url, headers=headers
            )
        except http.HttpError as e:
            if e.status == 404:
                return _err_xml("NoSuchKey", key, 404)
            if e.status == 416:
                return _err_xml(
                    "InvalidRange",
                    "requested range not satisfiable", 416,
                )
            raise
        out_headers = {}
        for h, v in upstream.headers.items():
            lh = h.lower()
            # pass object + user metadata through; hop-by-hop and
            # body-framing headers stay ours
            if lh in ("content-type", "etag", "content-range") or (
                lh.startswith("x-amz-")
            ) or lh.startswith("seaweed-"):
                out_headers[h] = v
        status = upstream.status
        if req.method == "HEAD":
            # the filer carries the size of a bodyless HEAD in a hint
            # header; S3 clients need it as a real Content-Length
            hint = upstream.headers.get("Content-Length-Hint")
            upstream.close()
            if hint:
                return Response(
                    status=status,
                    stream=iter(()),
                    content_length=int(hint),
                    headers=out_headers,
                )
            return Response(status=status, headers=out_headers)

        def gen(up=upstream):
            try:
                yield from up.iter(1 << 20)
            finally:
                up.close()  # release the filer connection either way

        clen = upstream.headers.get("Content-Length")
        return Response(
            status=status,
            stream=gen(),
            content_length=int(clen) if clen else None,
            headers=out_headers,
        )

    def _delete_object(self, bucket: str, key: str) -> Response:
        try:
            self._filer_delete(self._fpath(bucket, key))
        except http.HttpError:
            pass
        return Response(status=204)

    def _copy_object(self, req: Request, bucket: str, key: str) -> Response:
        src = urllib.parse.unquote(
            req.headers["X-Amz-Copy-Source"]
        ).lstrip("/")
        src_bucket, _, src_key = src.partition("/")
        data = self._filer_get(self._fpath(src_bucket, src_key))
        self._filer_put(self._fpath(bucket, key), data)
        etag = hashlib.md5(data).hexdigest()
        root = ET.Element("CopyObjectResult")
        ET.SubElement(root, "ETag").text = f'"{etag}"'
        ET.SubElement(root, "LastModified").text = _iso(time.time())
        return Response(
            status=200, body=_xml(root),
            headers={"Content-Type": "application/xml"},
        )

    def _delete_multiple(self, req: Request, bucket: str) -> Response:
        root = ET.fromstring(req.body)
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag.split("}")[0] + "}"
        deleted = []
        for obj in root.findall(f"{ns}Object"):
            key = obj.find(f"{ns}Key").text
            try:
                self._filer_delete(self._fpath(bucket, key))
            except http.HttpError:
                pass
            deleted.append(key)
        out = ET.Element("DeleteResult")
        for key in deleted:
            d = ET.SubElement(out, "Deleted")
            ET.SubElement(d, "Key").text = key
        return Response(
            status=200, body=_xml(out),
            headers={"Content-Type": "application/xml"},
        )

    # -- tagging ---------------------------------------------------------

    def _get_tagging(self, bucket: str, key: str) -> Response:
        # tags stored in the entry's extended attrs via header passthrough
        try:
            self.ring.request("HEAD", self._fpath(bucket, key))
        except http.HttpError:
            return _err_xml("NoSuchKey", key, 404)
        # HEAD response headers aren't returned by http.request; re-GET
        # the entry listing instead
        parent = self._fpath(bucket, key).rsplit("/", 1)[0]
        name = key.rsplit("/", 1)[-1]
        tags = ""
        for e in self._filer_list(parent):
            if e["FullPath"].rsplit("/", 1)[-1] == name:
                tags = (e.get("Extended") or {}).get(
                    "X-Amz-Tagging", ""
                ) or (e.get("Extended") or {}).get("x-amz-tagging", "")
        root = ET.Element("Tagging")
        tagset = ET.SubElement(root, "TagSet")
        if tags:
            for pair in tags.split("&"):
                k, _, v = pair.partition("=")
                tag = ET.SubElement(tagset, "Tag")
                ET.SubElement(tag, "Key").text = urllib.parse.unquote(k)
                ET.SubElement(tag, "Value").text = (
                    urllib.parse.unquote(v)
                )
        return Response(
            status=200, body=_xml(root),
            headers={"Content-Type": "application/xml"},
        )

    def _put_tagging(self, req: Request, bucket: str, key: str) -> Response:
        root = ET.fromstring(req.body)
        ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
        pairs = []
        for tag in root.iter(f"{ns}Tag"):
            k = tag.find(f"{ns}Key").text or ""
            v = tag.find(f"{ns}Value").text or ""
            pairs.append(
                f"{urllib.parse.quote(k)}={urllib.parse.quote(v)}"
            )
        data = self._filer_get(self._fpath(bucket, key))
        self._filer_put(
            self._fpath(bucket, key),
            data,
            {"X-Amz-Tagging": "&".join(pairs)},
        )
        return Response(status=200)

    def _delete_tagging(self, bucket: str, key: str) -> Response:
        data = self._filer_get(self._fpath(bucket, key))
        self._filer_put(self._fpath(bucket, key), data)
        return Response(status=204)

    # -- listing ---------------------------------------------------------

    def _list_objects(self, req: Request, bucket: str, q) -> Response:
        prefix = req.param("prefix")
        delimiter = req.param("delimiter")
        max_keys = int(req.param("max-keys", "1000"))
        v2 = req.param("list-type") == "2"
        marker = req.param(
            "continuation-token" if v2 else "marker"
        ) or req.param("start-after")
        contents, common = self._walk_keys(
            bucket, prefix, delimiter, marker, max_keys
        )
        root = ET.Element("ListBucketResult")
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = prefix
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        ET.SubElement(root, "IsTruncated").text = (
            "true" if len(contents) >= max_keys else "false"
        )
        if v2:
            ET.SubElement(root, "KeyCount").text = str(len(contents))
        for key, e in contents:
            c = ET.SubElement(root, "Contents")
            ET.SubElement(c, "Key").text = key
            ET.SubElement(c, "LastModified").text = _iso(e["Mtime"])
            ET.SubElement(c, "Size").text = str(e["FileSize"])
            ET.SubElement(c, "ETag").text = '""'
            ET.SubElement(c, "StorageClass").text = "STANDARD"
        for p in sorted(common):
            cp = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(cp, "Prefix").text = p
        return Response(
            status=200, body=_xml(root),
            headers={"Content-Type": "application/xml"},
        )

    def _walk_keys(
        self, bucket, prefix, delimiter, marker, max_keys
    ) -> tuple[list, set]:
        """DFS the filer tree under the bucket, yielding keys in order."""
        contents: list = []
        common: set[str] = set()
        base = self._fpath(bucket)

        def walk(dir_path: str, key_prefix: str):
            if len(contents) >= max_keys:
                return
            last = ""
            while True:
                entries = self._filer_list(dir_path, last=last)
                if not entries:
                    return
                for e in entries:
                    name = e["FullPath"].rsplit("/", 1)[-1]
                    last = name
                    if name == MULTIPART_DIR:
                        continue
                    key = key_prefix + name
                    if e["IsDirectory"]:
                        key_dir = key + "/"
                        if prefix and not (
                            key_dir.startswith(prefix)
                            or prefix.startswith(key_dir)
                        ):
                            continue
                        if delimiter == "/" and key_dir.startswith(
                            prefix
                        ):
                            common.add(key_dir)
                            continue
                        walk(e["FullPath"], key_dir)
                    else:
                        if prefix and not key.startswith(prefix):
                            continue
                        if marker and key <= marker:
                            continue
                        if len(contents) >= max_keys:
                            return
                        contents.append((key, e))
                if len(entries) < 100:
                    return

        walk(base, "")
        return contents, common

    # -- multipart (filer_multipart.go) ----------------------------------

    def _upload_dir(self, bucket: str, upload_id: str) -> str:
        return f"{self._fpath(bucket)}/{MULTIPART_DIR}/{upload_id}"

    def _new_multipart(self, bucket: str, key: str) -> Response:
        upload_id = uuid.uuid4().hex
        self._filer_put(
            self._upload_dir(bucket, upload_id) + "/", b""
        )
        # remember the object key for completion
        self._filer_put(
            self._upload_dir(bucket, upload_id) + "/.key",
            key.encode(),
        )
        root = ET.Element("InitiateMultipartUploadResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        return Response(
            status=200, body=_xml(root),
            headers={"Content-Type": "application/xml"},
        )

    def _put_part(self, req: Request, bucket: str, key: str, q) -> Response:
        upload_id = req.param("uploadId")
        part = int(req.param("partNumber"))
        out = self._filer_put(
            f"{self._upload_dir(bucket, upload_id)}/{part:04d}.part",
            req.body,
        )
        import json

        etag = json.loads(out).get("eTag", "")
        return Response(status=200, headers={"ETag": f'"{etag}"'})

    def _complete_multipart(
        self, req: Request, bucket: str, key: str, q
    ) -> Response:
        upload_id = req.param("uploadId")
        updir = self._upload_dir(bucket, upload_id)
        parts = [
            e
            for e in self._filer_list(updir)
            if e["FullPath"].endswith(".part")
        ]
        parts.sort(key=lambda e: e["FullPath"])
        # concatenate the parts' bytes into the final object.
        # (the reference concatenates chunk lists without moving data —
        # an optimization to adopt once the S3 server and filer share a
        # process; over HTTP we concatenate content.)
        body = b"".join(
            self._filer_get(e["FullPath"]) for e in parts
        )
        self._filer_put(self._fpath(bucket, key), body)
        self._filer_delete(updir, recursive=True)
        etag = hashlib.md5(body).hexdigest()
        root = ET.Element("CompleteMultipartUploadResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "ETag").text = f'"{etag}-{len(parts)}"'
        return Response(
            status=200, body=_xml(root),
            headers={"Content-Type": "application/xml"},
        )

    def _abort_multipart(self, bucket: str, key: str, q) -> Response:
        upload_id = q["uploadId"][0]
        try:
            self._filer_delete(
                self._upload_dir(bucket, upload_id), recursive=True
            )
        except http.HttpError:
            pass
        return Response(status=204)

    def _list_parts(self, bucket: str, key: str, q) -> Response:
        upload_id = q["uploadId"][0]
        parts = [
            e
            for e in self._filer_list(
                self._upload_dir(bucket, upload_id)
            )
            if e["FullPath"].endswith(".part")
        ]
        root = ET.Element("ListPartsResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        for e in sorted(parts, key=lambda e: e["FullPath"]):
            p = ET.SubElement(root, "Part")
            num = int(
                e["FullPath"].rsplit("/", 1)[-1].split(".")[0]
            )
            ET.SubElement(p, "PartNumber").text = str(num)
            ET.SubElement(p, "Size").text = str(e["FileSize"])
            ET.SubElement(p, "LastModified").text = _iso(e["Mtime"])
        return Response(
            status=200, body=_xml(root),
            headers={"Content-Type": "application/xml"},
        )

    def _list_multipart_uploads(self, bucket: str) -> Response:
        root = ET.Element("ListMultipartUploadsResult")
        ET.SubElement(root, "Bucket").text = bucket
        try:
            uploads = self._filer_list(
                f"{self._fpath(bucket)}/{MULTIPART_DIR}"
            )
        except http.HttpError:
            uploads = []
        for e in uploads:
            if not e["IsDirectory"]:
                continue
            u = ET.SubElement(root, "Upload")
            upload_id = e["FullPath"].rsplit("/", 1)[-1]
            ET.SubElement(u, "UploadId").text = upload_id
            try:
                key = self._filer_get(
                    f"{e['FullPath']}/.key"
                ).decode()
            except http.HttpError:
                key = ""
            ET.SubElement(u, "Key").text = key
        return Response(
            status=200, body=_xml(root),
            headers={"Content-Type": "application/xml"},
        )
