"""WebDAV gateway over the filer (weed/server/webdav_server.go analog).

Implements the RFC4918 subset that `cadaver`, macOS Finder, and
davfs2 actually use: OPTIONS, PROPFIND (depth 0/1), GET/HEAD, PUT,
DELETE, MKCOL, MOVE, COPY — plus class-2 locking (LOCK/UNLOCK with
exclusive write locks, timeouts, refresh, If-header enforcement on
mutations) and PROPPATCH, which macOS Finder and MS Office require
before they will save through a DAV mount (the reference gets these
from golang.org/x/net/webdav's full handler).

The port's copy of ``seaweedfs_tpu/server/webdav.py``.
"""

from __future__ import annotations

import re
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from email.utils import formatdate

from ..util import http
from ..util.http import Request, Response, Router

DAV = "DAV:"

_DEFAULT_LOCK_TIMEOUT = 3600.0
_MAX_LOCK_TIMEOUT = 24 * 3600.0


@dataclass
class DavLock:
    token: str
    path: str
    owner: str
    expires: float
    timeout: float
    depth: str = "infinity"


def _norm(path: str) -> str:
    """Canonical lock key: no trailing slash (clients LOCK '/dir/' but
    mutate '/dir/file'), root stays '/'."""
    return "/" + path.strip("/") if path.strip("/") else "/"


class LockManager:
    """Exclusive write locks over the DAV namespace (class 2)."""

    def __init__(self):
        self._locks: dict[str, DavLock] = {}
        self._mu = threading.Lock()

    def _prune(self) -> None:
        now = time.monotonic()
        for p in [
            p for p, lk in self._locks.items() if lk.expires < now
        ]:
            del self._locks[p]

    def _covering_locked(self, path: str) -> DavLock | None:
        lk = self._locks.get(path)
        if lk is not None:
            return lk
        parent = path
        while parent != "/":
            parent = parent.rsplit("/", 1)[0] or "/"
            lk = self._locks.get(parent)
            if lk is not None and lk.depth == "infinity":
                return lk
        return None

    def covering(self, path: str) -> DavLock | None:
        """The lock protecting `path`: on itself or an infinite-depth
        ancestor lock."""
        with self._mu:
            self._prune()
            return self._covering_locked(_norm(path))

    def descendants(self, path: str) -> list[DavLock]:
        """Locks held strictly BELOW `path` — a collection
        delete/move must present their tokens too (RFC 4918 §9.6)."""
        base = _norm(path)
        prefix = base.rstrip("/") + "/"
        with self._mu:
            self._prune()
            return [
                lk for p, lk in self._locks.items()
                if p.startswith(prefix)
            ]

    def lock(
        self, path: str, owner: str, timeout: float, depth: str
    ) -> DavLock | None:
        path = _norm(path)
        with self._mu:
            self._prune()
            # conflict with the exact path, a covering ancestor
            # (depth-infinity), or — when locking a whole subtree —
            # any existing descendant lock
            if self._covering_locked(path) is not None:
                return None
            if depth == "infinity":
                prefix = path.rstrip("/") + "/"
                if any(
                    p.startswith(prefix) for p in self._locks
                ):
                    return None
            lk = DavLock(
                token=f"opaquelocktoken:{uuid.uuid4()}",
                path=path,
                owner=owner,
                expires=time.monotonic() + timeout,
                timeout=timeout,
                depth=depth,
            )
            self._locks[path] = lk
            return lk

    def refresh(self, path: str, token: str) -> DavLock | None:
        with self._mu:
            self._prune()
            lk = self._locks.get(_norm(path))
            if lk is None or lk.token != token:
                return None
            lk.expires = time.monotonic() + lk.timeout
            return lk

    def unlock(self, path: str, token: str) -> bool:
        with self._mu:
            self._prune()
            path = _norm(path)
            lk = self._locks.get(path)
            if lk is None or lk.token != token:
                return False
            del self._locks[path]
            return True


def _prop_xml(href: str, is_dir: bool, size: int, mtime: float) -> ET.Element:
    resp = ET.Element(f"{{{DAV}}}response")
    ET.SubElement(resp, f"{{{DAV}}}href").text = urllib.parse.quote(href)
    propstat = ET.SubElement(resp, f"{{{DAV}}}propstat")
    prop = ET.SubElement(propstat, f"{{{DAV}}}prop")
    rtype = ET.SubElement(prop, f"{{{DAV}}}resourcetype")
    if is_dir:
        ET.SubElement(rtype, f"{{{DAV}}}collection")
    else:
        ET.SubElement(
            prop, f"{{{DAV}}}getcontentlength"
        ).text = str(size)
    ET.SubElement(
        prop, f"{{{DAV}}}getlastmodified"
    ).text = formatdate(mtime, usegmt=True)
    # advertise class-2 locking per resource
    sup = ET.SubElement(prop, f"{{{DAV}}}supportedlock")
    entry = ET.SubElement(sup, f"{{{DAV}}}lockentry")
    scope = ET.SubElement(entry, f"{{{DAV}}}lockscope")
    ET.SubElement(scope, f"{{{DAV}}}exclusive")
    ltype = ET.SubElement(entry, f"{{{DAV}}}locktype")
    ET.SubElement(ltype, f"{{{DAV}}}write")
    ET.SubElement(
        propstat, f"{{{DAV}}}status"
    ).text = "HTTP/1.1 200 OK"
    return resp


class WebDavServer:
    def __init__(
        self, filer_url: str, host: str = "127.0.0.1", port: int = 0,
        ssl_context=None,
    ):
        self.filer_url = filer_url
        self.locks = LockManager()
        # ephemeral dead-property store for PROPPATCH (x/net/webdav
        # keeps these in its in-memory prop store too)
        self._props: dict[str, dict[str, str]] = {}
        router = Router()
        router.add("*", r"/.*", self._dispatch)
        self.server = http.HttpServer(
            router, host, port, ssl_context=ssl_context
        )
        # BaseHTTPRequestHandler needs do_<METHOD>; register extras
        handler_cls = self.server._httpd.RequestHandlerClass
        for method in (
            "PROPFIND", "MKCOL", "MOVE", "COPY", "OPTIONS",
            "LOCK", "UNLOCK", "PROPPATCH",
        ):
            setattr(handler_cls, f"do_{method}", handler_cls.do_GET)

    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    def _req_tokens(self, req: Request) -> list[str]:
        """Lock tokens presented in If / Lock-Token headers."""
        blob = (
            req.headers.get("If", "")
            + " "
            + req.headers.get("Lock-Token", "")
        )
        return re.findall(r"opaquelocktoken:[0-9a-fA-F-]+", blob)

    def _check_lock(self, req: Request, *paths: str) -> Response | None:
        """423 Locked unless the request presents the tokens of every
        lock affecting the paths — covering ancestor locks AND locks
        held on descendants (a collection delete/move touches those
        too, RFC 4918 §6/§7/§9.6)."""
        tokens = set(self._req_tokens(req))
        for path in paths:
            affected = []
            if (lk := self.locks.covering(path)) is not None:
                affected.append(lk)
            affected.extend(self.locks.descendants(path))
            for lk in affected:
                if lk.token not in tokens:
                    return Response(
                        status=423,
                        body=b"<?xml version=\"1.0\"?><D:error "
                        b"xmlns:D=\"DAV:\"><D:lock-token-submitted/>"
                        b"</D:error>",
                        headers={"Content-Type": "application/xml"},
                    )
        return None

    def _dispatch(self, req: Request) -> Response:
        path = urllib.parse.unquote(req.path)
        method = req.method
        if method == "OPTIONS":
            return Response(
                status=200,
                headers={
                    "DAV": "1,2",
                    "Allow": "OPTIONS, PROPFIND, PROPPATCH, GET, "
                    "HEAD, PUT, DELETE, MKCOL, MOVE, COPY, LOCK, "
                    "UNLOCK",
                },
            )
        if method == "LOCK":
            return self._lock(req, path)
        if method == "UNLOCK":
            return self._unlock(req, path)
        if method == "PROPPATCH":
            return self._proppatch(req, path)
        if method in ("PUT", "DELETE", "MKCOL", "MOVE", "COPY"):
            # locks are WRITE locks: COPY only reads its source, so
            # just the destination needs a token (RFC 4918 §7)
            affected = [] if method == "COPY" else [path]
            if method in ("MOVE", "COPY"):
                dest = urllib.parse.unquote(
                    urllib.parse.urlsplit(
                        req.headers.get("Destination", "")
                    ).path
                )
                if dest:
                    affected.append(dest)
            if locked := self._check_lock(req, *affected):
                return locked
        if method == "PROPFIND":
            return self._propfind(req, path)
        if method in ("GET", "HEAD"):
            try:
                body = http.request(
                    method, f"{self.filer_url}{path}"
                )
            except http.HttpError as e:
                return Response(status=e.status or 502)
            return Response(status=200, body=body)
        if method == "PUT":
            http.request(
                "POST", f"{self.filer_url}{path}", req.body,
                {"Content-Type": req.headers.get(
                    "Content-Type", "application/octet-stream")},
            )
            return Response(status=201)
        if method == "DELETE":
            try:
                http.request(
                    "DELETE",
                    f"{self.filer_url}{path}?recursive=true",
                )
            except http.HttpError as e:
                return Response(status=e.status or 502)
            return Response(status=204)
        if method == "MKCOL":
            http.request(
                "POST", f"{self.filer_url}{path.rstrip('/')}/", b""
            )
            return Response(status=201)
        if method in ("MOVE", "COPY"):
            dest = req.headers.get("Destination", "")
            dest_path = urllib.parse.unquote(
                urllib.parse.urlsplit(dest).path
            )
            if not dest_path:
                return Response(status=400)
            if method == "MOVE":
                http.request(
                    "POST",
                    f"{self.filer_url}{dest_path}"
                    f"?mv.from={urllib.parse.quote(path)}",
                    b"",
                )
            else:
                body = http.request(
                    "GET", f"{self.filer_url}{path}"
                )
                http.request(
                    "POST", f"{self.filer_url}{dest_path}", body
                )
            return Response(status=201)
        return Response(status=405)

    @staticmethod
    def _parse_timeout(header: str) -> float:
        for part in header.split(","):
            part = part.strip()
            if part.lower().startswith("second-"):
                try:
                    return min(
                        float(part[len("second-"):]),
                        _MAX_LOCK_TIMEOUT,
                    )
                except ValueError:
                    pass
        return _DEFAULT_LOCK_TIMEOUT

    @staticmethod
    def _lockdiscovery_xml(lk: DavLock) -> bytes:
        root = ET.Element(f"{{{DAV}}}prop")
        disc = ET.SubElement(root, f"{{{DAV}}}lockdiscovery")
        active = ET.SubElement(disc, f"{{{DAV}}}activelock")
        scope = ET.SubElement(active, f"{{{DAV}}}lockscope")
        ET.SubElement(scope, f"{{{DAV}}}exclusive")
        ltype = ET.SubElement(active, f"{{{DAV}}}locktype")
        ET.SubElement(ltype, f"{{{DAV}}}write")
        ET.SubElement(active, f"{{{DAV}}}depth").text = lk.depth
        if lk.owner:
            ET.SubElement(active, f"{{{DAV}}}owner").text = lk.owner
        ET.SubElement(
            active, f"{{{DAV}}}timeout"
        ).text = f"Second-{int(lk.timeout)}"
        tok = ET.SubElement(active, f"{{{DAV}}}locktoken")
        ET.SubElement(tok, f"{{{DAV}}}href").text = lk.token
        return (
            b'<?xml version="1.0" encoding="utf-8"?>'
            + ET.tostring(root)
        )

    def _lock(self, req: Request, path: str) -> Response:
        timeout = self._parse_timeout(req.headers.get("Timeout", ""))
        depth = req.headers.get("Depth", "infinity")
        body = req.body
        if not body.strip():
            # refresh: LOCK with an If token and no lockinfo body
            tokens = self._req_tokens(req)
            lk = tokens and self.locks.refresh(path, tokens[0])
            if not lk:
                return Response(status=412)
            return Response(
                status=200,
                body=self._lockdiscovery_xml(lk),
                headers={"Content-Type": "application/xml"},
            )
        owner = ""
        try:
            root = ET.fromstring(body)
            o = root.find(f"{{{DAV}}}owner")
            if o is not None:
                owner = "".join(o.itertext()).strip() or (
                    o[0].text or "" if len(o) else ""
                )
        except ET.ParseError:
            return Response(status=400)
        lk = self.locks.lock(path, owner, timeout, depth)
        if lk is None:
            return Response(status=423)
        # RFC 4918 §7.3: LOCK on an unmapped URL creates an empty
        # resource under the lock (existence probed with HEAD — a GET
        # would download the whole body just to learn it exists)
        try:
            http.request("HEAD", f"{self.filer_url}{path}")
        except http.HttpError:
            try:
                http.request("POST", f"{self.filer_url}{path}", b"")
                created = True
            except http.HttpError:
                created = False
        else:
            created = False
        return Response(
            status=201 if created else 200,
            body=self._lockdiscovery_xml(lk),
            headers={
                "Content-Type": "application/xml",
                "Lock-Token": f"<{lk.token}>",
            },
        )

    def _unlock(self, req: Request, path: str) -> Response:
        tokens = self._req_tokens(req)
        if not tokens:
            return Response(status=400)
        if not self.locks.unlock(path, tokens[0]):
            return Response(status=409)
        return Response(status=204)

    def _proppatch(self, req: Request, path: str) -> Response:
        """Accept property updates, store dead properties in memory,
        and answer 207 per property (what Finder/Office need to
        proceed with saves)."""
        try:
            root = ET.fromstring(req.body or b"")
        except ET.ParseError:
            return Response(status=400)
        store = self._props.setdefault(path, {})
        names: list[str] = []
        for setel in root:
            tag = setel.tag.rsplit("}", 1)[-1]
            if tag not in ("set", "remove"):
                continue
            prop = setel.find(f"{{{DAV}}}prop")
            if prop is None:
                continue
            for p in prop:
                names.append(p.tag)
                if tag == "set":
                    store[p.tag] = p.text or ""
                else:
                    store.pop(p.tag, None)
        multi = ET.Element(f"{{{DAV}}}multistatus")
        resp = ET.SubElement(multi, f"{{{DAV}}}response")
        ET.SubElement(
            resp, f"{{{DAV}}}href"
        ).text = urllib.parse.quote(path)
        for name in names or [f"{{{DAV}}}displayname"]:
            ps = ET.SubElement(resp, f"{{{DAV}}}propstat")
            prop = ET.SubElement(ps, f"{{{DAV}}}prop")
            ET.SubElement(prop, name)
            ET.SubElement(
                ps, f"{{{DAV}}}status"
            ).text = "HTTP/1.1 200 OK"
        return Response(
            status=207,
            body=b'<?xml version="1.0" encoding="utf-8"?>'
            + ET.tostring(multi),
            headers={"Content-Type": "application/xml"},
        )

    def _propfind(self, req: Request, path: str) -> Response:
        depth = req.headers.get("Depth", "1")
        multi = ET.Element(f"{{{DAV}}}multistatus")
        # the entry itself
        try:
            listing = http.get_json(
                f"{self.filer_url}{path.rstrip('/') or '/'}"
                f"/?limit=1000"
            )
            # a FILE path answers the listing URL with its raw
            # content, which json-parses for json files or raises —
            # only a dict with Entries is a directory listing
            is_dir = (
                isinstance(listing, dict) and "Entries" in listing
            )
        except (http.HttpError, ValueError):
            listing = None
            is_dir = False
        if is_dir and listing is not None and "Entries" in listing:
            multi.append(_prop_xml(path.rstrip("/") + "/", True, 0, 0))
            if depth != "0":
                for e in listing["Entries"] or []:
                    multi.append(
                        _prop_xml(
                            e["FullPath"]
                            + ("/" if e["IsDirectory"] else ""),
                            e["IsDirectory"],
                            e.get("FileSize", 0),
                            e.get("Mtime", 0),
                        )
                    )
        else:
            # a file?
            try:
                body = http.request(
                    "GET", f"{self.filer_url}{path}"
                )
            except http.HttpError:
                return Response(status=404)
            multi.append(_prop_xml(path, False, len(body), 0))
        out = b'<?xml version="1.0" encoding="utf-8"?>' + ET.tostring(
            multi
        )
        return Response(
            status=207,
            body=out,
            headers={"Content-Type": "application/xml"},
        )
