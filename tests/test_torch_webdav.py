"""The port's WebDAV gateway (``server/webdav.py``) held against the
reference's on the CPU.

One request sequence (OPTIONS, MKCOL, PUT, GET, PROPFIND, MOVE, COPY,
LOCK and its conflicts, refresh and tokens, PROPPATCH, UNLOCK, DELETE)
goes to each package's gateway over its own filer and cluster: the same
status codes, the same headers that carry meaning and the same bodies,
with exactly the wall-clock and random parts masked (``getlastmodified``
dates and the ``uuid`` of each lock token). ``LockManager``'s tree
semantics are equal step for step.
"""

import re
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.server import webdav as ref_webdav  # noqa: E402
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefHarness,
)
from seaweedfs_tpu_torch.server import webdav as port_webdav  # noqa: E402
from seaweedfs_tpu_torch.server.harness import (  # noqa: E402
    ClusterHarness as PortHarness,
)

torch.set_num_threads(2)

TOKEN_RE = re.compile(rb"opaquelocktoken:[0-9a-fA-F-]+")
DATE_RE = re.compile(rb"(getlastmodified>)[^<]*(<)")
KEPT_HEADERS = ("DAV", "Allow", "Content-Type", "Lock-Token")
LOCKINFO = (
    b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
    b"<D:lockscope><D:exclusive/></D:lockscope>"
    b"<D:locktype><D:write/></D:locktype>"
    b"<D:owner>tester</D:owner></D:lockinfo>"
)
PROPPATCH = (
    b'<?xml version="1.0"?>'
    b'<D:propertyupdate xmlns:D="DAV:" xmlns:Z="urn:x">'
    b"<D:set><D:prop><Z:Win32FileAttributes>00000020"
    b"</Z:Win32FileAttributes></D:prop></D:set>"
    b"<D:remove><D:prop><Z:Gone/></D:prop></D:remove>"
    b"</D:propertyupdate>"
)


def _mask(data: bytes, tokens: dict) -> bytes:
    """Lock tokens become their order of appearance; dates a mark."""
    def label(m):
        return b"opaquelocktoken:<%d>" % tokens.setdefault(
            m.group(0), len(tokens))

    return DATE_RE.sub(rb"\1<date>\2", TOKEN_RE.sub(label, data))


def _sequence(base: str) -> list:
    """Every answer of one request sequence, masked."""
    tokens: dict = {}
    out = []

    def req(method, path, body=b"", **headers):
        r = urllib.request.Request(base + path, data=body, method=method,
                                   headers=headers)
        try:
            with urllib.request.urlopen(r, timeout=15) as resp:
                st, hdrs, got = resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as e:
            st, hdrs, got = e.code, e.headers, e.read()
        kept = {h: _mask(hdrs[h].encode(), tokens).decode()
                for h in KEPT_HEADERS if hdrs.get(h) is not None}
        out.append((method, path, st, kept, _mask(got, tokens)))
        return hdrs

    def token():
        return next(t for t in reversed(list(tokens)))

    req("OPTIONS", "/")
    req("MKCOL", "/davdir")
    req("PUT", "/davdir/a.txt", b"dav content")
    req("PUT", "/davdir/sub/deep.bin", bytes(range(256)) * 9)
    req("GET", "/davdir/a.txt")
    req("PROPFIND", "/davdir", Depth="1")
    req("PROPFIND", "/davdir", Depth="0")
    req("PROPFIND", "/davdir/a.txt", Depth="0")
    req("PROPFIND", "/nowhere")
    req("MOVE", "/davdir/a.txt",
        Destination=base + "/davdir/b.txt")
    req("COPY", "/davdir/b.txt",
        Destination=base + "/davdir/c.txt")
    req("GET", "/davdir/a.txt")
    req("GET", "/davdir/c.txt")
    req("MOVE", "/davdir/c.txt")  # no Destination
    # class-2 locking: create under a lock, conflicts, If token, refresh
    req("LOCK", "/locked.txt", LOCKINFO, Timeout="Second-60")
    held = token()
    req("LOCK", "/locked.txt", LOCKINFO)
    req("PUT", "/locked.txt", b"nope")
    req("PUT", "/locked.txt", b"locked write", If=f"(<{held.decode()}>)")
    req("GET", "/locked.txt")
    req("LOCK", "/locked.txt", b"", If=f"(<{held.decode()}>)",
        Timeout="Second-120")
    req("LOCK", "/locked.txt", b"",
        If="(<opaquelocktoken:00000000-0000-0000-0000-000000000000>)")
    req("LOCK", "/bad.txt", b"<not xml")
    req("UNLOCK", "/locked.txt", b"", **{
        "Lock-Token":
            "<opaquelocktoken:00000000-0000-0000-0000-000000000000>"})
    req("UNLOCK", "/locked.txt")
    req("PROPPATCH", "/locked.txt", PROPPATCH)
    req("PROPPATCH", "/locked.txt", b"<broken")
    req("UNLOCK", "/locked.txt", b"", **{"Lock-Token": f"<{held.decode()}>"})
    req("PUT", "/locked.txt", b"free")
    # a depth-infinity lock on a collection guards its members
    req("LOCK", "/davdir/", LOCKINFO, Depth="infinity",
        Timeout="Second-3600")
    tree = token()
    req("LOCK", "/davdir/b.txt", LOCKINFO, Depth="0")
    req("DELETE", "/davdir/b.txt")
    req("COPY", "/locked.txt", Destination=base + "/davdir/d.txt")
    req("COPY", "/locked.txt", Destination=base + "/davdir/d.txt",
        If=f"(<{tree.decode()}>)")
    req("DELETE", "/davdir/b.txt", If=f"(<{tree.decode()}>)")
    req("UNLOCK", "/davdir", b"", **{"Lock-Token": f"<{tree.decode()}>"})
    req("DELETE", "/davdir")
    req("GET", "/davdir/d.txt")
    req("DELETE", "/missing")
    return out


@pytest.fixture(scope="module")
def gateways(tmp_path_factory):
    root = tmp_path_factory.mktemp("webdav")
    with RefHarness(n_volume_servers=1, volumes_per_server=10,
                    root=str(root / "ref"), with_filer=True) as ref, \
            PortHarness(n_volume_servers=1, volumes_per_server=10,
                        root=str(root / "port"), device="cpu",
                        with_filer=True) as port:
        ref.wait_for_nodes(1)
        port.wait_for_nodes(1)
        daves = {"ref": ref_webdav.WebDavServer(ref.filer.url),
                 "port": port_webdav.WebDavServer(port.filer.url)}
        for d in daves.values():
            d.start()
        try:
            yield {name: f"http://{d.url}" for name, d in daves.items()}
        finally:
            for d in daves.values():
                d.stop()


def test_request_sequence_matches_reference(gateways):
    got = {name: _sequence(base) for name, base in gateways.items()}
    assert [a[:3] for a in got["port"]] == [a[:3] for a in got["ref"]]
    for port, ref in zip(got["port"], got["ref"]):
        assert port == ref, port[:2]
    by_step = [(m, p, st) for m, p, st, _h, _b in got["port"]]
    # the sequence did what it says: the locks bit, the tokens opened
    assert ("LOCK", "/locked.txt", 201) in by_step
    assert by_step.count(("PUT", "/locked.txt", 423)) == 1
    assert ("PROPPATCH", "/locked.txt", 207) in by_step
    assert ("DELETE", "/davdir", 204) in by_step
    assert ("GET", "/davdir/d.txt", 404) in by_step
    gets = {(m, p): body for m, p, st, _h, body in got["port"]
            if m == "GET" and st == 200}
    assert gets[("GET", "/davdir/c.txt")] == b"dav content"
    assert gets[("GET", "/locked.txt")] == b"locked write"


def _tree(mod):
    """The reference test's LockManager steps, tokens as labels."""
    lm = mod.LockManager()
    names = {}

    def tok(lk):
        return None if lk is None else names.setdefault(lk.token,
                                                        len(names))

    out = []
    tree = lm.lock("/dir/", "A", 60, "infinity")
    out.append(tok(tree))
    out.append(tok(lm.lock("/dir/file.txt", "B", 60, "0")))
    out.append(tok(lm.covering("/dir/file.txt")))
    out.append(tok(lm.covering("/dir")))
    out.append(tok(lm.covering("/other")))
    out.append(lm.unlock("/dir", "opaquelocktoken:nope"))
    out.append(lm.unlock("/dir", tree.token))
    child = lm.lock("/dir/file.txt", "B", 60, "0")
    out.append(tok(child))
    out.append(tok(lm.lock("/dir", "A", 60, "infinity")))
    out.append(tok(lm.lock("/dir/other.txt", "C", 60, "0")))
    out.append(sorted(tok(lk) for lk in lm.descendants("/dir")))
    out.append(tok(lm.refresh("/dir/file.txt", child.token)))
    out.append(tok(lm.refresh("/dir/file.txt", "opaquelocktoken:x")))
    out.append(tok(lm.lock("/", "R", 60, "0")))
    out.append(tok(lm.lock("/dir/file.txt/", "D", 60, "0")))
    out.append(tok(lm.lock("/gone", "E", 0.0, "0")))
    out.append(tok(lm.lock("/gone", "F", 60, "0")))
    out.append((mod._norm("/a/b/"), mod._norm("/"), mod._norm("")))
    out.append([mod.WebDavServer._parse_timeout(h) for h in (
        "Second-60", "Infinite, Second-10", "Second-999999", "x", "")])
    return out


def test_lock_manager_tree_semantics_match_reference():
    got = _tree(port_webdav)
    assert got == _tree(ref_webdav)
    assert got[1] is None and got[2] == got[3] == got[0]
    assert got[8] is None and got[9] is not None
