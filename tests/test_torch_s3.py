"""The port's S3 gateway (``s3/s3api.py``) held against the reference's
on the CPU.

(a) One request sequence, every request sigv4-signed (the identities
    static) — bucket CRUD, put/get/head/copy/delete with user metadata,
    ranged GETs (closed, suffix, open-ended, unsatisfiable), list v1 and
    v2 with prefix, delimiter, max-keys and continuation, multipart
    with list-parts, list-uploads and abort, tagging, delete-multiple,
    a post-policy form upload, an identity held to its actions, a bad
    signature and anonymous access denied — goes to a gateway over its
    own filer of each package, and to the two mixed stacks (the port's
    gateway over a reference filer, and the reverse). Statuses, the
    kept headers and the bodies are equal after masking upload ids,
    ``LastModified``/``CreationDate``, ``Last-Modified`` and the filer
    URLs inside error messages.
(b) An object whose volume is EC-encoded with shards {0, 5, 11, 13}
    lost, read byte-exact through the port's gateway over a port filer
    restarted over its sqlite store, on port volume servers.
(c) The ``SeaweedFS_s3_request_total`` family and the gateway's spans
    under component ``s3`` after one request sequence, each package in
    a fresh interpreter (``tests/_torch_s3_child.py``): the span
    histograms and the registry are process-wide.
"""

import base64
import datetime as dt
import hashlib
import hmac
import http.client
import json
import os
import re
import subprocess
import sys
import time
import urllib.parse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.s3 import S3ApiServer as RefS3  # noqa: E402
from seaweedfs_tpu.s3.auth import Identity as RefIdentity  # noqa: E402
from seaweedfs_tpu.server.filer import (  # noqa: E402
    FilerServer as RefFilerServer,
)
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefClusterHarness,
)
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.filer import SqliteStore  # noqa: E402
from seaweedfs_tpu_torch.s3 import S3ApiServer as PortS3  # noqa: E402
from seaweedfs_tpu_torch.s3.auth import (  # noqa: E402
    Identity,
    _signing_key,
    sign_request_v4,
)
from seaweedfs_tpu_torch.server.filer import FilerServer  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.shell import CommandEnv, run_command  # noqa: E402
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = (("alice", "AKALICE", "alice-secret", ["Admin"]),
        ("bob", "AKBOB", "bob-secret", ["Read", "Write:b1", "List"]))
ALICE, BOB = (Identity(*k) for k in KEYS)
GATEWAYS = {"ref": (RefS3, RefIdentity), "port": (PortS3, Identity)}
FILERS = {"ref": RefFilerServer, "port": FilerServer}


def _reset_clients():
    for op, retry in ((port_operation, port_retry),
                      (ref_operation, ref_retry)):
        op.client._lookup_cache.clear()
        retry.BREAKERS.reset()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """A reference cluster and a port one (``device="cpu"``)."""
    root = tmp_path_factory.mktemp("s3")
    _reset_clients()
    with RefClusterHarness(n_volume_servers=2, volumes_per_server=40,
                           root=str(root / "ref")) as ref, \
            ClusterHarness(n_volume_servers=2, volumes_per_server=40,
                           root=str(root / "port"), device="cpu") as port:
        ref.wait_for_nodes(2)
        port.wait_for_nodes(2)
        yield {"ref": ref, "port": port}
    _reset_clients()


def call(url, method, path, query=None, body=b"", headers=None,
         ident=ALICE):
    """(status, headers, body) of one request, sigv4-signed by
    ``ident`` unless it is None."""
    host = url.split("//")[-1]
    query = query or {}
    h = dict(headers or {})
    if ident is not None:
        amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        h.update({"Host": host, "X-Amz-Date": amz,
                  "X-Amz-Content-Sha256": hashlib.sha256(body).hexdigest()})
        h["Authorization"] = sign_request_v4(
            ident, method, path, {k: [v] for k, v in query.items()}, h,
            body, amz)
    target = path + ("?" + urllib.parse.urlencode(query) if query else "")
    conn = http.client.HTTPConnection(host, timeout=60)
    try:
        conn.request(method, target, body=body or None, headers=h)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


KEPT = ("ETag", "Content-Type", "Content-Range", "Content-Length",
        "Accept-Ranges", "Last-Modified")


def _record(resp, masks):
    status, headers, body = resp
    kept = {k: v for k, v in headers.items()
            if k in KEPT or k.lower().startswith(("x-amz-meta-",
                                                  "x-amz-tagging"))}
    if "Last-Modified" in kept:
        kept["Last-Modified"] = "<t>"
    body = re.sub(rb"<(LastModified|CreationDate)>[^<]*</\1>",
                  rb"<\1>&lt;t&gt;</\1>", body)
    for real, name in masks.items():
        body = body.replace(real.encode(), name.encode())
        kept = {k: v.replace(real, name) for k, v in kept.items()}
    if masks and b"<Code>InternalError</Code>" in body:
        # the filer's own error text names chunk fids and ports
        body = re.sub(rb"<Message>.*</Message>", b"<Message/>", body)
    if kept.get("Content-Type", "").startswith("application/xml"):
        kept.pop("Content-Length", None)  # set by the masked values
    return status, kept, body


def _post_policy(url, key_field, data, conditions, expire_s=600):
    amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    cred = f"{ALICE.access_key}/{amz[:8]}/us-east-1/s3/aws4_request"
    exp = (dt.datetime.now(dt.timezone.utc) + dt.timedelta(
        seconds=expire_s)).strftime("%Y-%m-%dT%H:%M:%S.000Z")
    policy = base64.b64encode(json.dumps(
        {"expiration": exp, "conditions": conditions}).encode()).decode()
    key = _signing_key(ALICE.secret_key, amz[:8], "us-east-1", "s3")
    fields = [("key", key_field), ("x-amz-algorithm", "AWS4-HMAC-SHA256"),
              ("x-amz-credential", cred), ("x-amz-date", amz),
              ("policy", policy), ("x-amz-signature", hmac.new(
                  key, policy.encode(), hashlib.sha256).hexdigest()),
              ("success_action_status", "201")]
    b = "policyboundary42"
    body = b"".join(
        f"--{b}\r\nContent-Disposition: form-data; name=\"{n}\"\r\n\r\n"
        f"{v}\r\n".encode() for n, v in fields)
    body += (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
             "filename=\"f.bin\"\r\nContent-Type: application/octet-stream"
             "\r\n\r\n").encode() + data + f"\r\n--{b}--\r\n".encode()
    return call(url, "POST", "/b1", body=body, ident=None, headers={
        "Content-Type": f"multipart/form-data; boundary={b}"})


def _sequence(s3, masks):
    """The request sequence against gateway URL ``s3``: a list of
    (label, status, kept headers, masked body)."""
    rng = np.random.default_rng(23)
    big = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    parts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (5000, 5000, 123)]
    out = []

    def step(label, *a, **kw):
        resp = call(s3, *a, **kw)
        out.append((label,) + _record(resp, masks))
        return resp

    step("anonymous list", "GET", "/", ident=None)
    step("create b1", "PUT", "/b1")
    step("create b2", "PUT", "/b2")
    step("create b1 again", "PUT", "/b1")
    step("list buckets", "GET", "/")
    step("head b1", "HEAD", "/b1")
    step("head missing bucket", "HEAD", "/nope")
    step("put hello", "PUT", "/b1/dir/hello.txt", body=b"hello s3",
         headers={"Content-Type": "text/plain",
                  "x-amz-meta-color": "red"})
    step("get hello", "GET", "/b1/dir/hello.txt")
    step("head hello", "HEAD", "/b1/dir/hello.txt")
    step("put big", "PUT", "/b1/big.bin", body=big)
    for rng_h in ("bytes=0-99", "bytes=2000-4999", "bytes=-500",
                  "bytes=9990-", "bytes=20000-30000"):
        step(f"range {rng_h}", "GET", "/b1/big.bin",
             headers={"Range": rng_h})
    step("copy", "PUT", "/b1/copy.txt",
         headers={"X-Amz-Copy-Source": "/b1/dir/hello.txt"})
    step("get copy", "GET", "/b1/copy.txt")
    step("copy missing source", "PUT", "/b1/copy2.txt",
         headers={"X-Amz-Copy-Source": "/b1/no/such"})
    tags = (b"<Tagging><TagSet><Tag><Key>k1</Key><Value>v1</Value></Tag>"
            b"<Tag><Key>k2</Key><Value>v 2</Value></Tag></TagSet>"
            b"</Tagging>")
    step("put tagging", "PUT", "/b1/dir/hello.txt", {"tagging": ""}, tags)
    step("get tagging", "GET", "/b1/dir/hello.txt", {"tagging": ""})
    step("delete tagging", "DELETE", "/b1/dir/hello.txt", {"tagging": ""})
    step("get tagging after", "GET", "/b1/dir/hello.txt", {"tagging": ""})
    for key in ("a/1.txt", "a/2.txt", "a/b/4.txt", "b/3.txt", "top.txt"):
        step(f"put {key}", "PUT", f"/b2/{key}", body=key.encode() * 3)
    for label, q in (
            ("list v1", {}),
            ("list v2 delimiter", {"list-type": "2", "delimiter": "/"}),
            ("list v1 prefix", {"prefix": "a/"}),
            ("list v2 prefix delimiter", {"list-type": "2", "prefix": "a/",
                                          "delimiter": "/"}),
            ("list v2 max-keys", {"list-type": "2", "max-keys": "2"}),
            ("list v2 continuation", {"list-type": "2", "max-keys": "2",
                                      "continuation-token": "a/2.txt"}),
            ("list v1 marker", {"marker": "a/b/4.txt"}),
            ("list v2 start-after", {"list-type": "2",
                                     "start-after": "b/3.txt"})):
        step(label, "GET", "/b2", q)
    # multipart, completed
    status, _, body = step("initiate", "POST", "/b1/mp.bin",
                           {"uploads": ""})
    upload = re.search(rb"<UploadId>([0-9a-f]+)</UploadId>",
                       body).group(1).decode()
    masks[upload] = "<upload>"
    out[-1] = ("initiate",) + _record((status, {}, body), masks)
    for i, part in enumerate(parts, 1):
        step(f"part {i}", "PUT", "/b1/mp.bin",
             {"partNumber": str(i), "uploadId": upload}, part)
    step("list parts", "GET", "/b1/mp.bin", {"uploadId": upload})
    step("list uploads", "GET", "/b1", {"uploads": ""})
    step("complete", "POST", "/b1/mp.bin", {"uploadId": upload},
         b"<CompleteMultipartUpload/>")
    step("get multipart", "GET", "/b1/mp.bin")
    # multipart, aborted
    status, _, body = call(s3, "POST", "/b1/ab.bin", {"uploads": ""})
    aborted = re.search(rb"<UploadId>([0-9a-f]+)</UploadId>",
                        body).group(1).decode()
    masks[aborted] = "<aborted>"
    out.append(("initiate again",) + _record((status, {}, body), masks))
    step("part of aborted", "PUT", "/b1/ab.bin",
         {"partNumber": "1", "uploadId": aborted}, b"zz")
    step("abort", "DELETE", "/b1/ab.bin", {"uploadId": aborted})
    step("list uploads after abort", "GET", "/b1", {"uploads": ""})
    # delete-multiple
    step("delete multiple", "POST", "/b2", {"delete": ""},
         b"<Delete><Object><Key>a/1.txt</Key></Object><Object><Key>nope"
         b"</Key></Object></Delete>")
    step("list after delete multiple", "GET", "/b2", {"list-type": "2"})
    # post-policy form upload
    conds = [{"bucket": "b1"}, ["starts-with", "$key", "up/"],
             ["content-length-range", 1, 10_000],
             ["starts-with", "$x-amz-credential", ""],
             {"x-amz-algorithm": "AWS4-HMAC-SHA256"},
             ["starts-with", "$x-amz-date", ""],
             ["eq", "$success_action_status", "201"]]
    out.append(("post policy",) + _record(_post_policy(
        s3, "up/${filename}", b"form bytes!", conds), masks))
    step("get posted", "GET", "/b1/up/f.bin")
    out.append(("post policy off prefix",) + _record(_post_policy(
        s3, "down/x.bin", b"nope", conds), masks))
    out.append(("post policy expired",) + _record(_post_policy(
        s3, "up/y.bin", b"old", conds, expire_s=-60), masks))
    # an identity held to its actions, a bad signature
    step("bob reads b1", "GET", "/b1/dir/hello.txt", ident=BOB)
    step("bob writes b1", "PUT", "/b1/bob.txt", body=b"b", ident=BOB)
    step("bob writes b2", "PUT", "/b2/bob.txt", body=b"b", ident=BOB)
    step("bob creates a bucket", "PUT", "/b3", ident=BOB)
    step("bad signature", "GET", "/b1/dir/hello.txt",
         ident=Identity("alice", "AKALICE", "wrong"))
    step("unknown key", "GET", "/b1/dir/hello.txt",
         ident=Identity("eve", "AKEVE", "x"))
    # deletes
    step("delete hello", "DELETE", "/b1/dir/hello.txt")
    step("get deleted", "GET", "/b1/dir/hello.txt")
    step("delete missing", "DELETE", "/b1/never.txt")
    step("delete b2", "DELETE", "/b2")
    step("head b2 after", "HEAD", "/b2")
    step("list buckets after", "GET", "/")
    step("method not allowed", "POST", "/")
    return out


def _run(gw, filer, clusters):
    """The sequence through a gateway of package ``gw`` over a fresh
    filer of package ``filer`` on that package's cluster."""
    _reset_clients()
    c = clusters[filer]
    fs = FILERS[filer](c.master.url, chunk_size=2048, telemetry_interval=0)
    fs.start()
    gateway_cls, ident_cls = GATEWAYS[gw]
    s3 = gateway_cls(fs.url, identities=[ident_cls(*k) for k in KEYS])
    s3.start()
    try:
        masks = {fs.url: "<filer>", s3.url: "<s3>"}
        return _sequence(s3.url, masks)
    finally:
        s3.stop()
        fs.stop()
        _reset_clients()


@pytest.fixture(scope="module")
def reference_run(clusters):
    return _run("ref", "ref", clusters)


@pytest.mark.parametrize("stack", ["port", "port_gateway_ref_filer",
                                   "ref_gateway_port_filer"])
def test_request_sequence_matches_reference(stack, clusters,
                                            reference_run):
    gw, filer = {"port": ("port", "port"),
                 "port_gateway_ref_filer": ("port", "ref"),
                 "ref_gateway_port_filer": ("ref", "port")}[stack]
    got = _run(gw, filer, clusters)
    assert [s[0] for s in got] == [s[0] for s in reference_run]
    for have, want in zip(got, reference_run):
        assert have == want, have[0]  # the first step that differs
    out = {s[0]: s[1:] for s in got}
    # what the sequence shows, beyond agreeing
    assert out["anonymous list"][0] == 403
    assert out["get hello"][2] == b"hello s3"
    assert {k.lower(): v for k, v in out["get hello"][1].items()}[
        "x-amz-meta-color"] == "red"
    assert out["range bytes=2000-4999"][0] == 206
    assert out["range bytes=20000-30000"][0] == 416
    rng = np.random.default_rng(23)
    drawn = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (10_000, 5000, 5000, 123)]
    assert out["get multipart"][2] == b"".join(drawn[1:])
    assert b"<Key>k2</Key><Value>v 2</Value>" in out["get tagging"][2]
    assert out["post policy"][0] == 201
    assert out["get posted"][2] == b"form bytes!"
    assert out["bob writes b1"][0] == 200
    assert out["bob writes b2"][0] == out["bob creates a bucket"][0] == 403
    assert b"SignatureDoesNotMatch" in out["bad signature"][2]
    assert out["get deleted"][0] == 404


def test_degraded_ec_read_through_port_gateway(tmp_path):
    """Objects whose chunks sit in one EC-encoded volume with shards
    {0, 5, 11, 13} deleted read back byte-exact through the port's
    gateway over a port filer restarted over its sqlite store."""
    _reset_clients()
    rng = np.random.default_rng(29)
    objects = {f"o{i:02d}.bin": rng.integers(
        0, 256, 3000 + 4100 * i, dtype=np.uint8).tobytes()
        for i in range(8)}
    db = str(tmp_path / "filer.db")
    try:
        with ClusterHarness(n_volume_servers=4, volumes_per_server=10,
                            root=str(tmp_path / "c"), device="cpu") as c:
            c.wait_for_nodes(4)
            m = c.master.url
            fs = FilerServer(m, store=SqliteStore(db), chunk_size=4096,
                             collection="s3ec", telemetry_interval=0)
            fs.start()
            s3 = PortS3(fs.url, identities=[ALICE])
            s3.start()
            try:
                assert call(s3.url, "PUT", "/ecb")[0] == 200
                for key, data in objects.items():
                    assert call(s3.url, "PUT", f"/ecb/{key}",
                                body=data)[0] == 200
                vids = {}
                for key in objects:
                    meta = json.loads(port_http.request(
                        "GET", f"{fs.url}/buckets/ecb/{key}?meta=true"))
                    for ch in meta["chunks"]:
                        vids.setdefault(int(ch["file_id"].split(",")[0]),
                                        set()).add(key)
            finally:
                s3.stop()
                fs.stop()
            vid = max(vids, key=lambda v: len(vids[v]))
            env = CommandEnv(m)
            env.lock()
            try:
                out = run_command(
                    env, f"ec.encode -volumeId {vid} -collection s3ec")
            finally:
                env.unlock()
            assert f"volume {vid}: ec.encode done" in out
            c.settle(5)
            lost = {0, 5, 11, 13}
            shards = port_http.get_json(f"{m}/ec/lookup?volumeId={vid}")
            for sid, locs in shards["shards"].items():
                if int(sid) in lost:
                    for loc in locs:
                        port_http.post_json(
                            f"{loc['url']}/admin/ec/delete_shards",
                            {"volume": vid, "collection": "s3ec",
                             "shard_ids": [int(sid)]})
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                shards = port_http.get_json(
                    f"{m}/ec/lookup?volumeId={vid}")
                if not lost & {int(s) for s in shards["shards"]}:
                    break
                time.sleep(0.1)
            assert not lost & {int(s) for s in shards["shards"]}
            fs = FilerServer(m, store=SqliteStore(db), chunk_size=4096,
                             collection="s3ec", telemetry_interval=0)
            fs.start()
            s3 = PortS3(fs.url, identities=[ALICE])
            s3.start()
            try:
                assert vids[vid]
                for key, data in sorted(objects.items()):
                    status, _, got = call(s3.url, "GET", f"/ecb/{key}")
                    assert (status, got) == (200, data), key
                    status, _, got = call(s3.url, "GET", f"/ecb/{key}",
                                          headers={"Range": "bytes=100-"})
                    assert (status, got) == (206, data[100:]), key
            finally:
                s3.stop()
                fs.stop()
    finally:
        _reset_clients()


def test_s3_families_and_spans_match_reference(tmp_path):
    """``SeaweedFS_s3_request_total`` as each gateway's ``/metrics``
    exposes it, and the gateway's request spans by op, each package in a
    fresh interpreter."""
    got = {}
    for which in ("ref", "port"):
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "tests", "_torch_s3_child.py"),
             which, str(tmp_path / which)], cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got[which] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["port"] == got["ref"], (got["port"], got["ref"])
    assert got["port"]["family"][:2] == [
        "# HELP SeaweedFS_s3_request_total Counter of s3 requests.",
        "# TYPE SeaweedFS_s3_request_total counter"]
    spans = got["port"]["spans"]
    assert spans["PutObject"] == 3 and spans["GetObject"] == 2
    assert spans["CreateBucket"] == 1 and sum(spans.values()) == 9
