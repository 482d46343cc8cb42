"""The port's S3 authentication (``s3/auth.py``) held against the
reference's on the CPU.

For seeded sets of methods, paths, queries and headers: the V4 and V2
signatures, the presigned V2 and V4 URLs, ``decode_streaming_upload``
on aws-chunked bodies (good, a corrupt chunk signature, truncated, a
wrong declared length) and ``verify_post_policy`` on form fields (V4
and V2 policies, every condition kind) are equal between the packages;
``authenticate`` accepts or rejects each request the same way, with
the same error code, status and message — header V4 and V2, presigned
V2 and V4 (``X-Amz-Expires`` of 0 and 604801, a mismatched scope date,
an expired URL, a tampered signature), anonymous access and unknown
schemes. Presigned requests are signed at the current time: expiry
reads the wall clock.
"""

import base64
import datetime as dt
import hashlib
import hmac
import json
import random
import time
import urllib.parse

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu.s3 import auth as ref_auth  # noqa: E402
from seaweedfs_tpu_torch.s3 import auth as port_auth  # noqa: E402

torch.set_num_threads(2)

PKGS = {"ref": ref_auth, "port": port_auth}
SEEDS = range(8)
KEYS = (("alice", "AKALICE", "alice-secret", ["Admin"]),
        ("bob", "AKBOB", "bob/secret+key==", ["Read", "Write:b1"]))


def _idents(pkg, anonymous=False):
    out = [pkg.Identity(*k) for k in KEYS]
    if anonymous:
        out.append(pkg.Identity("anonymous", "", "", ["Read"]))
    return out


def _outcome(pkg, fn):
    try:
        got = fn()
    except pkg.AuthError as e:
        return ("err", e.code, e.status, e.message)
    return ("ok", getattr(got, "name", got))


def _amz(offset_s=0):
    return time.strftime("%Y%m%dT%H%M%SZ",
                         time.gmtime(time.time() + offset_s))


def _request(rng):
    """A seeded method, wire path, query and header set."""
    method = rng.choice(["GET", "PUT", "POST", "DELETE", "HEAD"])
    segs = [rng.choice(["b1", "my-bucket", "data"])]
    for _ in range(rng.randrange(0, 3)):
        segs.append(urllib.parse.quote(
            rng.choice(["a b.txt", "k~1", "x+y", "ü.bin", "dir", "o(1)"])))
    path = "/" + "/".join(segs)
    query = {}
    for name in rng.sample(["uploads", "uploadId", "partNumber", "prefix",
                            "list-type", "delimiter", "tagging", "acl",
                            "marker", "versionId"], rng.randrange(0, 4)):
        query[name] = [rng.choice(["", "2", "a/b", "x y", "1"])]
    headers = {"Host": f"127.0.0.1:{rng.randrange(1024, 65535)}",
               "X-Amz-Date": _amz()}
    if rng.random() < 0.5:
        headers["X-Amz-Content-Sha256"] = rng.choice(
            ["UNSIGNED-PAYLOAD", hashlib.sha256(b"x").hexdigest()])
    if rng.random() < 0.5:
        headers["Content-Type"] = rng.choice(["text/plain",
                                              "application/xml"])
    if rng.random() < 0.5:
        headers["x-amz-meta-Color"] = rng.choice(["red", "  blue  sky "])
    if rng.random() < 0.3:
        headers["Content-MD5"] = base64.b64encode(
            hashlib.md5(b"y").digest()).decode()
    if rng.random() < 0.3:
        headers["Date"] = "Tue, 27 Mar 2007 19:36:42 +0000"
    body = rng.randbytes(rng.randrange(0, 64))
    return method, path, query, headers, body


@pytest.mark.parametrize("seed", SEEDS)
def test_v4_and_v2_signatures_equal(seed):
    for i in range(25):
        got = {}
        amz = _amz()  # one clock reading for both packages
        for name, pkg in PKGS.items():
            rng = random.Random(seed * 1000 + i)
            method, path, query, headers, body = _request(rng)
            headers["X-Amz-Date"] = amz
            ident = pkg.Identity(*KEYS[i % 2])
            got[name] = (
                pkg.sign_request_v4(ident, method, path, query, headers,
                                    body, amz),
                pkg._signature_v4(ident.secret_key, method, path, query,
                                  headers, body,
                                  sorted(k.lower() for k in headers),
                                  amz, amz[:8], "eu-west-1", "s3"),
                pkg.sign_request_v2(ident, method, path, query, headers),
                pkg._string_to_sign_v2(method, path, query, headers),
            )
        assert got["port"] == got["ref"]


@pytest.mark.parametrize("seed", SEEDS)
def test_presigned_urls_equal(seed):
    for i in range(10):
        got = {}
        # one clock reading for both packages
        amz, expires = _amz(), int(time.time()) + 600
        for name, pkg in PKGS.items():
            rng = random.Random(seed * 1000 + i)
            method, path, query, headers, _ = _request(rng)
            ident = pkg.Identity(*KEYS[i % 2])
            got[name] = (
                pkg.presign_url_v2(ident, method, path, expires, query),
                pkg.presign_url_v4(ident, method, headers["Host"], path,
                                   amz, rng.randrange(1, 604801)),
            )
        assert got["port"] == got["ref"]


def _query_of(url):
    path, _, qs = url.partition("?")
    return path, urllib.parse.parse_qs(qs, keep_blank_values=True)


def _auth_cases(pkg):
    """(label, method, path, query, headers, body) requests for
    ``authenticate``, built with ``pkg``'s own signers."""
    alice = pkg.Identity(*KEYS[0])
    host = "127.0.0.1:8333"
    cases = []

    def v4(label, ident, mutate=None, method="PUT", path="/b1/k.txt",
           query=None, body=b"data"):
        amz = _amz()
        h = {"Host": host, "X-Amz-Date": amz,
             "X-Amz-Content-Sha256": hashlib.sha256(body).hexdigest()}
        h["Authorization"] = pkg.sign_request_v4(ident, method, path,
                                                 query or {}, h, body, amz)
        if mutate:
            mutate(h)
        cases.append((label, method, path, query or {}, h, body))

    v4("v4 ok", alice)
    v4("v4 ok with a query", alice, method="GET", path="/b1",
       query={"list-type": ["2"], "prefix": ["a/b"]}, body=b"")
    v4("v4 unknown key", pkg.Identity("eve", "AKEVE", "x"))
    v4("v4 wrong secret", pkg.Identity("alice", "AKALICE", "nope"))
    v4("v4 tampered body", alice,
       lambda h: h.update({"X-Amz-Content-Sha256": "0" * 64}))
    v4("v4 malformed header", alice,
       lambda h: h.update({"Authorization": "AWS4-HMAC-SHA256 Nonsense"}))
    v4("unsupported scheme", alice,
       lambda h: h.update({"Authorization": "Bearer token"}))
    cases.append(("anonymous", "GET", "/b1/k.txt", {}, {"Host": host}, b""))
    cases.append(("stray X-Amz-Signature", "GET", "/b1/k.txt",
                  {"X-Amz-Signature": ["00"]}, {"Host": host}, b""))
    # signature V2, header form
    for label, ident, date in (("v2 ok", alice, "Tue, 27 Mar 2007"),
                               ("v2 wrong secret",
                                pkg.Identity("alice", "AKALICE", "no"),
                                "Tue, 27 Mar 2007")):
        h = {"Host": host, "Date": date, "x-amz-meta-a": "1",
             "Content-Type": "text/plain"}
        h["Authorization"] = pkg.sign_request_v2(
            ident, "PUT", "/b1/k.txt", {"uploads": [""]}, h)
        cases.append((label, "PUT", "/b1/k.txt", {"uploads": [""]}, h,
                      b""))
    cases.append(("v2 malformed", "GET", "/b1/k", {},
                  {"Host": host, "Authorization": "AWS nocolon"}, b""))
    # signature V2, presigned
    for label, expires in (("v2 presigned ok", 600),
                           ("v2 presigned expired", -600)):
        path, q = _query_of(pkg.presign_url_v2(
            alice, "GET", "/b1/k.txt", int(time.time()) + expires))
        cases.append((label, "GET", path, q, {"Host": host}, b""))
    path, q = _query_of(pkg.presign_url_v2(alice, "GET", "/b1/k.txt",
                                           int(time.time()) + 600))
    q["Signature"] = ["AAAA" + q["Signature"][0][4:]]
    cases.append(("v2 presigned tampered", "GET", path, q, {"Host": host},
                  b""))
    # signature V4, presigned
    for label, amz, expires in (
            ("v4 presigned ok", _amz(), 600),
            ("v4 presigned expires 0", _amz(), 0),
            ("v4 presigned expires 604801", _amz(), 604801),
            ("v4 presigned expires 604800", _amz(), 604800),
            ("v4 presigned expired", _amz(-7200), 60)):
        path, q = _query_of(pkg.presign_url_v4(alice, "GET", host,
                                               "/b1/k.txt", amz, expires))
        cases.append((label, "GET", path, q, {"Host": host}, b""))
    path, q = _query_of(pkg.presign_url_v4(alice, "GET", host, "/b1/k.txt",
                                           _amz(), 600))
    sig = q["X-Amz-Signature"][0]
    tampered = dict(q, **{"X-Amz-Signature": ["0" + sig[1:]]})
    cases.append(("v4 presigned tampered", "GET", path, tampered,
                  {"Host": host}, b""))
    cred = q["X-Amz-Credential"][0].split("/")
    cred[1] = "19990101"
    mismatched = dict(q, **{"X-Amz-Credential": ["/".join(cred)]})
    cases.append(("v4 presigned scope date mismatch", "GET", path,
                  mismatched, {"Host": host}, b""))
    bad_alg = dict(q, **{"X-Amz-Algorithm": ["AWS4-HMAC-SHA1"]})
    cases.append(("v4 presigned algorithm", "GET", path, bad_alg,
                  {"Host": host}, b""))
    bad_expires = dict(q, **{"X-Amz-Expires": ["soon"]})
    cases.append(("v4 presigned malformed", "GET", path, bad_expires,
                  {"Host": host}, b""))
    return cases


@pytest.mark.parametrize("anonymous", [False, True],
                         ids=["no-anonymous", "anonymous-identity"])
def test_authenticate_accepts_and_rejects_alike(anonymous):
    got = {}
    for name, pkg in PKGS.items():
        iam = pkg.IdentityAccessManagement(_idents(pkg, anonymous))
        got[name] = [(label, _outcome(pkg, lambda c=c: iam.authenticate(
            *c[1:]))) for label, *c in
            [(case[0], *case) for case in _auth_cases(pkg)]]
    assert got["port"] == got["ref"]
    out = dict(got["port"])
    assert out["v4 ok"] == out["v2 ok"] == out["v4 presigned ok"] == (
        "ok", "alice")
    assert out["v4 presigned expires 604800"] == ("ok", "alice")
    for label in ("v4 presigned expires 0", "v4 presigned expires 604801",
                  "v4 presigned scope date mismatch"):
        assert out[label][1:3] == ("AuthorizationQueryParametersError",
                                   400), label
    assert out["v4 presigned expired"][1:3] == ("AccessDenied", 403)
    assert out["anonymous"] == (
        ("ok", "anonymous") if anonymous
        else ("err", "AccessDenied", 403, "anonymous access denied"))


def test_open_gateway_authenticates_nobody():
    for pkg in PKGS.values():
        iam = pkg.IdentityAccessManagement()
        assert not iam.is_enabled
        assert iam.authenticate("GET", "/b", {}, {}, b"") is None
        assert iam.verify_post_policy({}, "b", "k", 1) is None


def _streaming(pkg, payload, chunk, corrupt=None, declared=None,
               truncate=0, secret=None):
    """Headers and an aws-chunked body signed with ``pkg``'s helpers."""
    ident = pkg.Identity(*KEYS[0])
    amz = _amz()
    h = {"Host": "127.0.0.1:8333", "X-Amz-Date": amz,
         "X-Amz-Content-Sha256": pkg.STREAMING_PAYLOAD,
         "X-Amz-Decoded-Content-Length": str(
             len(payload) if declared is None else declared),
         "Content-Encoding": "aws-chunked"}
    h["Authorization"] = pkg.sign_request_v4(ident, "PUT", "/b1/s.bin", {},
                                             h, b"", amz)
    key = pkg._signing_key(secret or ident.secret_key, amz[:8],
                           "us-east-1", "s3")
    scope = f"{amz[:8]}/us-east-1/s3/aws4_request"
    empty = hashlib.sha256(b"").hexdigest()
    prev = h["Authorization"].rsplit("Signature=", 1)[1]
    body = b""
    for i, off in enumerate(list(range(0, len(payload), chunk)) + [None]):
        piece = b"" if off is None else payload[off:off + chunk]
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz, scope, prev,
                         empty, pkg._sha256(piece)])
        prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        sig = "0" * 64 if corrupt == i else prev
        body += f"{len(piece):x};chunk-signature={sig}\r\n".encode()
        body += piece + (b"\r\n" if piece else b"\r\n\r\n")
    return h, body[:len(body) - truncate]


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_decode_streaming_upload_equal(seed):
    rng = random.Random(seed)
    payload = rng.randbytes(rng.randrange(1, 300_000))
    chunk = rng.choice([1024, 65536, 100_000])
    variants = [{}, {"corrupt": 0}, {"corrupt": 1}, {"declared": 3},
                {"truncate": 40}, {"secret": "wrong"}]
    got = {}
    for name, pkg in PKGS.items():
        iam = pkg.IdentityAccessManagement(_idents(pkg))
        open_iam = pkg.IdentityAccessManagement()
        rows = []
        for v in variants:
            h, body = _streaming(pkg, payload, chunk, **v)
            rows.append(_outcome(pkg, lambda: iam.decode_streaming_upload(
                h, body)))
            rows.append(_outcome(pkg, lambda: open_iam
                                 .decode_streaming_upload(h, body)))
        rows.append(_outcome(pkg, lambda: iam.decode_streaming_upload(
            {"X-Amz-Content-Sha256": "UNSIGNED-PAYLOAD"}, b"x")))
        got[name] = rows
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("ok", payload)


def _policy_fields(pkg, conditions, expire_s=600, v2=False, sig=None,
                   extra=None):
    ident = pkg.Identity(*KEYS[0])
    amz = _amz()
    cred = f"{ident.access_key}/{amz[:8]}/us-east-1/s3/aws4_request"
    exp = (dt.datetime.now(dt.timezone.utc)
           + dt.timedelta(seconds=expire_s)).strftime(
        "%Y-%m-%dT%H:%M:%S.000Z")
    policy = base64.b64encode(json.dumps(
        {"expiration": exp, "conditions": conditions}).encode()).decode()
    if v2:
        fields = {"awsaccesskeyid": ident.access_key, "policy": policy,
                  "signature": sig or pkg._signature_v2(ident.secret_key,
                                                        policy)}
    else:
        key = pkg._signing_key(ident.secret_key, amz[:8], "us-east-1",
                               "s3")
        fields = {"x-amz-algorithm": "AWS4-HMAC-SHA256",
                  "x-amz-credential": cred, "x-amz-date": amz,
                  "policy": policy,
                  "x-amz-signature": sig or hmac.new(
                      key, policy.encode(), hashlib.sha256).hexdigest()}
    fields.update(extra or {})
    return fields


POLICIES = [
    # (conditions, key, length, options)
    ([{"bucket": "b1"}, ["starts-with", "$key", "up/"],
      ["content-length-range", 1, 100], {"x-amz-algorithm":
                                         "AWS4-HMAC-SHA256"},
      ["starts-with", "$x-amz-credential", ""],
      ["starts-with", "$x-amz-date", ""]], "up/a.bin", 10, {}),
    ([{"bucket": "b1"}, ["starts-with", "$key", "up/"]], "down/a", 10, {}),
    ([{"bucket": "b1"}, ["eq", "$key", "k"],
      ["content-length-range", 5, 9]], "k", 10, {}),
    ([{"bucket": "b1"}, ["eq", "$key", "k"],
      ["content-length-range", 5, 9]], "k", 1, {}),
    ([{"bucket": "b1"}, ["content-length-range", "x", 9]], "k", 1, {}),
    ([{"bucket": "b1"}, ["eq", "$key", "k"]], "k", 1, {}),
    ([{"bucket": "b1"}, ["in", "$key", "k"]], "k", 1, {}),
    ([{"bucket": "b1"}, "nonsense"], "k", 1, {}),
    ([{"bucket": "b2"}], "k", 1, {}),
    ([{"bucket": "b1"}, {"key": "k"}], "k", 1, {"expire_s": -60}),
    ([{"bucket": "b1"}, {"key": "k"}], "k", 1, {"sig": "0" * 64}),
    ([{"bucket": "b1"}, {"key": "k"}], "k", 1, {"v2": True}),
    ([{"bucket": "b1"}, {"key": "k"}], "k", 1, {"v2": True,
                                                "sig": "AAAA"}),
    ([{"bucket": "b1"}, {"key": "k"}], "k", 1,
     {"extra": {"x-ignore-me": "1", "content-type": "text/plain"}}),
    ([{"bucket": "b1"}, {"key": "k"}], "k", 1,
     {"extra": {"x-amz-algorithm": "AWS4-HMAC-SHA1"}}),
]


@pytest.mark.parametrize("case", range(len(POLICIES)))
def test_verify_post_policy_equal(case):
    conditions, key, length, opts = POLICIES[case]
    got = {}
    for name, pkg in PKGS.items():
        iam = pkg.IdentityAccessManagement(_idents(pkg))
        fields = _policy_fields(pkg, conditions, **opts)
        got[name] = _outcome(pkg, lambda: iam.verify_post_policy(
            fields, "b1", key, length))
    assert got["port"] == got["ref"]


def test_identity_allows_alike():
    for action in ("Read", "Write", "Admin", "List", "Tagging"):
        for bucket in ("b1", "b2"):
            assert [port_auth.Identity(*k).allows(action, bucket)
                    for k in KEYS] == [
                ref_auth.Identity(*k).allows(action, bucket) for k in KEYS]
