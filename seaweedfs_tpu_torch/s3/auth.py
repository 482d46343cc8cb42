"""S3 authentication: AWS Signature V4 (header auth) + identity registry.

Behavioral model: weed/s3api/auth_signature_v4.go,
auth_credentials.go — identities with per-action permissions; anonymous
access when no identities are configured.

The port's copy of ``seaweedfs_tpu/s3/auth.py``.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass, field

ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_ADMIN = "Admin"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"


@dataclass
class Identity:
    name: str
    access_key: str
    secret_key: str
    actions: list[str] = field(default_factory=lambda: ["Admin"])

    def allows(self, action: str, bucket: str) -> bool:
        for a in self.actions:
            if a == "Admin":
                return True
            base, _, target = a.partition(":")
            if base != action:
                continue
            if not target or target == bucket:
                return True
        return False


class AuthError(Exception):
    def __init__(self, code: str, message: str, status: int = 403):
        self.code = code
        self.message = message
        self.status = status
        super().__init__(message)


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _signature_v4(
    secret: str,
    method: str,
    path: str,
    query: dict[str, list[str]],
    headers: dict[str, str],
    body: bytes,
    signed_headers: list[str],
    amz_date: str,
    date: str,
    region: str,
    service: str,
) -> str:
    lower_headers = {k.lower(): v for k, v in headers.items()}
    canonical_headers = "".join(
        f"{h}:{' '.join(lower_headers.get(h, '').split())}\n"
        for h in signed_headers
    )
    qs_pairs = sorted(
        (urllib.parse.quote(k, safe="-_.~"),
         urllib.parse.quote(v, safe="-_.~"))
        for k, vs in query.items()
        for v in vs
    )
    canonical_query = "&".join(f"{k}={v}" for k, v in qs_pairs)
    payload_hash = lower_headers.get(
        "x-amz-content-sha256", _sha256(body)
    )
    # Canonical URI: for the s3 service AWS uses the wire path
    # verbatim — it is already percent-encoded by the client and is
    # NOT re-encoded (re-quoting would double-encode '%' → '%25',
    # breaking keys with spaces/special chars for real SDKs).
    canonical_request = "\n".join(
        [
            method,
            path,
            canonical_query,
            canonical_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            _sha256(canonical_request.encode()),
        ]
    )
    k = _signing_key(secret, date, region, service)
    return hmac.new(
        k, string_to_sign.encode(), hashlib.sha256
    ).hexdigest()


def _parse_auth_header(auth: str) -> tuple[dict, tuple]:
    parts = dict(
        kv.strip().split("=", 1)
        for kv in auth[len("AWS4-HMAC-SHA256") :].split(",")
    )
    access_key, date, region, service, _ = parts["Credential"].split(
        "/", 4
    )
    return parts, (access_key, date, region, service)


def _signing_key(
    secret: str, date: str, region: str, service: str
) -> bytes:
    k = _hmac(f"AWS4{secret}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


# -- Signature V2 (auth_signature_v2.go) -------------------------------------

# Subresources included in the V2 canonicalized resource, alphabetical
# (auth_signature_v2.go resourceList).
_V2_RESOURCE_LIST = [
    "acl",
    "delete",
    "lifecycle",
    "location",
    "logging",
    "notification",
    "partNumber",
    "policy",
    "requestPayment",
    "response-cache-control",
    "response-content-disposition",
    "response-content-encoding",
    "response-content-language",
    "response-content-type",
    "response-expires",
    "torrent",
    "uploadId",
    "uploads",
    "versionId",
    "versioning",
    "versions",
    "website",
]


def _canonical_amz_headers_v2(headers: dict[str, str]) -> str:
    keyval: dict[str, list[str]] = {}
    for k, v in headers.items():
        lk = k.lower()
        if lk.startswith("x-amz-"):
            keyval.setdefault(lk, []).append(v)
    return "\n".join(
        f"{k}:{','.join(keyval[k])}" for k in sorted(keyval)
    )


def _canonical_resource_v2(
    path: str, query: dict[str, list[str]]
) -> str:
    parts = []
    for key in _V2_RESOURCE_LIST:
        if key in query:
            v = query[key][0] if query[key] else ""
            parts.append(f"{key}={v}" if v else key)
    return path + (f"?{'&'.join(parts)}" if parts else "")


def _string_to_sign_v2(
    method: str,
    path: str,
    query: dict[str, list[str]],
    headers: dict[str, str],
    expires: str = "",
) -> str:
    """StringToSign = verb\nContent-MD5\nContent-Type\nDate\n
    CanonicalizedAmzHeaders CanonicalizedResource; presigned requests
    put Expires in the Date slot (auth_signature_v2.go
    getStringToSignV2)."""
    lower = {k.lower(): v for k, v in headers.items()}
    canonical = _canonical_amz_headers_v2(headers)
    if canonical:
        canonical += "\n"
    date = expires or lower.get("date", "")
    return (
        "\n".join(
            [
                method,
                lower.get("content-md5", ""),
                lower.get("content-type", ""),
                date,
                canonical,
            ]
        )
        + _canonical_resource_v2(path, query)
    )


def _signature_v2(secret: str, string_to_sign: str) -> str:
    import base64

    return base64.b64encode(
        hmac.new(
            secret.encode(), string_to_sign.encode(), hashlib.sha1
        ).digest()
    ).decode()


def sign_request_v2(
    identity: Identity,
    method: str,
    path: str,
    query: dict[str, list[str]] | None = None,
    headers: dict[str, str] | None = None,
) -> str:
    """Authorization header value for a V2-signed request (client
    half, used by tests and the admin tooling)."""
    sts = _string_to_sign_v2(method, path, query or {}, headers or {})
    return (
        f"AWS {identity.access_key}:"
        f"{_signature_v2(identity.secret_key, sts)}"
    )


def presign_url_v2(
    identity: Identity,
    method: str,
    path: str,
    expires_epoch: int,
    query: dict[str, list[str]] | None = None,
) -> str:
    """Query-string suffix for a V2 presigned URL
    (RESTAuthenticationQueryStringAuth)."""
    query = dict(query or {})
    sts = _string_to_sign_v2(
        method, path, query, {}, expires=str(expires_epoch)
    )
    sig = _signature_v2(identity.secret_key, sts)
    q = {
        **{k: v[0] if v else "" for k, v in query.items()},
        "AWSAccessKeyId": identity.access_key,
        "Expires": str(expires_epoch),
        "Signature": sig,
    }
    return f"{path}?{urllib.parse.urlencode(q)}"


def presign_url_v4(
    identity: Identity,
    method: str,
    host: str,
    path: str,
    amz_date: str,
    expires_s: int,
    region: str = "us-east-1",
) -> str:
    """Query-string-authenticated V4 URL (client half)."""
    date = amz_date[:8]
    cred = f"{identity.access_key}/{date}/{region}/s3/aws4_request"
    query = {
        "X-Amz-Algorithm": ["AWS4-HMAC-SHA256"],
        "X-Amz-Credential": [cred],
        "X-Amz-Date": [amz_date],
        "X-Amz-Expires": [str(expires_s)],
        "X-Amz-SignedHeaders": ["host"],
    }
    sig = _signature_v4(
        identity.secret_key,
        method,
        path,
        query,
        {"Host": host, "x-amz-content-sha256": "UNSIGNED-PAYLOAD"},
        b"",
        ["host"],
        amz_date,
        date,
        region,
        "s3",
    )
    q = {k: v[0] for k, v in query.items()}
    q["X-Amz-Signature"] = sig
    return f"{path}?{urllib.parse.urlencode(q)}"


class IdentityAccessManagement:
    def __init__(self, identities: list[Identity] | None = None):
        self.identities = {i.access_key: i for i in (identities or [])}

    @property
    def is_enabled(self) -> bool:
        return bool(self.identities)

    def authenticate(
        self,
        method: str,
        path: str,
        query: dict[str, list[str]],
        headers: dict[str, str],
        body: bytes,
    ) -> Identity | None:
        """Returns the Identity, or None for anonymous-allowed setups.
        Raises AuthError on bad signatures."""
        if not self.is_enabled:
            return None
        auth = headers.get("Authorization", "")
        if auth.startswith("AWS ") or (
            not auth
            and "Signature" in query
            and "AWSAccessKeyId" in query
        ):
            # legacy Signature V2: header form or presigned query
            # (auth_signature_v2.go isReqAuthenticatedV2; presign is
            # detected by BOTH AWSAccessKeyId and Signature params)
            return self._authenticate_v2(
                method, path, query, headers
            )
        if not auth and "X-Amz-Algorithm" in query:
            # presigned V4 (query-string auth)
            return self._authenticate_v4_presigned(
                method, path, query, headers
            )
        if not auth.startswith("AWS4-HMAC-SHA256"):
            if auth or any(
                k in query
                for k in ("X-Amz-Signature", "X-Amz-Credential")
            ):
                # the request CARRIES credential material we don't
                # recognize — that's a rejected signature, never a
                # silent downgrade to anonymous
                raise AuthError(
                    "AccessDenied",
                    "unsupported authorization scheme", 403,
                )
            # truly credential-free: anonymous — allowed iff an
            # identity named "anonymous" is configured
            # (auth_credentials.go lookupAnonymous); its actions
            # scope what unauthenticated callers can do
            anon = self._lookup_anonymous()
            if anon is not None:
                return anon
            raise AuthError(
                "AccessDenied", "anonymous access denied", 403
            )
        try:
            parts, (access_key, date, region, service) = (
                _parse_auth_header(auth)
            )
            signed_headers = parts["SignedHeaders"].split(";")
            signature = parts["Signature"]
        except (KeyError, ValueError):
            raise AuthError(
                "AuthorizationHeaderMalformed", "bad auth header", 400
            )
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError(
                "InvalidAccessKeyId", f"unknown key {access_key}", 403
            )
        amz_date = headers.get("X-Amz-Date") or headers.get(
            "x-amz-date", ""
        )
        want = self._signature(
            identity.secret_key,
            method,
            path,
            query,
            headers,
            body,
            signed_headers,
            amz_date,
            date,
            region,
            service,
        )
        if not hmac.compare_digest(want, signature):
            raise AuthError(
                "SignatureDoesNotMatch", "signature mismatch", 403
            )
        return identity

    def _lookup_anonymous(self) -> Identity | None:
        for ident in self.identities.values():
            if ident.name == "anonymous":
                return ident
        return None

    def _authenticate_v4_presigned(
        self,
        method: str,
        path: str,
        query: dict[str, list[str]],
        headers: dict[str, str],
    ) -> Identity:
        """Presigned V4 (query-string auth): the signature covers every
        query param except X-Amz-Signature, the headers named in
        X-Amz-SignedHeaders, and an UNSIGNED-PAYLOAD body."""
        import datetime as dt

        def q1(name: str) -> str:
            return (query.get(name) or [""])[0]

        if q1("X-Amz-Algorithm") != "AWS4-HMAC-SHA256":
            raise AuthError(
                "AccessDenied", "unsupported signing algorithm", 400
            )
        try:
            access_key, date, region, service, _ = q1(
                "X-Amz-Credential"
            ).split("/", 4)
        except ValueError:
            raise AuthError(
                "AuthorizationHeaderMalformed", "bad credential", 400
            )
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError(
                "InvalidAccessKeyId", f"unknown key {access_key}", 403
            )
        amz_date = q1("X-Amz-Date")
        try:
            signed_at = dt.datetime.strptime(
                amz_date, "%Y%m%dT%H%M%SZ"
            ).replace(tzinfo=dt.timezone.utc)
            expires_s = int(q1("X-Amz-Expires"))
        except ValueError:
            raise AuthError(
                "AccessDenied", "malformed presigned query", 400
            )
        # AWS bounds X-Amz-Expires to 1..604800 s (7 days); without the
        # cap a leaked URL stays valid for years, and 0/negative values
        # make the expiry arithmetic meaningless
        if not 1 <= expires_s <= 604800:
            raise AuthError(
                "AuthorizationQueryParametersError",
                "X-Amz-Expires must be between 1 and 604800", 400,
            )
        # the credential scope date must be the day the URL was signed:
        # a mismatched scope means the signing key and the claimed
        # signing time disagree (s3v4 credential-scope check)
        if date != amz_date[:8]:
            raise AuthError(
                "AuthorizationQueryParametersError",
                "credential scope date does not match X-Amz-Date", 400,
            )
        now = dt.datetime.now(dt.timezone.utc)
        if now > signed_at + dt.timedelta(seconds=expires_s):
            raise AuthError(
                "AccessDenied", "presigned URL expired", 403
            )
        signed_headers = q1("X-Amz-SignedHeaders").split(";")
        signing_query = {
            k: v for k, v in query.items() if k != "X-Amz-Signature"
        }
        presign_headers = dict(headers)
        presign_headers["x-amz-content-sha256"] = "UNSIGNED-PAYLOAD"
        want = self._signature(
            identity.secret_key,
            method,
            path,
            signing_query,
            presign_headers,
            b"",
            signed_headers,
            amz_date,
            date,
            region,
            service,
        )
        if not hmac.compare_digest(want, q1("X-Amz-Signature")):
            raise AuthError(
                "SignatureDoesNotMatch",
                "presigned signature mismatch", 403,
            )
        return identity

    def _authenticate_v2(
        self,
        method: str,
        path: str,
        query: dict[str, list[str]],
        headers: dict[str, str],
    ) -> Identity:
        """Signature V2: `Authorization: AWS key:sig` (HMAC-SHA1 over
        the V2 string-to-sign) or presigned
        ?AWSAccessKeyId=&Expires=&Signature= (auth_signature_v2.go
        doesSignV2Match / doesPresignV2SignatureMatch)."""
        import base64
        import time as time_mod

        auth = headers.get("Authorization", "")
        if auth.startswith("AWS "):
            access_key, sep, got = auth[4:].strip().partition(":")
            if not sep or not access_key:
                raise AuthError(
                    "AuthorizationHeaderMalformed", "bad v2 header",
                    400,
                )
            identity = self.identities.get(access_key)
            if identity is None:
                raise AuthError(
                    "InvalidAccessKeyId",
                    f"unknown key {access_key}", 403,
                )
            sts = _string_to_sign_v2(method, path, query, headers)
            want = _signature_v2(identity.secret_key, sts)
        else:
            access_key = (query.get("AWSAccessKeyId") or [""])[0]
            got = (query.get("Signature") or [""])[0]
            expires = (query.get("Expires") or [""])[0]
            if not access_key or not got or not expires:
                raise AuthError(
                    "AccessDenied", "incomplete presigned query", 403
                )
            identity = self.identities.get(access_key)
            if identity is None:
                raise AuthError(
                    "InvalidAccessKeyId",
                    f"unknown key {access_key}", 403,
                )
            try:
                expires_i = int(expires)
            except ValueError:
                raise AuthError(
                    "AccessDenied", "malformed Expires", 403
                )
            if expires_i < int(time_mod.time()):
                raise AuthError(
                    "AccessDenied", "presigned URL expired", 403
                )
            filtered = {
                k: v
                for k, v in query.items()
                if k not in (
                    "AWSAccessKeyId", "Signature", "Expires"
                )
            }
            sts = _string_to_sign_v2(
                method, path, filtered, headers, expires=expires
            )
            want = _signature_v2(identity.secret_key, sts)
        # compare decoded bytes: base64 text is not unique
        # (auth_signature_v2.go compareSignatureV2)
        try:
            got_b = base64.b64decode(got)
            want_b = base64.b64decode(want)
        except Exception:
            raise AuthError(
                "SignatureDoesNotMatch", "bad v2 signature", 403
            )
        if not hmac.compare_digest(got_b, want_b):
            raise AuthError(
                "SignatureDoesNotMatch", "v2 signature mismatch", 403
            )
        return identity

    def _signature(
        self,
        secret: str,
        method: str,
        path: str,
        query: dict[str, list[str]],
        headers: dict[str, str],
        body: bytes,
        signed_headers: list[str],
        amz_date: str,
        date: str,
        region: str,
        service: str,
    ) -> str:
        return _signature_v4(
            secret, method, path, query, headers, body,
            signed_headers, amz_date, date, region, service,
        )


    def decode_streaming_upload(
        self, headers: dict[str, str], body: bytes
    ) -> bytes | None:
        """aws-chunked body (STREAMING-AWS4-HMAC-SHA256-PAYLOAD):
        verify every chunk signature against the HMAC chain seeded by
        the header signature and return the decoded payload. Returns
        None when the request is not a streaming upload."""
        lower = {k.lower(): v for k, v in headers.items()}
        if lower.get("x-amz-content-sha256") != STREAMING_PAYLOAD:
            return None
        if not self.is_enabled:
            # open server: signatures can't be verified (no secrets),
            # but the aws-chunked framing must still be stripped or the
            # stored body would contain chunk headers
            return self._decode_chunks(body, verify=None)
        try:
            parts, (access_key, date, region, service) = (
                _parse_auth_header(lower.get("authorization", ""))
            )
            seed_sig = parts["Signature"]
        except (KeyError, ValueError):
            raise AuthError(
                "AuthorizationHeaderMalformed", "bad auth header", 400
            )
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError(
                "InvalidAccessKeyId", f"unknown key {access_key}", 403
            )
        amz_date = lower.get("x-amz-date", "")
        scope = f"{date}/{region}/{service}/aws4_request"
        key = _signing_key(identity.secret_key, date, region, service)

        def verify(prev_sig: str, chunk: bytes) -> str:
            string_to_sign = "\n".join(
                [
                    "AWS4-HMAC-SHA256-PAYLOAD",
                    amz_date,
                    scope,
                    prev_sig,
                    _EMPTY_SHA256,
                    _sha256(chunk),
                ]
            )
            return hmac.new(
                key, string_to_sign.encode(), hashlib.sha256
            ).hexdigest()

        out = self._decode_chunks(body, verify, seed_sig)
        declared = lower.get("x-amz-decoded-content-length")
        if declared:
            try:
                declared_n = int(declared)
            except ValueError:
                raise AuthError(
                    "IncompleteBody",
                    f"bad x-amz-decoded-content-length {declared!r}",
                    400,
                )
            if declared_n != len(out):
                raise AuthError(
                    "IncompleteBody",
                    f"decoded {len(out)} != declared {declared}",
                    400,
                )
        return out

    def _decode_chunks(
        self, body: bytes, verify, seed_sig: str = ""
    ) -> bytes:
        """Strip (and optionally verify) aws-chunked framing."""
        out = bytearray()
        pos = 0
        prev_sig = seed_sig
        while True:
            nl = body.find(b"\r\n", pos)
            if nl < 0:
                raise AuthError(
                    "IncompleteBody", "truncated chunk header", 400
                )
            header = body[pos:nl].decode("ascii", "replace")
            pos = nl + 2
            size_hex, _, ext = header.partition(";")
            try:
                size = int(size_hex, 16)
            except ValueError:
                raise AuthError(
                    "InvalidChunk", f"bad chunk size {size_hex!r}", 400
                )
            sig = ""
            if ext.startswith("chunk-signature="):
                sig = ext[len("chunk-signature=") :]
            chunk = bytes(body[pos : pos + size])
            if len(chunk) != size:
                raise AuthError(
                    "IncompleteBody", "truncated chunk data", 400
                )
            pos += size
            if body[pos : pos + 2] == b"\r\n":
                pos += 2
            if verify is not None:
                want = verify(prev_sig, chunk)
                if not hmac.compare_digest(want, sig):
                    raise AuthError(
                        "SignatureDoesNotMatch",
                        f"chunk signature mismatch at offset "
                        f"{len(out)}",
                        403,
                    )
            prev_sig = sig
            if size == 0:
                break
            out += chunk
        return bytes(out)

    def verify_post_policy(
        self,
        fields: dict[str, str],
        bucket: str,
        key: str,
        content_length: int,
    ) -> Identity | None:
        """Browser form upload (POST policy): verify the policy
        signature and its conditions. `fields` are the lower-cased
        non-file form fields."""
        import base64
        import datetime as dt
        import json

        if not self.is_enabled:
            return None
        policy_b64 = fields.get("policy", "")
        if not policy_b64:
            raise AuthError(
                "AccessDenied", "POST without policy", 403
            )
        if "x-amz-algorithm" not in fields and (
            "awsaccesskeyid" in fields
        ):
            # legacy V2 policy form: Signature = base64(HMAC-SHA1(
            # secret, policy)) (auth_signature_v2.go
            # doesPolicySignatureV2Match)
            access_key = fields["awsaccesskeyid"]
            identity = self.identities.get(access_key)
            if identity is None:
                raise AuthError(
                    "InvalidAccessKeyId",
                    f"unknown key {access_key}", 403,
                )
            want = _signature_v2(identity.secret_key, policy_b64)
            try:
                same = hmac.compare_digest(
                    base64.b64decode(want),
                    base64.b64decode(fields.get("signature", "")),
                )
            except Exception:
                same = False
            if not same:
                raise AuthError(
                    "SignatureDoesNotMatch",
                    "v2 policy signature mismatch", 403,
                )
        elif fields.get("x-amz-algorithm") != "AWS4-HMAC-SHA256":
            raise AuthError(
                "AccessDenied", "unsupported signing algorithm", 400
            )
        else:
            try:
                access_key, date, region, service, _ = fields[
                    "x-amz-credential"
                ].split("/", 4)
            except (KeyError, ValueError):
                raise AuthError(
                    "AuthorizationHeaderMalformed", "bad credential",
                    400,
                )
            identity = self.identities.get(access_key)
            if identity is None:
                raise AuthError(
                    "InvalidAccessKeyId",
                    f"unknown key {access_key}", 403,
                )
            key_b = _signing_key(
                identity.secret_key, date, region, service
            )
            want = hmac.new(
                key_b, policy_b64.encode(), hashlib.sha256
            ).hexdigest()
            if not hmac.compare_digest(
                want, fields.get("x-amz-signature", "")
            ):
                raise AuthError(
                    "SignatureDoesNotMatch",
                    "policy signature mismatch", 403,
                )
        try:
            policy = json.loads(base64.b64decode(policy_b64))
        except ValueError:
            raise AuthError("InvalidPolicyDocument", "bad policy", 400)
        exp = policy.get("expiration", "")
        for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
            try:
                when = dt.datetime.strptime(exp, fmt).replace(
                    tzinfo=dt.timezone.utc
                )
                break
            except ValueError:
                when = None
        if when is None or when < dt.datetime.now(dt.timezone.utc):
            raise AuthError(
                "AccessDenied", "policy expired", 403
            )
        observed = {**fields, "bucket": bucket, "key": key}
        # AWS rejects any POST whose form fields aren't each matched by
        # a policy condition (except the checked-elsewhere/ignored set)
        # — without this, a policy omitting a key condition authorizes
        # uploads to arbitrary keys.
        covered: set[str] = set()
        for cond in policy.get("conditions", []):
            if isinstance(cond, dict):
                for k, v in cond.items():
                    k = k.lower().lstrip("$")
                    covered.add(k)
                    got = observed.get(k, "")
                    if got != v:
                        raise AuthError(
                            "AccessDenied",
                            f"policy condition failed: {k}={v!r}, "
                            f"got {got!r}",
                            403,
                        )
            elif isinstance(cond, list) and len(cond) == 3:
                if cond[0] == "content-length-range":
                    try:
                        lo, hi = int(cond[1]), int(cond[2])
                    except (TypeError, ValueError):
                        raise AuthError(
                            "InvalidPolicyDocument",
                            "malformed content-length-range", 400,
                        )
                    if not (lo <= content_length <= hi):
                        raise AuthError(
                            "EntityTooLarge"
                            if content_length > hi
                            else "EntityTooSmall",
                            f"size {content_length} outside "
                            f"[{lo}, {hi}]",
                            400,
                        )
                    continue
                op, name, val = cond
                name = str(name).lstrip("$").lower()
                covered.add(name)
                if op == "eq":
                    if observed.get(name, "") != val:
                        raise AuthError(
                            "AccessDenied",
                            f"eq condition failed on {name}", 403,
                        )
                elif op == "starts-with":
                    if not str(observed.get(name, "")).startswith(val):
                        raise AuthError(
                            "AccessDenied",
                            f"starts-with failed on {name}", 403,
                        )
                else:
                    raise AuthError(
                        "AccessDenied", f"unknown condition {op}", 400
                    )
            else:
                raise AuthError(
                    "InvalidPolicyDocument", "malformed condition", 400
                )
        exempt = {
            "policy", "x-amz-signature", "file",
            # v2 policy form auth fields
            "awsaccesskeyid", "signature",
        }
        for name in observed:
            if name in exempt or name.startswith("x-ignore-"):
                continue
            if name not in covered:
                raise AuthError(
                    "AccessDenied",
                    f"form field {name!r} not covered by any policy "
                    "condition",
                    403,
                )
        return identity





def sign_request_v4(
    identity: Identity,
    method: str,
    url_path: str,
    query: dict[str, list[str]],
    headers: dict[str, str],
    body: bytes,
    amz_date: str,
    region: str = "us-east-1",
    service: str = "s3",
) -> str:
    """Client-side signer (for tests + the filer.replicate S3 sink)."""
    iam = IdentityAccessManagement()
    date = amz_date[:8]
    signed = sorted(
        k.lower()
        for k in headers
        if k.lower() in ("host", "x-amz-date", "x-amz-content-sha256")
    )
    sig = iam._signature(
        identity.secret_key,
        method,
        url_path,
        query,
        headers,
        body,
        signed,
        amz_date,
        date,
        region,
        service,
    )
    scope = f"{date}/{region}/{service}/aws4_request"
    return (
        f"AWS4-HMAC-SHA256 Credential={identity.access_key}/{scope},"
        f"SignedHeaders={';'.join(signed)},Signature={sig}"
    )
