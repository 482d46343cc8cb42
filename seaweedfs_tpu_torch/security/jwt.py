"""HS256 JWT minting/verification + request guard.

The port's copy of ``seaweedfs_tpu/security/jwt.py``.

Behavioral model: weed/security/jwt.go:16-60 (fid-scoped claims: a token
minted on /dir/assign authorizes writes to exactly that fid),
guard.go:17-40 (IP whitelist + jwt middleware). Stdlib hmac only.
"""

from __future__ import annotations

import base64
import hmac
import hashlib
import json
import time


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    pad = -len(s) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


def gen_jwt(
    signing_key: str,
    fid: str,
    expires_seconds: int = 10,
) -> str:
    """Short-lived token scoped to one file id (jwt.go:21-40)."""
    if not signing_key:
        return ""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = {"exp": int(time.time()) + expires_seconds, "sub": fid}
    payload = _b64(json.dumps(claims).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(
        signing_key.encode(), signing_input, hashlib.sha256
    ).digest()
    return f"{header}.{payload}.{_b64(sig)}"


class JwtError(Exception):
    pass


def decode_jwt(signing_key: str, token: str) -> dict:
    """Verify signature + expiry; returns the claims (jwt.go:44-60)."""
    try:
        header, payload, sig = token.split(".")
    except ValueError:
        raise JwtError("malformed token")
    want = hmac.new(
        signing_key.encode(),
        f"{header}.{payload}".encode(),
        hashlib.sha256,
    ).digest()
    if not hmac.compare_digest(want, _unb64(sig)):
        raise JwtError("bad signature")
    claims = json.loads(_unb64(payload))
    if claims.get("exp", 0) < time.time():
        raise JwtError("token expired")
    return claims


class Guard:
    """Request gate: IP whitelist OR a valid fid-scoped JWT
    (guard.go:17-40). Empty config ⇒ everything allowed."""

    def __init__(
        self,
        white_list: list[str] | None = None,
        signing_key: str = "",
    ):
        self.white_list = set(white_list or [])
        self.signing_key = signing_key

    @property
    def is_active(self) -> bool:
        return bool(self.white_list) or bool(self.signing_key)

    def check_whitelist(self, peer_ip: str) -> bool:
        if not self.white_list:
            return False
        return peer_ip in self.white_list

    def check_jwt(self, token: str, fid: str) -> None:
        """Raises JwtError unless `token` authorizes writing `fid`."""
        if not self.signing_key:
            return
        if not token:
            raise JwtError("jwt required")
        claims = decode_jwt(self.signing_key, token)
        sub = claims.get("sub", "")
        if sub and sub != fid:
            raise JwtError(f"jwt scoped to {sub}, not {fid}")
