"""Client operations: assign, upload, lookup, delete, read.

Behavioral model: weed/operation/assign_file_id.go, upload_content.go,
lookup.go, delete_content.go — with a small TTL'd volume-location cache
like wdclient's vidMap (weed/wdclient/vid_map.go).

Every `master_url` parameter accepts either one URL or a
`operation.masters.MasterRing` (duck-typed on `.call`): with a ring,
each master round-trip re-resolves the leader, so the INTERNAL retry
loops (upload_data's re-assign, read_file's re-lookup) ride out a
leader failover instead of re-asking the dead master until their
budget dies and surfacing a RuntimeError the outer caller can't
classify as retriable.

The port's copy of ``seaweedfs_tpu/operation/client.py``. One
difference: under a deadline budget, ``upload_data`` cuts a stalled
first try off with time left for a fresh assignment (see there).
"""

from __future__ import annotations

import contextlib
import random
import time
import urllib.parse
from dataclasses import dataclass, field

from ..util import http
from ..util import retry as retry_mod


@dataclass
class Assignment:
    fid: str
    url: str
    public_url: str
    count: int
    auth: str = ""  # fid-scoped write JWT when the master signs
    # batched assign (count > 1): every reserved fid, all on the same
    # volume at `url`; fids[0] == fid. auths aligns when signing is on.
    fids: list[str] = field(default_factory=list)
    auths: list[str] = field(default_factory=list)


def _master_call(master, fn):
    """Run ``fn(url)`` against one master URL, or through a
    MasterRing's leader re-resolution when ``master`` carries one."""
    call = getattr(master, "call", None)
    if call is not None:
        return call(fn)
    return fn(master)


def _master_key(master) -> str:
    """Stable cache key for a master url or ring (the ring's whole
    candidate set — the leader within it may change)."""
    urls = getattr(master, "urls", None)
    return "|".join(urls) if urls is not None else master


def assign(
    master_url,
    count: int = 1,
    collection: str = "",
    replication: str = "",
    ttl: str = "",
) -> Assignment:
    qs = {"count": str(count)}
    if collection:
        qs["collection"] = collection
    if replication:
        qs["replication"] = replication
    if ttl:
        qs["ttl"] = ttl
    out = _master_call(
        master_url,
        lambda u: http.get_json(
            f"{u}/dir/assign?{urllib.parse.urlencode(qs)}",
            retry=retry_mod.LOOKUP,
        ),
    )
    if "error" in out:
        raise RuntimeError(out["error"])
    auth = out.get("auth", "")
    return Assignment(
        fid=out["fid"],
        url=out["url"],
        public_url=out.get("publicUrl", out["url"]),
        count=out.get("count", count),
        auth=auth,
        fids=out.get("fids") or [out["fid"]],
        auths=out.get("auths") or ([auth] if auth else []),
    )


_lookup_cache: dict[tuple[str, str], tuple[float, list[dict]]] = {}
_LOOKUP_TTL = 10.0


def lookup(master_url, vid: str, refresh: bool = False) -> list[dict]:
    """vid (or full fid) → [{url, publicUrl}].

    A running LocationWatcher (push stream, wdclient vidMap analog) is
    consulted first — pushed state is always current, so a moved volume
    resolves without a failed request. Falls back to the TTL'd
    /dir/lookup poll cache otherwise."""
    vid = vid.split(",")[0]
    from . import watch as watch_mod

    # watchers register under a plain URL; a ring caller's stream may
    # have been started with any of its candidates
    for url in getattr(master_url, "urls", None) or [master_url]:
        w = watch_mod.get_watcher(url)
        if w is not None:
            pushed = w.lookup(int(vid))
            if pushed:
                return pushed
            break
    key = (_master_key(master_url), vid)
    now = time.monotonic()
    hit = _lookup_cache.get(key)
    if hit and not refresh and now - hit[0] < _LOOKUP_TTL:
        return hit[1]
    out = _master_call(
        master_url,
        lambda u: http.get_json(
            f"{u}/dir/lookup?volumeId={vid}",
            retry=retry_mod.LOOKUP,
        ),
    )
    if "error" in out:
        raise RuntimeError(out["error"])
    locations = out.get("locations", [])
    _lookup_cache[key] = (now, locations)
    return locations


# the share of a deadline budget the first upload try leaves for a
# fresh assignment, should that try stall
FRESH_TRY_RESERVE = 0.25


def upload_data(
    master_url,
    data: bytes,
    name: str = "",
    mime: str = "",
    collection: str = "",
    replication: str = "",
    ttl: str = "",
    retries: int = 3,
    hops: list | None = None,
) -> tuple[str, int]:
    """Assign + upload; returns (fid, stored size). Re-assigns on
    failure like upload_content.go's retry loop, with the shared
    backoff policy pacing re-assigns (full jitter, no fixed sleep).
    Non-retriable statuses (401 bad auth, 404 bad fid — every 4xx)
    surface immediately: a fresh assignment cannot fix a rejected
    request.

    Under a deadline budget (``retry.deadline_scope`` or an inherited
    ``X-Seaweed-Deadline``) the first try runs under what is left of it
    less ``FRESH_TRY_RESERVE`` of that, and each later try under all
    that is left: a try stalled on one hop is cut off with time left
    for a fresh assignment, and the call fails before the budget ends
    instead of outliving the caller waiting on it. ``hops``, when
    given, gets one row a try: its assign and upload seconds (None for
    a hop not reached) and its error."""
    policy = retry_mod.UPLOAD
    last_err: Exception | None = None
    tries = 0
    for attempt in range(retries):
        left = retry_mod.remaining()
        if left is not None and left <= 0:
            break
        tries += 1
        hop: dict = {"assign_s": None, "upload_s": None}
        t0 = time.perf_counter()
        try:
            with (
                contextlib.nullcontext() if left is None
                else retry_mod.deadline_scope(
                    left * (1 - FRESH_TRY_RESERVE) if attempt == 0
                    else left
                )
            ):
                a = assign(
                    master_url,
                    collection=collection,
                    replication=replication,
                    ttl=ttl,
                )
                t1 = time.perf_counter()
                hop["assign_s"] = round(t1 - t0, 6)
                size = upload(
                    a.url, a.fid, data, name=name, mime=mime, ttl=ttl,
                    jwt=a.auth,
                )
                hop["upload_s"] = round(time.perf_counter() - t1, 6)
            return a.fid, size
        except http.HttpError as e:
            hop["error"] = str(e)[:200]
            # every 4xx (401 bad auth, 404 bad fid) is a definitive
            # answer — a fresh assignment cannot fix it; 5xx and
            # transport failures get a new volume + backoff
            if 400 <= e.status < 500:
                raise
            last_err = e
        except RuntimeError as e:
            # assign refused (no writable volume yet / growing)
            hop["error"] = str(e)[:200]
            last_err = e
        finally:
            if hops is not None:
                hops.append(hop)
        if attempt + 1 < retries:
            delay = policy.backoff(attempt)
            left = retry_mod.remaining()
            if left is not None and left <= delay:
                break  # the budget can't fund another try
            time.sleep(delay)
    raise RuntimeError(
        f"upload failed after {tries} tries: "
        f"{last_err or 'deadline budget spent'}"
    )


def upload(
    server_url: str,
    fid: str,
    data: bytes,
    name: str = "",
    mime: str = "",
    ttl: str = "",
    jwt: str = "",
) -> int:
    qs = {}
    if name:
        qs["name"] = name
    if mime:
        qs["mime"] = mime
    if ttl:
        qs["ttl"] = ttl
    suffix = f"?{urllib.parse.urlencode(qs)}" if qs else ""
    headers = {"Authorization": f"BEARER {jwt}"} if jwt else {}
    # same-fid retries are idempotent (identical bytes, same needle id)
    out = http.request(
        "POST", f"{server_url}/{fid}{suffix}", data, headers,
        timeout=120, retry=retry_mod.UPLOAD,
    )
    import json

    return json.loads(out).get("size", len(data))


def read_file(master_url, fid: str) -> bytes:
    """Read one fid, trying every location; after ALL cached locations
    fail it re-looks-up with refresh=True once — a volume moved since
    the cache filled (balance/evacuate) must not fail reads for the
    rest of the TTL (wdclient re-lookup semantics)."""
    last: Exception | None = None
    not_found = False
    for fresh in (False, True):
        try:
            locations = lookup(master_url, fid, refresh=fresh)
        except RuntimeError:
            if fresh and (last is not None or not_found):
                break  # surface the data-plane answer, not the lookup's
            raise
        if not locations:
            continue
        random.shuffle(locations)
        for loc in locations:
            try:
                return http.request(
                    "GET", f"{loc['url']}/{fid}", timeout=60
                )
            except http.HttpError as e:
                if e.status == 404:
                    # NOT authoritative alone: a degraded write may
                    # have missed this replica, and a moved volume
                    # 404s on its old holders — keep falling through
                    not_found = True
                else:
                    last = e
    if not_found and last is None:
        raise FileNotFoundError(fid)
    raise last or FileNotFoundError(f"no locations for {fid}")


def delete_file(
    master_url, fid: str, jwt_signing_key: str = ""
) -> None:
    """Delete one fid. When the cluster signs writes, internal clients
    (filer, shell) share the signing key and mint their own fid-scoped
    token — the reference's security.toml model (weed/security/jwt.go).

    The first reachable replica runs the delete (the SERVER fans out
    to the other replicas); a connection-refused first location falls
    through to the next — refused means the peer never saw the
    request, so trying elsewhere cannot double-fan-out."""
    locations = lookup(master_url, fid)
    headers = {}
    if jwt_signing_key:
        from ..security.jwt import gen_jwt

        headers["Authorization"] = (
            f"BEARER {gen_jwt(jwt_signing_key, fid)}"
        )
    last: http.HttpError | None = None
    for loc in locations:
        try:
            http.request(
                "DELETE", f"{loc['url']}/{fid}", None, headers,
                timeout=60,
            )
            return
        except http.HttpError as e:
            if not e.connection_refused:
                raise
            last = e
    if last is not None:
        raise last
