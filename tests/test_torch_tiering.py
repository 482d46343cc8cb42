"""The port's volume tiering (``/admin/tier/*`` of ``server/volume.py``
and ``storage/backend.py``'s ``S3Backend``) held against the
reference's on the CPU.

(a) For each remote — an S3 gateway over a filer, or the plain-HTTP tier
    (a filer path) — of each package, one volume server of each package
    writes the same needles on a pinned clock, moves the ``.dat`` to the
    remote (the S3 tier's credentials from the ``WEED_S3_DEFAULT_*``
    backend settings, its reads sigv4-signed ranged GETs), serves every
    needle from there, and brings the ``.dat`` back. The answers, the
    ``.vif`` written at upload (the remote's URL and the object key, one
    a run, masked) and the final ``.dat`` are equal between the two
    volume servers, and the ``.dat`` is the one written. Inline
    credentials are refused alike.
(b) ``tests/test_tiering_backup.py``'s plain-HTTP tier on a port
    cluster: ``volume.tier.upload`` through the port's shell to a port
    filer, reads through the client, the volume readonly on its remote,
    ``volume.tier.download``, reads again.
"""

import hashlib
import os
import time

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.s3 import S3ApiServer as RefS3  # noqa: E402
from seaweedfs_tpu.s3.auth import Identity as RefIdentity  # noqa: E402
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefClusterHarness,
)
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume  # noqa: E402,E501
from seaweedfs_tpu.storage import backend as ref_backend  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.s3 import S3ApiServer as PortS3  # noqa: E402
from seaweedfs_tpu_torch.s3.auth import Identity  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.shell import CommandEnv, run_command  # noqa: E402
from seaweedfs_tpu_torch.storage import backend as port_backend  # noqa: E402
from seaweedfs_tpu_torch.util import http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

NO_MASTER = "http://127.0.0.1:9"  # nothing listens: heartbeats fail
KEY = ("tier", "AKTIER", "tier-secret", ["Admin"])
STAMP_NS = 1_700_000_000_000_000_000


def _reset_clients():
    for op, retry in ((port_operation, port_retry),
                      (ref_operation, ref_retry)):
        op.client._lookup_cache.clear()
        retry.BREAKERS.reset()


@pytest.fixture(scope="module")
def remotes(tmp_path_factory):
    """A filer and an S3 gateway of each package, each over its own
    cluster; the gateways know one identity."""
    root = tmp_path_factory.mktemp("remotes")
    _reset_clients()
    with RefClusterHarness(n_volume_servers=1, volumes_per_server=30,
                           root=str(root / "ref"), with_filer=True) as ref, \
            ClusterHarness(n_volume_servers=1, volumes_per_server=30,
                           root=str(root / "port"), device="cpu",
                           with_filer=True) as port:
        ref.wait_for_nodes(1)
        port.wait_for_nodes(1)
        out = {}
        for which, c, gw, ident in (("ref", ref, RefS3, RefIdentity),
                                    ("port", port, PortS3, Identity)):
            s3 = gw(c.filer.url, identities=[ident(*KEY)])
            s3.start()
            out[which] = (c.filer.url, s3)
        try:
            # the tier bucket, through the port's signer
            for _, s3 in out.values():
                _signed_put_bucket(s3.url, "tierb")
            yield {which: (f, s3.url) for which, (f, s3) in out.items()}
        finally:
            for _, s3 in out.values():
                s3.stop()
    _reset_clients()


def _signed_put_bucket(url, bucket):
    from seaweedfs_tpu_torch.s3.auth import sign_request_v4

    host = url.split("//")[-1]
    amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    h = {"Host": host, "X-Amz-Date": amz,
         "X-Amz-Content-Sha256": hashlib.sha256(b"").hexdigest()}
    h["Authorization"] = sign_request_v4(Identity(*KEY), "PUT",
                                         f"/{bucket}", {}, h, b"", amz)
    http.request("PUT", f"{url}/{bucket}", b"", h)


NEEDLES = {k: bytes([k]) * (700 * k + 13) for k in range(1, 12)}


def _tier_run(which, root, remote, kind, key, monkeypatch):
    """One volume server of package ``which``: write, tier, read, bring
    back. Returns what it answered and left on disk."""
    filer, gateway = remote
    monkeypatch.setattr(time, "time_ns", lambda: STAMP_NS)
    kw = {"device": "cpu"} if which == "port" else {}
    cls = VolumeServer if which == "port" else RefVolume
    vs = cls(NO_MASTER, [str(root)], pulse_seconds=60, **kw)
    vs.start()
    out = {}
    try:
        http.post_json(f"{vs.url}/admin/assign_volume",
                       {"volume": 6, "collection": "tier"})
        fids = {k: f"6,{k:x}{0xabc0 + k:08x}" for k in NEEDLES}
        for k, fid in fids.items():
            http.request("POST", f"{vs.url}/{fid}?ts=1700000000",
                         NEEDLES[k])
        http.request("DELETE", f"{vs.url}/{fids[4]}")
        dat = root / "tier_6.dat"
        written = dat.read_bytes()
        if kind == "s3":
            body = {"volume": 6, "s3": {"endpoint": gateway,
                                        "bucket": "tierb", "key": key}}
            dest = gateway
        else:
            dest = f"http://{filer.split('//')[-1]}/tier/{key}"
            body = {"volume": 6, "dest_url": dest}
        out["inline credentials"] = _answer(
            vs.url, "/admin/tier/upload",
            {"volume": 6, "s3": {"endpoint": gateway, "bucket": "tierb",
                                 "access_key": "AK", "secret_key": "x"}})
        out["upload"] = _answer(vs.url, "/admin/tier/upload", body)
        out["dat left"] = dat.exists()
        vif = (root / "tier_6.vif").read_text()
        out["vif"] = vif.replace(dest, "<remote>").replace(
            dest.split("//")[-1], "<remote>").replace(key, "<key>")
        out["reads"] = []
        for k, fid in fids.items():
            try:
                got = http.request("GET", f"{vs.url}/{fid}")
                out["reads"].append((k, got == NEEDLES[k], len(got)))
            except http.HttpError as e:
                out["reads"].append((k, e.status))
        out["write refused"] = _answer_raw(vs.url, "POST",
                                           "/6,ff0000abff", b"late")
        out["download"] = _answer(vs.url, "/admin/tier/download",
                                  {"volume": 6})
        out["download again"] = _answer(vs.url, "/admin/tier/download",
                                        {"volume": 6})
        out["vif left"] = (root / "tier_6.vif").exists()
        out["dat"] = hashlib.sha256(dat.read_bytes()).hexdigest()
        out["dat is the one written"] = dat.read_bytes() == written
        out["read after"] = http.request("GET", f"{vs.url}/{fids[3]}") == (
            NEEDLES[3])
    finally:
        vs.stop()
    return out


def _answer_raw(url, method, path, body):
    try:
        return (200, http.request(method, f"{url}{path}", body))
    except http.HttpError as e:
        return (e.status, e.body)


def _answer(url, path, obj):
    import json

    return _answer_raw(url, "POST", path, json.dumps(obj).encode())


@pytest.mark.parametrize("kind", ["s3", "http"])
@pytest.mark.parametrize("remote_pkg", ["ref", "port"])
def test_tier_round_trip_matches_reference(kind, remote_pkg, remotes,
                                           tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_S3_DEFAULT_ACCESS_KEY", KEY[1])
    monkeypatch.setenv("WEED_S3_DEFAULT_SECRET_KEY", KEY[2])
    for mod in (ref_backend, port_backend):
        mod.reload_backend_configuration()
    got = {}
    for which in ("ref", "port"):
        (tmp_path / which).mkdir()
        got[which] = _tier_run(which, tmp_path / which, remotes[remote_pkg],
                               kind, f"{kind}-{which}.dat", monkeypatch)
    for mod in (ref_backend, port_backend):
        mod.reload_backend_configuration()
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out["inline credentials"][0] == 400
    assert out["upload"][0] == 200 and not out["dat left"]
    assert [r[1] for r in out["reads"] if r[0] != 4] == [True] * 10
    assert dict((r[0], r[1]) for r in out["reads"])[4] == 404
    assert out["write refused"][0] >= 400
    assert out["download"][0] == 200 and out["download again"][0] == 400
    assert not out["vif left"] and out["dat is the one written"]
    assert out["read after"]
    assert ('"type": "s3"' in out["vif"]) == (kind == "s3")


def test_plain_http_tier_through_the_port_shell(tmp_path):
    """``tests/test_tiering_backup.py``'s tier test on port servers."""
    _reset_clients()
    try:
        with ClusterHarness(n_volume_servers=2, volumes_per_server=20,
                            root=str(tmp_path), device="cpu",
                            with_filer=True) as c:
            c.wait_for_nodes(2)
            m = c.master.url
            files = {}
            for i in range(8):
                fid, _ = port_operation.upload_data(
                    m, f"tiered-{i}".encode(), collection="tier")
                files[fid] = f"tiered-{i}".encode()
            vid = int(next(iter(files)).split(",")[0])
            subset = {f: d for f, d in files.items()
                      if int(f.split(",")[0]) == vid}
            loc = port_operation.lookup(m, str(vid), refresh=True)[0]["url"]
            dest = f"http://{c.filer.url}/tier/{vid}.dat"
            env = CommandEnv(m)
            env.lock()
            try:
                out = run_command(env, f"volume.tier.upload -volumeId {vid} "
                                  f"-server {loc} -dest {dest}")
                assert f"volume {vid} tiered to {dest}" in out
                for fid, data in subset.items():
                    assert port_operation.read_file(m, fid) == data
                vol = next(v for v in (vs.store.find_volume(vid)
                                       for vs in c.volume_servers) if v)
                assert vol.readonly and isinstance(
                    vol.remote_backend, port_backend.HttpRangeBackend)
                assert not os.path.exists(vol.data_file_name)
                out = run_command(env, f"volume.tier.download -volumeId "
                                  f"{vid} -server {loc}")
                assert out == f"volume {vid} un-tiered\n"
            finally:
                env.unlock()
            for fid, data in subset.items():
                assert port_operation.read_file(m, fid) == data
            vol = next(v for v in (vs.store.find_volume(vid)
                                   for vs in c.volume_servers) if v)
            assert vol.remote_backend is None and not vol.readonly
    finally:
        _reset_clients()
