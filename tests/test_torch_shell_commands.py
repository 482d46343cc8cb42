"""The shell commands this slice ports — ``shell/command_volume.py``,
``command_collection.py``, ``command_fault.py``, ``command_trace.py`` and
the readers of ``command_cluster.py`` (``cluster.profile``,
``cluster.devices``, ``cluster.timeline``, ``cluster.contention``) —
held against the reference's on the CPU.

(a) One command script runs twice on fresh, identical mixed clusters:
    a master of one package and four volume servers, two of each
    package (the port's on ``device="cpu"``), started one by one so the
    master lists them in one order. The reference's shell drives one
    cluster, the port's the other. Every needle is written at a fixed
    fid under one pinned record clock, so the two runs print the same
    text once server URLs are named by role.
(b) The ``/debug/*`` readers render the same payloads to the same text:
    the bodies a live server of each package answered are served again
    by a stub, and both shells read the stub.
"""

import re
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import fault as ref_fault  # noqa: E402
from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.server.master import MasterServer as RefMaster  # noqa: E402,E501
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume  # noqa: E402,E501
from seaweedfs_tpu.shell import (  # noqa: E402
    CommandEnv as RefCommandEnv,
    all_commands as ref_all_commands,
    run_command as ref_run_command,
)
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import fault as port_fault  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.server.master import (  # noqa: E402
    MasterServer as PortMaster,
)
from seaweedfs_tpu_torch.server.volume import (  # noqa: E402
    VolumeServer as PortVolume,
)
from seaweedfs_tpu_torch.shell import (  # noqa: E402
    CommandEnv as PortCommandEnv,
    all_commands as port_all_commands,
    run_command as port_run_command,
)
from seaweedfs_tpu_torch.util import http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

STAMP_NS = 1_700_000_000_123_456_789
TS = "1700000000"
PULSE = 0.3
MASTERS = {"ref": RefMaster, "port": PortMaster}
SHELLS = {
    "ref": types.SimpleNamespace(Env=RefCommandEnv, run=ref_run_command),
    "port": types.SimpleNamespace(Env=PortCommandEnv, run=port_run_command),
}
# the package of each volume server, in registration order, and its
# volume slots (distinct, so no placement choice is a tie)
ROLES = ("ref", "ref", "port", "port")
SLOTS = (6, 8, 11, 9)


def _reset_client_state():
    for pkg in (ref_operation, port_operation):
        pkg.client._lookup_cache.clear()
    ref_retry.BREAKERS.reset()
    port_retry.BREAKERS.reset()


def test_the_shell_knows_every_command_but_the_filer_and_s3_tiers():
    """The name is historical: with the filer's ``fs.*`` and the S3
    tier's ``s3.*`` ported, the port's shell knows every command of the
    reference."""
    ref = set(ref_all_commands())
    port = set(port_all_commands())
    assert port == ref
    assert any(n.startswith("fs.") for n in port)
    assert any(n.startswith("s3.") for n in port)
    # the ported commands keep the reference's help text (ec.* and
    # maintenance.* name the card where the reference names the TPU)
    for name in port:
        if name.startswith(("volume.", "collection.", "fault.", "trace.",
                            "cluster.", "fs.", "s3.")):
            assert port_all_commands()[name] == ref_all_commands()[name]


# -- (a) one script on two identical mixed clusters -------------------------


def _wait_nodes(m, n, timeout=10.0):
    deadline = time.time() + timeout
    while len(m.topo.data_nodes()) != n:
        assert time.time() < deadline, f"{n} nodes never registered"
        time.sleep(0.02)


def _put(url, vid, key, cookie, data):
    fid = f"{vid},{key:x}{cookie:08x}"
    http.request("POST", f"{url}/{fid}?ts={TS}", data)
    return fid


def _start(master_kind, root):
    m = MASTERS[master_kind](pulse_seconds=PULSE)
    m.start()
    servers = []
    try:
        for i, pkg in enumerate(ROLES):
            kw = {"device": "cpu"} if pkg == "port" else {}
            V = PortVolume if pkg == "port" else RefVolume
            vs = V(m.url, [str(root / f"vs{i}")],
                   max_volume_counts=[SLOTS[i]], pulse_seconds=PULSE, **kw)
            vs.start()
            servers.append(vs)
            _wait_nodes(m, i + 1)
    except BaseException:
        _stop(m, servers)
        raise
    return m, servers


def _stop(m, servers):
    for vs in servers:
        vs.stop()
    m.stop()
    _reset_client_state()


def _populate(servers):
    """Four volumes at fixed places, seeded needles at fixed fids, and
    garbage in two of them."""
    rng = np.random.default_rng(16)
    layout = ((1, 0, ""), (2, 2, "c1"), (3, 1, ""), (4, 3, "c1"))
    for vid, i, col in layout:
        http.post_json(f"{servers[i].url}/admin/assign_volume",
                       {"volume": vid, "collection": col})
    for vid, i, _col in layout:
        fids = [_put(servers[i].url, vid, key + 1,
                     int(rng.integers(0, 1 << 32)),
                     rng.integers(0, 256, int(rng.integers(10, 3000)),
                                  dtype=np.uint8).tobytes())
                for key in range(3 + vid)]
        for fid in fids[: vid - 1]:
            http.request("DELETE", f"{servers[i].url}/{fid}")


SCRIPT = (
    "volume.list",
    "collection.list",
    "volume.fsck",
    "lock",
    "volume.mark -volumeId 1 -server {vs0} -readonly",
    "volume.list",
    "volume.mark -volumeId 1 -server {vs0} -writable",
    "volume.copy -volumeId 2 -source {vs2} -target {vs1}",
    "volume.move -volumeId 1 -source {vs0} -target {vs3}",
    "volume.configure.replication -volumeId 3 -replication 001",
    "volume.fix.replication",
    "volume.list",
    "volume.unmount -volumeId 2 -server {vs1}",
    "volume.mount -volumeId 2 -server {vs1} -collection c1",
    "volume.delete -volumeId 2 -server {vs1}",
    "volume.vacuum -sync",
    "volume.list",
    "volume.balance",
    "volume.server.evacuate -node {vs3}",
    "volume.list",
    "volume.tier.upload -volumeId 4 -server {vs2} -dest http://127.0.0.1:9/x",
    "volume.tier.download -volumeId 4 -server {vs2}",
    "fault.inject -point test.shell -server {vs0},{vs2} -count 2 -seed 3",
    "fault.list -server {vs0},{vs2}",
    "fault.clear -server {vs0},{vs2}",
    "fault.list -server {vs2}",
    "collection.delete -collection c1",
    "collection.list",
    "volume.fsck",
    "volume.server.leave -server {vs2}",
    "unlock",
)


SETTLED = ("id", "size", "file_count", "delete_count", "read_only",
           "replica_placement")


def _settle(m, servers, timeout=10.0):
    """Wait until the master's topology holds each live server's own
    volumes as the server's heartbeat reports them (sizes, counts,
    flags, placement): the master learns them one heartbeat late."""
    deadline = time.time() + timeout
    while True:
        view = {dn["url"]: {tuple(v[k] for k in SETTLED)
                            for v in dn["volumes"]}
                for dn in _data_nodes(m)}
        own = {vs.url: {tuple(getattr(vs.store._volume_message(v), k)
                              for k in SETTLED)
                        for loc in vs.store.locations
                        for v in loc.volumes.values()}
               for vs in servers if vs._running}
        if all(view.get(url) == vols for url, vols in own.items()):
            return
        assert time.time() < deadline, (view, own)
        time.sleep(0.02)


def _data_nodes(m):
    return [dn for dc in http.get_json(f"{m.url}/dir/status")["data_centers"]
            for rack in dc["racks"] for dn in rack["data_nodes"]]


def _normalise(text, names):
    for url, name in names:
        text = text.replace(url, name)
    if text.startswith("max volume id"):
        # volume.list: the master lists nodes in registration order, and
        # a node that re-registers moves to the end
        head, *nodes = re.split(r"(?m)^(?=    DataNode )", text)
        text = head + "".join(sorted(nodes))
    return text


def _script_run(master_kind, shell_kind, root):
    m, servers = _start(master_kind, root)
    sh = SHELLS[shell_kind]
    names = [(f"http://{m.url}", "<master>"), (m.url, "<master>")]
    for i, vs in enumerate(servers):
        names += [(f"http://{vs.url}", f"<vs{i}>"), (vs.url, f"<vs{i}>")]
    roles = {f"vs{i}": vs.url for i, vs in enumerate(servers)}
    out = []
    try:
        _populate(servers)
        _settle(m, servers)
        env = sh.Env(m.url)
        for line in SCRIPT:
            try:
                text = sh.run(env, line.format(**roles))
            except Exception as e:  # the same failure from both shells
                text = f"{type(e).__name__}: {e}"
            out.append((line, _normalise(text, names)))
            _settle(m, servers)
    finally:
        ref_fault.REGISTRY.clear()
        port_fault.REGISTRY.clear()
        _stop(m, servers)
    return out


@pytest.mark.parametrize("master_kind", ["ref", "port"],
                         ids=["ref-master", "port-master"])
def test_volume_collection_fault_commands_match_reference(
        master_kind, tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_FAULTS_ADMIN", "1")
    monkeypatch.setenv("SEAWEEDFS_LOAD_JSON", str(tmp_path / "none.json"))
    monkeypatch.setattr(time, "time_ns", lambda: STAMP_NS)
    got = {shell: _script_run(master_kind, shell, tmp_path / shell)
           for shell in SHELLS}
    for (line, want), (_, have) in zip(got["ref"], got["port"]):
        assert have == want, line
    out = dict(got["port"])
    # what the script says, beyond agreeing
    assert "DataNode <vs0> volumes:1/6 ec_shards:0" in out["volume.list"]
    assert "checked " in out["volume.fsck"] and ", 0 issues" in (
        out["volume.fsck"])
    assert out["volume.move -volumeId 1 -source {vs0} -target {vs3}"] == (
        "moved volume 1 <vs0> -> <vs3>\n")
    assert out["volume.fix.replication"].endswith("fixed 1 replicas\n")
    assert out["collection.list"] == "collection: <default>\n"
    assert "armed" in out["fault.inject -point test.shell -server "
                          "{vs0},{vs2} -count 2 -seed 3"]
    assert out["fault.list -server {vs2}"] == "<vs2>: no faults armed\n"
    # /admin/tier/* answers now (no 501): volume 4 is not on that server
    # by then, and the route says so as the reference's does
    assert "http 500" in out["volume.tier.upload -volumeId 4 -server {vs2} "
                             "-dest http://127.0.0.1:9/x"]
    assert "volume 4 not found" in out["volume.tier.download -volumeId 4 "
                                       "-server {vs2}"]


# -- (b) the /debug/* readers on the same payloads ---------------------------


READERS = (
    "trace.dump -server {srv}",
    "trace.dump -server {srv} -limit 3",
    "trace.slow -server {srv}",
    "cluster.profile -server {srv} -seconds 0.3 -top 4",
    "cluster.profile -server {srv} -seconds 0.3 -raw",
    "cluster.devices -server {srv}",
    "cluster.timeline -server {srv} -seconds 30",
    "cluster.contention -server {srv} -top 3",
    "cluster.contention -server {srv} -top 3 -stacks",
)
PATHS = ("/debug/traces", "/debug/slow", "/debug/profile", "/debug/devices",
         "/debug/timeline", "/debug/contention")


def _capture(server_kind, root):
    """The bodies of one live volume server's /debug/* after some
    traffic (and its master's timeline)."""
    m = MASTERS[server_kind](pulse_seconds=PULSE)
    m.start()
    kw = {"device": "cpu"} if server_kind == "port" else {}
    V = PortVolume if server_kind == "port" else RefVolume
    vs = V(m.url, [str(root)], pulse_seconds=PULSE, **kw)
    vs.start()
    try:
        _wait_nodes(m, 1)
        http.post_json(f"{vs.url}/admin/assign_volume", {"volume": 7})
        for key in range(1, 6):
            fid = _put(vs.url, 7, key, 0x1234 + key, b"x" * 100 * key)
            http.request("GET", f"{vs.url}/{fid}")
        bodies = {}
        for path in PATHS:
            q = "?seconds=0.3&hz=50" if path == "/debug/profile" else ""
            bodies[path] = http.request("GET", f"{vs.url}{path}{q}")
        return bodies
    finally:
        vs.stop()
        m.stop()
        _reset_client_state()


def _stub(bodies):
    router = http.Router()
    for path, body in bodies.items():
        router.add("GET", re.escape(path),
                   lambda req, body=body: http.Response(status=200,
                                                        body=body))
    srv = http.HttpServer(router)
    srv.start()
    return srv


@pytest.mark.parametrize("server_kind", ["ref", "port"],
                         ids=["ref-payloads", "port-payloads"])
def test_debug_readers_render_like_the_reference(server_kind, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_LOAD_JSON", str(tmp_path / "none.json"))
    stub = _stub(_capture(server_kind, tmp_path / "vs"))
    try:
        for line in READERS:
            cmd = line.format(srv=stub.url)
            texts = {}
            for name, sh in SHELLS.items():
                texts[name] = sh.run(sh.Env(stub.url), cmd)
            assert texts["port"] == texts["ref"], cmd
            assert texts["port"].strip(), cmd
    finally:
        stub.stop()
