"""The port's masters in a group (``server/raft.py``), and over TLS
(``security/tls.py``), held against the reference on the CPU.

(a) Every case of ``tests/test_raft.py`` runs once through each package,
    with the same injected ``send``: the same answers, states and
    messages.
(b) The raft ``state_dir`` is interchangeable: what one package's
    ``RaftLite`` persists, the other's reloads, byte for byte.
(c) One mixed raft group (port and reference masters) elects exactly one
    leader, elects another when it dies, and a master restarted from
    its ``state_dir`` as the other package's rejoins as a follower.
(d) Every case of ``tests/test_multi_master.py`` on three port masters
    and a port volume server (``device="cpu"``), through the port's
    ``operation`` client; and ``ClusterHarness(n_masters=3)``'s
    ``kill_master`` and ``restart_master``.
(e) Both cases of ``tests/test_tls.py`` on a port master and volume
    server over mutual TLS (the filer is not ported), with the port's
    dev PKI, which the reference's contexts load too.
"""

import json
import os
import ssl
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.security import tls as ref_tls  # noqa: E402
from seaweedfs_tpu.server import master as ref_master  # noqa: E402
from seaweedfs_tpu.server import raft as ref_raft  # noqa: E402
from seaweedfs_tpu.util import http as ref_http  # noqa: E402
from seaweedfs_tpu_torch import operation  # noqa: E402
from seaweedfs_tpu_torch.operation import client as op_client  # noqa: E402
from seaweedfs_tpu_torch.security import tls as port_tls  # noqa: E402
from seaweedfs_tpu_torch.server import master as port_master  # noqa: E402
from seaweedfs_tpu_torch.server import raft as port_raft  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.util import http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

REF = types.SimpleNamespace(
    name="ref", RaftLite=ref_raft.RaftLite,
    RaftSequencer=ref_raft.RaftSequencer, NoQuorumError=ref_raft.NoQuorumError,
    MasterServer=ref_master.MasterServer, http=ref_http,
)
PORT = types.SimpleNamespace(
    name="port", RaftLite=port_raft.RaftLite,
    RaftSequencer=port_raft.RaftSequencer,
    NoQuorumError=port_raft.NoQuorumError,
    MasterServer=port_master.MasterServer, http=http,
)


def _down(peer, path, payload):
    raise ConnectionError("peer down")


def _ack(peer, path, payload):
    return {"ok": True, "term": payload["term"],
            "version": payload["version"]}


def _grant_and_ack(peer, path, payload):
    if path == "/raft/vote":
        return {"granted": True, "term": payload["term"]}
    return _ack(peer, path, payload)


def _raft_view(r):
    return [r.role, r.term, r.voted_for, r.leader_url, dict(r.state),
            dict(r.committed_state), r.version, r.vterm,
            r.committed_version]


# -- (a) the cases of tests/test_raft.py ----------------------------------


def case_uncommitted_ceiling_never_backs_ids(p):
    r = p.RaftLite("a", ["a", "b", "c"], pulse_seconds=0.05, send=_down)
    r.role, r.term = "leader", 1
    seq = p.RaftSequencer(r, block=8)
    with pytest.raises(p.NoQuorumError):
        seq.next_file_id()
    assert r.state["seq_ceiling"] > 0
    assert r.committed_state["seq_ceiling"] == 0
    with pytest.raises(p.NoQuorumError):
        seq.next_file_id()
    return _raft_view(r)


def case_propose_commits_with_majority(p):
    r = p.RaftLite("a", ["a", "b", "c"], pulse_seconds=0.05, send=_ack)
    r.role, r.term = "leader", 1
    seq = p.RaftSequencer(r, block=8)
    first = seq.next_file_id()
    assert first == 1
    assert r.committed_state["seq_ceiling"] >= 1
    assert r.is_leader()
    v = r.version
    second = seq.next_file_id()
    assert second == 2 and r.version == v
    return [first, second] + _raft_view(r)


def case_replication_fanout_is_concurrent(p):
    gate = threading.Barrier(2, timeout=3)

    def slow_ack(peer, path, payload):
        gate.wait()
        return _ack(peer, path, payload)

    r = p.RaftLite("a", ["a", "b", "c"], pulse_seconds=2.0, send=slow_ack)
    r.role, r.term = "leader", 1
    ok = r._replicate(r.version)
    assert ok
    return [ok] + _raft_view(r)


def case_follower_commits_only_acked_versions(p):
    r = p.RaftLite("b", ["a", "b", "c"])
    st = {"max_volume_id": 1, "seq_ceiling": 100}
    msg = {"term": 1, "leader": "a", "version": 3, "vterm": 1, "state": st,
           "committed_version": 2}
    out = r.handle_append(msg)
    assert out["ok"]
    assert r.state["seq_ceiling"] == 100
    assert r.committed_state["seq_ceiling"] == 0
    out2 = r.handle_append({**msg, "committed_version": 3})
    assert r.committed_state["seq_ceiling"] == 100
    return [out, out2] + _raft_view(r)


def case_stale_term_append_rejected(p):
    r = p.RaftLite("b", ["a", "b", "c"])
    r.term = 5
    out = r.handle_append({
        "term": 3, "leader": "a", "version": 1, "vterm": 3,
        "state": {"max_volume_id": 0, "seq_ceiling": 0},
        "committed_version": 1,
    })
    assert not out["ok"] and out["term"] == 5
    return [out] + _raft_view(r)


def case_vote_requires_up_to_date_state(p):
    r = p.RaftLite("b", ["a", "b", "c"])
    r.version, r.vterm = 7, 2
    outs = [
        r.handle_vote({"term": 3, "candidate": "a", "version": 4,
                       "vterm": 2}),
        r.handle_vote({"term": 4, "candidate": "c", "version": 7,
                       "vterm": 2}),
        r.handle_vote({"term": 4, "candidate": "a", "version": 9,
                       "vterm": 3}),
    ]
    assert [o["granted"] for o in outs] == [False, True, False]
    return outs + _raft_view(r)


def case_single_node_is_trivially_leader(p):
    r = p.RaftLite("solo", [], pulse_seconds=0.05)
    r.start()
    try:
        assert r.is_leader()
        st = r.propose(max_volume_id=3)
        assert st["max_volume_id"] == 3
        return [st] + _raft_view(r)
    finally:
        r.stop()


def case_raft_durable_term_and_vote(p, tmp):
    d = os.path.join(tmp, p.name)
    n = p.RaftLite("a:1", ["a:1", "b:2", "c:3"], state_dir=d)
    out = [n.handle_vote({"term": 7, "candidate": "b:2", "version": 0,
                          "vterm": 0})]
    assert out[0]["granted"] is True
    n.state = {"max_volume_id": 41, "seq_ceiling": 900}
    n.version, n.vterm = 5, 7
    n._persist()
    n.stop()
    n2 = p.RaftLite("a:1", ["a:1", "b:2", "c:3"], state_dir=d)
    assert (n2.term, n2.voted_for) == (7, "b:2")
    assert n2.state["max_volume_id"] == 41
    assert n2.version == 5 and n2.vterm == 7
    out.append(n2.handle_vote({"term": 7, "candidate": "c:3", "version": 9,
                               "vterm": 7}))
    out.append(n2.handle_vote({"term": 7, "candidate": "b:2", "version": 9,
                               "vterm": 7}))
    assert [o["granted"] for o in out] == [True, False, True]
    n2.stop()
    with open(os.path.join(d, "raft_state.json"), "rb") as f:
        return out + _raft_view(n2) + [f.read()]


def case_superseded_leader_lease_dies_before_successor_commits(p):
    a = p.RaftLite("a", ["a", "b", "c"], pulse_seconds=0.05, send=_ack)
    a.role, a.term = "leader", 1
    a.propose(max_volume_id=1)
    assert a.is_leader()
    assert a.lease_s < a._timeout_range[0]
    a._send = _down
    a._lease_until -= a._timeout_range[0]
    assert not a.is_leader()
    with pytest.raises(p.NoQuorumError):
        a.propose(max_volume_id=2)
    b = p.RaftLite("b", ["a", "b", "c"], pulse_seconds=0.05,
                   send=_grant_and_ack)
    b.term = 1
    b._campaign()
    assert b.role == "leader" and b.term == 2 and b.is_leader()
    st = b.propose(max_volume_id=7)
    assert st["max_volume_id"] == 7
    assert not a.is_leader()
    return [st] + _raft_view(a) + _raft_view(b)


def case_election_restamps_state_before_claiming_authority(p):
    holder: dict = {}
    appends: list[dict] = []
    leases_at_append: list[float] = []

    def send(peer, path, payload):
        if path == "/raft/vote":
            return {"granted": True, "term": payload["term"]}
        appends.append(dict(payload))
        leases_at_append.append(holder["r"]._lease_until)
        return _ack(peer, path, payload)

    r = p.RaftLite("a", ["a", "b", "c"], pulse_seconds=0.05, send=send)
    holder["r"] = r
    r.state = {"max_volume_id": 9, "seq_ceiling": 40}
    r.version, r.vterm, r.term = 5, 1, 1
    r._campaign()
    assert r.role == "leader" and r.term == 2
    assert appends[0]["version"] == 6 and appends[0]["vterm"] == 2
    assert appends[0]["state"]["max_volume_id"] == 9
    assert all(t == 0.0 for t in leases_at_append)
    assert r.committed_version == 6
    assert r.committed_state["max_volume_id"] == 9
    assert r.is_leader()
    return [sorted(appends, key=json.dumps)] + _raft_view(r)


def case_follower_refuses_and_proxies_mutating_calls(p, monkeypatch):
    r = p.RaftLite("b", ["a", "b", "c"], pulse_seconds=0.05, send=_down)
    r.role, r.leader_url = "follower", "a"
    with pytest.raises(p.NoQuorumError):
        r.propose(max_volume_id=3)
    assert r.leader() == "a"

    class _StubMaster:
        url = "127.0.0.1:9001"
        leader_url = "127.0.0.1:9000"

        def leader(self):
            return self.leader_url

    stub = _StubMaster()
    forwarded: list[tuple] = []

    def fake_request(method, url, body=None, **kw):
        forwarded.append((method, url, body))
        return b'{"ok": true}'

    monkeypatch.setattr(p.http, "request", fake_request)
    req = p.http.Request("POST", "/dir/assign", {"count": ["2"]}, {},
                         body=b"")
    resp = p.MasterServer._proxy_to_leader(stub, req)
    assert resp.status == 200
    assert forwarded == [("POST", "127.0.0.1:9000/dir/assign?count=2",
                          None)]
    stub.leader_url = stub.url
    resp2 = p.MasterServer._proxy_to_leader(stub, req)
    assert resp2.status == 503 and b"no leader" in resp2.body
    return [forwarded, (resp.status, resp.body), (resp2.status, resp2.body)]


CASES = [
    case_uncommitted_ceiling_never_backs_ids,
    case_propose_commits_with_majority,
    case_replication_fanout_is_concurrent,
    case_follower_commits_only_acked_versions,
    case_stale_term_append_rejected,
    case_vote_requires_up_to_date_state,
    case_single_node_is_trivially_leader,
    case_superseded_leader_lease_dies_before_successor_commits,
    case_election_restamps_state_before_claiming_authority,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_raft_case_matches_reference(case):
    assert case(PORT) == case(REF)


def test_raft_durable_term_and_vote_matches_reference(tmp_path):
    assert (case_raft_durable_term_and_vote(PORT, str(tmp_path))
            == case_raft_durable_term_and_vote(REF, str(tmp_path)))


def test_follower_proxy_matches_reference(monkeypatch):
    assert (case_follower_refuses_and_proxies_mutating_calls(PORT,
                                                             monkeypatch)
            == case_follower_refuses_and_proxies_mutating_calls(REF,
                                                                monkeypatch))


# -- (b) the state_dir crosses packages ------------------------------------


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_state_dir_is_interchangeable(tmp_path, writer, reader):
    d = str(tmp_path / "m")
    w = writer.RaftLite("a:1", ["a:1", "b:2", "c:3"], state_dir=d)
    w.handle_vote({"term": 9, "candidate": "c:3", "version": 0, "vterm": 0})
    w.state = {"max_volume_id": 17, "seq_ceiling": 4096}
    w.version, w.vterm = 4, 9
    w._persist()
    w.stop()
    with open(os.path.join(d, "raft_state.json"), "rb") as f:
        written = f.read()
    r = reader.RaftLite("a:1", ["a:1", "b:2", "c:3"], state_dir=d)
    again = writer.RaftLite("a:1", ["a:1", "b:2", "c:3"], state_dir=d)
    assert _raft_view(r) == _raft_view(again)
    again.stop()
    assert (r.term, r.voted_for, r.state, r.version, r.vterm) == (
        9, "c:3", {"max_volume_id": 17, "seq_ceiling": 4096}, 4, 9)
    # no second vote in term 9 from the reloaded node
    assert not r.handle_vote({"term": 9, "candidate": "b:2", "version": 9,
                              "vterm": 9})["granted"]
    # the reader persists the same record as the same bytes
    r._persisted = None
    r.voted_for = "c:3"
    r._persist()
    with open(os.path.join(d, "raft_state.json"), "rb") as f:
        assert f.read() == written
    r.stop()


# -- (c) one mixed raft group ----------------------------------------------

PULSE = 0.1


def _wait_for_leader(masters, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [m for m in masters if m.is_leader]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.05)
    raise AssertionError(
        f"no single leader: {[(m.url, m.is_leader) for m in masters]}")


def test_mixed_raft_group_elects_one_leader(tmp_path):
    """Two port masters and one reference master in one group: exactly
    one leader, every follower names it; the leader dies and the rest
    elect one; the dead one comes back, from its state_dir, as a master
    of the other package and follows."""
    kinds = [PORT, REF, PORT]
    dirs = [str(tmp_path / f"m{i}") for i in range(3)]
    masters = [k.MasterServer(pulse_seconds=PULSE, state_dir=d)
               for k, d in zip(kinds, dirs)]
    peers = sorted(m.url for m in masters)
    for m in masters:
        m.peers = list(peers)
    try:
        for m in masters:
            m.start()
        leader = _wait_for_leader(masters)
        for m in masters:
            assert m.leader() == leader.url
        st = http.get_json(f"{leader.url}/cluster/status")
        assert st["IsLeader"] and st["Leader"] == leader.url
        assert sorted(st["Peers"]) == peers
        # volume ids commit through the mixed group
        vid = leader._commit_vid(5)
        assert vid >= 5
        i = masters.index(leader)
        old_term = leader.raft.term
        leader.stop()
        rest = [m for j, m in enumerate(masters) if j != i]
        new_leader = _wait_for_leader(rest)
        assert new_leader.raft.term > old_term
        assert new_leader.raft.committed_state["max_volume_id"] >= vid
        # the dead master returns at its url, from its own state_dir,
        # as the other package's master
        other = REF if kinds[i] is PORT else PORT
        back = other.MasterServer(
            port=int(leader.url.rsplit(":", 1)[1]), pulse_seconds=PULSE,
            state_dir=dirs[i])
        back.peers = list(peers)
        assert back.url == leader.url
        masters[i] = back
        back.start()
        assert back.raft.term >= old_term
        deadline = time.time() + 15
        while time.time() < deadline and back.leader() != new_leader.url:
            time.sleep(0.05)
        assert back.leader() == new_leader.url and not back.is_leader
        assert _wait_for_leader(masters) is new_leader
    finally:
        for m in masters:
            try:
                m.stop()
            except Exception:  # noqa: BLE001 - one was stopped already
                pass


# -- (d) the cases of tests/test_multi_master.py on port masters ------------


@pytest.fixture()
def trio(tmp_path):
    masters = [port_master.MasterServer(pulse_seconds=PULSE)
               for _ in range(3)]
    peers = sorted(m.url for m in masters)
    for m in masters:
        m.peers = peers
    for m in masters:
        m.start()
    leader = _wait_for_leader(masters)
    vs = VolumeServer(leader.url, [str(tmp_path / "v")], [20],
                      pulse_seconds=PULSE, master_peers=peers, device="cpu")
    vs.start()
    deadline = time.time() + 5
    while time.time() < deadline and not leader.topo.data_nodes():
        time.sleep(0.05)
    yield masters, leader, vs
    vs.stop()
    for m in masters:
        m.stop()
    op_client._lookup_cache.clear()
    port_retry.BREAKERS.reset()


def test_leader_agreement_and_follower_proxy(trio):
    masters, leader, vs = trio
    followers = [m for m in masters if m is not leader]
    assert all(not f.is_leader for f in followers)
    for f in followers:
        assert f.leader() == leader.url
    fid, _ = operation.upload_data(followers[0].url, b"via follower")
    assert operation.read_file(leader.url, fid) == b"via follower"
    st = http.get_json(f"{followers[0].url}/cluster/status")
    assert st["Leader"] == leader.url and not st["IsLeader"]


def test_leader_failover(trio):
    masters, leader, vs = trio
    fid, _ = operation.upload_data(leader.url, b"before failover")
    old_term = leader.raft.term
    leader.stop()
    rest = [m for m in masters if m is not leader]
    new_leader = _wait_for_leader(rest)
    assert new_leader.raft.term > old_term
    deadline = time.time() + 10
    while time.time() < deadline and not new_leader.topo.data_nodes():
        time.sleep(0.1)
    assert new_leader.topo.data_nodes(), "volume server re-registered"
    op_client._lookup_cache.clear()
    assert operation.read_file(new_leader.url, fid) == b"before failover"
    fid2, _ = operation.upload_data(new_leader.url, b"after failover")
    assert operation.read_file(new_leader.url, fid2) == b"after failover"


def _partition(old_leader, others):
    for m in others:
        m.raft.blocked.add(old_leader.url)
        old_leader.raft.blocked.add(m.url)


def _try_assign(master_url):
    try:
        out = http.get_json(f"{master_url}/dir/assign", timeout=2)
        return out if "fid" in out else None
    except http.HttpError:
        return None


def test_partitioned_leader_steps_down_no_duplicate_fids(trio):
    masters, old_leader, vs = trio
    others = [m for m in masters if m is not old_leader]
    fids: list[str] = []
    out = _try_assign(old_leader.url)
    assert out
    fids.append(out["fid"])
    _partition(old_leader, others)
    deadline = time.time() + 12
    stepped_down = False
    while time.time() < deadline:
        out = _try_assign(old_leader.url)
        if out:
            assert not stepped_down, (
                "old leader resumed assigning after losing its lease")
            fids.append(out["fid"])
        else:
            stepped_down = True
            if any(m.is_leader for m in others):
                break
        time.sleep(PULSE / 2)
    assert stepped_down, "partitioned ex-leader never stopped assigning"
    assert not old_leader.is_leader
    new_leader = _wait_for_leader(others)
    deadline = time.time() + 10
    new_out = None
    while time.time() < deadline:
        new_out = _try_assign(new_leader.url)
        if new_out:
            break
        time.sleep(PULSE)
    assert new_out, "new leader cannot assign"
    fids.append(new_out["fid"])
    for _ in range(50):
        out = _try_assign(new_leader.url)
        if out:
            fids.append(out["fid"])
    assert _try_assign(old_leader.url) is None
    keys = [f.split(",")[1][:-8] for f in fids]
    assert len(set(fids)) == len(fids), f"duplicate fid: {fids}"
    assert len(set(keys)) == len(keys), f"duplicate file key: {keys}"
    for m in masters:
        m.raft.blocked.clear()
    deadline = time.time() + 15
    while time.time() < deadline:
        if (not old_leader.is_leader
                and old_leader.leader() == new_leader.url):
            break
        time.sleep(0.1)
    assert old_leader.leader() == new_leader.url
    assert old_leader.raft.term >= new_leader.raft.term


def test_minority_leader_cannot_grow_volumes(trio):
    masters, old_leader, vs = trio
    others = [m for m in masters if m is not old_leader]
    _partition(old_leader, others)
    deadline = time.time() + 10
    while time.time() < deadline and old_leader.is_leader:
        time.sleep(0.05)
    assert not old_leader.is_leader
    with pytest.raises(http.HttpError):
        http.get_json(f"{old_leader.url}/vol/grow?count=1", timeout=2)


def test_sequencer_monotonic_across_failover(trio):
    masters, leader, vs = trio
    keys_before = [
        int(_try_assign(leader.url)["fid"].split(",")[1][:-8], 16)
        for _ in range(5)
    ]
    leader.stop()
    rest = [m for m in masters if m is not leader]
    new_leader = _wait_for_leader(rest)
    deadline = time.time() + 10
    while time.time() < deadline and not new_leader.topo.data_nodes():
        time.sleep(0.1)
    out = None
    deadline = time.time() + 10
    while time.time() < deadline:
        out = _try_assign(new_leader.url)
        if out:
            break
        time.sleep(PULSE)
    assert out, "new leader cannot assign after failover"
    key_after = int(out["fid"].split(",")[1][:-8], 16)
    assert key_after > max(keys_before)


def test_partitioned_follower_topology_reads_marked_stale(trio):
    masters, leader, vs = trio
    follower = next(m for m in masters if m is not leader)
    assert "stale" not in http.get_json(f"{follower.url}/topology")
    assert "stale" not in http.get_json(f"{follower.url}/vol/status")
    for m in masters:
        if m is not follower:
            m.raft.blocked.add(follower.url)
            follower.raft.blocked.add(m.url)
    deadline = time.time() + 10
    while time.time() < deadline and follower.raft.leader():
        time.sleep(0.05)
    assert not follower.raft.leader(), "follower still sees a leader"
    assert http.get_json(f"{follower.url}/topology").get("stale") is True
    assert "stale" not in http.get_json(f"{leader.url}/topology")


# -- (e) the cases of tests/test_tls.py on the port --------------------------


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    return port_tls.generate_test_pki(tmp_path_factory.mktemp("pki"))


@pytest.fixture()
def tls_cluster(pki, tmp_path):
    def sctx():
        return port_tls.server_context(pki["server_cert"],
                                       pki["server_key"], pki["ca"])

    http.configure_client_tls(port_tls.client_context(
        pki["ca"], pki["client_cert"], pki["client_key"]))
    master = port_master.MasterServer(pulse_seconds=0.2, ssl_context=sctx())
    master.start()
    vs = VolumeServer(master.url, [str(tmp_path / "v")], [10],
                      pulse_seconds=0.2, ssl_context=sctx(), device="cpu")
    vs.start()
    try:
        yield master, vs
    finally:
        vs.stop()
        master.stop()
        http.configure_client_tls(None)
        op_client._lookup_cache.clear()
        port_retry.BREAKERS.reset()


def test_mtls_cluster_end_to_end(tls_cluster, pki):
    master, vs = tls_cluster
    deadline = time.time() + 10
    while time.time() < deadline and not master.topo.data_nodes():
        time.sleep(0.05)
    assert master.topo.data_nodes(), "heartbeat over mTLS failed"
    fid, _ = operation.upload_data(master.url, b"over mTLS!")
    assert operation.read_file(master.url, fid) == b"over mTLS!"
    # the reference's client context, from the port's PKI, reads it too
    ctx = ref_tls.client_context(pki["ca"], pki["client_cert"],
                                 pki["client_key"])
    with urllib.request.urlopen(f"https://{master.url}/cluster/status",
                                timeout=5, context=ctx) as r:
        assert json.loads(r.read())["IsLeader"] is True


def test_plaintext_and_certless_clients_rejected(tls_cluster, pki):
    master, _ = tls_cluster
    with pytest.raises(Exception):
        urllib.request.urlopen(f"http://{master.url}/cluster/status",
                               timeout=5)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(pki["ca"])
    ctx.check_hostname = False
    with pytest.raises((ssl.SSLError, urllib.error.URLError,
                        ConnectionError, OSError)):
        urllib.request.urlopen(f"https://{master.url}/cluster/status",
                               timeout=5, context=ctx).read()


def test_harness_kill_master_and_restart(tmp_path):
    """``ClusterHarness(n_masters=3)`` of port masters: the leader dies,
    a survivor takes over, writes go on through the master ring, and
    the dead master comes back at its url as a follower."""
    from seaweedfs_tpu_torch.operation.masters import MasterRing
    from seaweedfs_tpu_torch.server.harness import ClusterHarness

    with ClusterHarness(n_volume_servers=2, n_masters=3, pulse_seconds=PULSE,
                        root=str(tmp_path), device="cpu") as c:
        c.wait_for_nodes(2)
        ring = MasterRing(c.master_urls())
        fid, _ = operation.upload_data(ring, b"before")
        i = c.current_leader_index()
        old_url = c.masters[i].url
        c.kill_master(i)
        new_leader = c.wait_for_leader()
        assert new_leader.url != old_url
        c.wait_for_nodes(2, timeout=15)
        fid2, _ = operation.upload_data(ring, b"after")
        op_client._lookup_cache.clear()
        assert operation.read_file(ring, fid) == b"before"
        assert operation.read_file(ring, fid2) == b"after"
        c.restart_master(i)
        assert c.masters[i].url == old_url
        deadline = time.time() + 15
        while time.time() < deadline and (
                c.masters[i].leader() != new_leader.url):
            time.sleep(0.05)
        assert c.masters[i].leader() == new_leader.url
        assert c.wait_for_leader() is new_leader
    port_retry.BREAKERS.reset()
    op_client._lookup_cache.clear()
