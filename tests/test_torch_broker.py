"""The port's message broker (``messaging/broker.py``) held against the
reference's on the CPU.

``partition_of`` and ``owner_of`` agree with the reference's on 10,000
seeded keys. One seeded publish/subscribe sequence goes to a broker of
each package over a filer of each package, all four pairings (the two
mixed ones included): the same partitions, offsets and payloads, with
the wall-clock ``ts_ns`` of each message masked. A restarted broker of
each package recovers the same next offset of every partition from its
segments, and continues the sequence there. The port's
``BrokerQueue`` publishes into a live port broker. Then the
reference's membership cases through port brokers: ownership spreads by
rendezvous hashing, a publish through a non-owner is proxied, every
broker serves the same subscription, a dead owner's partition re-homes
on the next publish with its offsets continued, and the liveness
refresh uploads no needle. Waits poll, as the reference's tests do;
no case asserts a wall-clock budget.
"""

import json
import random
import time

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.messaging import broker as ref_broker  # noqa: E402
from seaweedfs_tpu.notification import publisher as ref_pub  # noqa: E402
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefHarness,
)
from seaweedfs_tpu_torch.messaging import broker as port_broker  # noqa: E402
from seaweedfs_tpu_torch.notification import (  # noqa: E402
    publisher as port_pub,
)
from seaweedfs_tpu_torch.server.harness import (  # noqa: E402
    ClusterHarness as PortHarness,
)
from seaweedfs_tpu_torch.util import http  # noqa: E402

torch.set_num_threads(2)

BROKERS = {"ref": ref_broker, "port": port_broker}


@pytest.mark.parametrize("count", [1, 4, 7, 16])
def test_partition_of_matches_reference(count):
    rng = random.Random(count)
    keys = [rng.randbytes(rng.randrange(0, 40)) for _ in range(10_000)]
    got = [port_broker.partition_of(k, count) for k in keys]
    assert got == [ref_broker.partition_of(k, count) for k in keys]
    assert set(got) == set(range(count))


def test_owner_of_matches_reference():
    rng = random.Random(5)
    pool = [f"127.0.0.1:{8000 + i}" for i in range(9)]
    for i in range(10_000):
        brokers = rng.sample(pool, rng.randrange(1, len(pool) + 1))
        args = (f"ns{i % 3}", f"topic-{rng.randrange(50)}",
                rng.randrange(8), brokers)
        assert port_broker.owner_of(*args) == ref_broker.owner_of(*args)


@pytest.fixture(scope="module")
def filers(tmp_path_factory):
    """A filer of each package over its own cluster."""
    root = tmp_path_factory.mktemp("brokers")
    with RefHarness(n_volume_servers=1, volumes_per_server=12,
                    root=str(root / "ref"), with_filer=True) as ref, \
            PortHarness(n_volume_servers=1, volumes_per_server=12,
                        root=str(root / "port"), device="cpu",
                        with_filer=True) as port:
        ref.wait_for_nodes(1)
        port.wait_for_nodes(1)
        yield {"ref": ref.filer.url, "port": port.filer.url}


def _masked(out):
    """A subscribe answer with each message's wall-clock stamp masked."""
    return {**out, "messages": [{**m, "ts_ns": "<t>"}
                                for m in out["messages"]]}


def _session(mod, filer_url, ns, seed):
    """One seeded session against a fresh broker of ``mod``: publishes,
    subscribes from 0 and from the middle of each partition, the topic
    listing; then the broker stops (persisting its tails), a fresh one
    recovers each partition's next offset from the segments and takes
    three more publishes."""
    rng = random.Random(seed)
    keys = [f"key-{i}" for i in range(12)]
    out = {"published": [], "subscribed": {}}
    b = mod.MessageBroker(filer_url, flush_every=3)
    b.start()
    try:
        for i in range(60):
            body = {"namespace": ns, "topic": "events",
                    "key": rng.choice(keys),
                    "value": f"v{i}-{rng.randrange(1 << 30):08x}"}
            if i % 7 == 0:
                body["headers"] = {"n": str(i)}
            out["published"].append(
                http.post_json(f"http://{b.url}/publish", body))
        for p in range(4):
            for since, limit in ((0, 100), (3, 5)):
                got = http.get_json(
                    f"http://{b.url}/subscribe?namespace={ns}&topic=events"
                    f"&partition={p}&offset={since}&limit={limit}")
                out["subscribed"][f"{p}/{since}/{limit}"] = _masked(got)
        out["topics"] = http.get_json(
            f"http://{b.url}/topics?namespace={ns}")
    finally:
        b.stop()
    b2 = mod.MessageBroker(filer_url, flush_every=3)
    b2.start()
    try:
        out["recovered"] = [b2._recover_next_offset((ns, "events", p))
                            for p in range(4)]
        out["after_restart"] = [
            http.post_json(f"http://{b2.url}/publish",
                           {"namespace": ns, "topic": "events",
                            "key": keys[j], "value": f"late-{j}"})
            for j in (0, 5, 11)]
        out["replayed"] = {
            p: _masked(http.get_json(
                f"http://{b2.url}/subscribe?namespace={ns}&topic=events"
                f"&partition={p}&offset=0&limit=1000"))
            for p in range(4)}
    finally:
        b2.stop()
    return out


@pytest.mark.parametrize("filer_side", ["ref", "port"])
def test_publish_subscribe_matches_reference(filers, filer_side):
    """Each package's broker over the ``filer_side`` filer (one pairing
    of each case is mixed): equal answers, message for message."""
    got = {name: _session(mod, filers[filer_side],
                          f"ns-{name}-on-{filer_side}", 11)
           for name, mod in BROKERS.items()}
    assert got["port"] == got["ref"]
    run = got["port"]
    per_part: dict[int, list[int]] = {}
    for p in run["published"]:
        per_part.setdefault(p["partition"], []).append(p["offset"])
    assert len(per_part) > 1
    for seq in per_part.values():
        assert seq == list(range(len(seq)))
    # the restarted broker continues each partition where it stopped
    assert run["recovered"] == [len(per_part.get(p, [])) for p in range(4)]
    nxt = list(run["recovered"])
    for p in run["after_restart"]:
        assert p["offset"] == nxt[p["partition"]]
        nxt[p["partition"]] += 1
    for p, sub in run["replayed"].items():
        assert [m["offset"] for m in sub["messages"]] == list(
            range(len(sub["messages"])))
    assert run["topics"] == {"topics": ["events"]}


def test_recovery_failure_refuses_the_publish(filers):
    """A failed segment listing raises ``OffsetRecoveryError`` and the
    publish answers 503 in both packages, never minting offset 0."""
    got = {}
    for name, mod in BROKERS.items():
        b = mod.MessageBroker(filers["port"], flush_every=3)
        b.start()
        try:
            def broken(seg_dir, _e=mod.OffsetRecoveryError):
                raise _e(f"listing {seg_dir} failed: injected")

            b._list_segments = broken
            with pytest.raises(http.HttpError) as e:
                http.post_json(f"http://{b.url}/publish",
                               {"namespace": f"fail-{name}",
                                "topic": "t", "key": "k", "value": "v"})
            got[name] = (e.value.status,
                         "offset recovery failed" in str(e.value))
        finally:
            b.stop()
    assert got["port"] == got["ref"] == (503, True)


def test_broker_queue_end_to_end(filers):
    """Filer meta events through each package's ``BrokerQueue`` into a
    live port broker, read back by a subscriber."""
    b = port_broker.MessageBroker(filers["port"])
    b.start()
    try:
        for name, pub in (("port", port_pub), ("ref", ref_pub)):
            q = pub.BrokerQueue(b.url, topic=f"meta-{name}")
            q.send("/k", {"event_type": "write", "ts_ns": 1})
            q.send("/k", {"event_type": "delete", "ts_ns": 2})
            part = port_broker.partition_of(b"/k", b.partition_count)
            out = http.get_json(f"http://{b.url}/subscribe?topic=meta-{name}"
                                f"&partition={part}&offset=0")
            assert [json.loads(m["value"]) for m in out["messages"]] == [
                {"event_type": "write", "ts_ns": 1},
                {"event_type": "delete", "ts_ns": 2}]
            assert [m["key"] for m in out["messages"]] == ["/k", "/k"]
        # a broker that is gone: notification stays best-effort
        port_pub.BrokerQueue("127.0.0.1:9").send("/k", {"ts_ns": 3})
    finally:
        b.stop()


def _converged(brokers, timeout=60.0):
    """Poll until every broker's membership view holds all of them."""
    deadline = time.monotonic() + timeout
    while True:
        views = [set(http.get_json(f"http://{b}/cluster")["brokers"])
                 for b in brokers]
        if all(set(brokers) <= v for v in views):
            return
        assert time.monotonic() < deadline, "membership never converged"
        time.sleep(0.2)


def test_multi_broker_distribution(filers):
    """Three port brokers over one filer (the reference's
    ``test_multi_broker_consistent_distribution``): the reference's
    ``owner_of`` spreads the topic's partitions, a publish through a
    non-owner is proxied with sequential offsets, and every broker
    serves the same subscription."""
    bs = [port_broker.MessageBroker(filers["port"], flush_every=3)
          for _ in range(3)]
    for b in bs:
        b.start()
    try:
        urls = sorted(b.url for b in bs)
        _converged(urls)
        owners = {ref_broker.owner_of("default", "hrwtopic", p, urls)
                  for p in range(4)}
        assert len(owners) >= 2
        offsets = [http.post_json(f"http://{bs[1].url}/publish",
                                  {"topic": "hrwtopic", "key": f"k{i}",
                                   "value": f"v{i}"})
                   for i in range(9)]
        per_part: dict[int, list[int]] = {}
        for o in offsets:
            per_part.setdefault(o["partition"], []).append(o["offset"])
        for seq in per_part.values():
            assert seq == list(range(len(seq)))
        part = offsets[0]["partition"]
        views = [[(m["key"], m["value"]) for m in http.get_json(
            f"http://{b.url}/subscribe?topic=hrwtopic&partition={part}"
            "&offset=0")["messages"]] for b in bs]
        assert views[0] and views[0] == views[1] == views[2]
    finally:
        for b in bs:
            b.stop()


def test_failover_on_owner_death(filers):
    """The reference's ``test_broker_failover_on_owner_death`` through
    port brokers: the owner dies after persisting five messages, and
    the next publish through the survivor re-homes the partition and
    continues its offsets; a subscriber sees all ten exactly once."""
    b1 = port_broker.MessageBroker(filers["port"], flush_every=1)
    b2 = port_broker.MessageBroker(filers["port"], flush_every=1)
    b1.start()
    b2.start()
    killed = False
    try:
        urls = sorted({b1.url, b2.url})
        _converged(urls)
        topic = next(t for t in (f"failtopic{j}" for j in range(64))
                     if any(port_broker.owner_of("default", t, p, urls)
                            == b2.url for p in range(4)))
        key = next(f"fk{i}" for i in range(256) if port_broker.owner_of(
            "default", topic,
            port_broker.partition_of(f"fk{i}".encode(), 4), urls) == b2.url)
        part = port_broker.partition_of(key.encode(), 4)

        def publish(i):
            return http.post_json(f"http://{b1.url}/publish",
                                  {"topic": topic, "key": key,
                                   "value": f"m{i}"})

        outs = [publish(i) for i in range(5)]
        assert all(o["partition"] == part for o in outs)
        seg_dir = f"/topics/default/{topic}/{part:02d}"
        deadline = time.monotonic() + 60
        while True:
            persisted = 0
            try:
                for e in http.get_json(f"http://{filers['port']}{seg_dir}/"
                                       "?limit=1000").get("Entries") or []:
                    if e["FullPath"].endswith(".seg"):
                        persisted += len(http.request(
                            "GET", f"http://{filers['port']}"
                            f"{e['FullPath']}").splitlines())
            except http.HttpError:
                pass
            if persisted >= 5:
                break
            assert time.monotonic() < deadline, "the owner never persisted"
            time.sleep(0.1)
        b2._running = False
        b2._flush_event.set()
        b2.server.stop()
        killed = True
        outs += [publish(i) for i in range(5, 10)]
        assert [o["offset"] for o in outs] == list(range(10))
        out = http.get_json(f"http://{b1.url}/subscribe?topic={topic}"
                            f"&partition={part}&offset=0")
        assert [m["value"] for m in out["messages"]] == [
            f"m{i}" for i in range(10)]
    finally:
        if not killed:
            b2.server.stop()
        b2._running = False
        b1.stop()


def test_liveness_is_metadata_only(filers):
    """Registration entries stay chunkless: the pulse uploads no
    needle (the reference's ``test_broker_liveness_is_metadata_only``)."""
    b = port_broker.MessageBroker(filers["port"])
    b.start()
    try:
        name = b.url.replace(":", "_")
        path = f"{port_broker.BROKERS_DIR}/{name}"
        meta = http.get_json(f"http://{filers['port']}{path}?meta=true")
        assert meta.get("chunks") == []
        text = http.request("GET", f"http://{b.url}/metrics").decode()
        assert "seaweedfs_broker_publish_total" in text
        assert "seaweedfs_broker_subscribe_total" in text
    finally:
        b.stop()
