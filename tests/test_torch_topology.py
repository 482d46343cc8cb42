"""The port's cluster model (``topology/``) held against the reference on
the CPU.

Every case of ``tests/test_topology.py`` runs once through each package
on the same fabricated heartbeats, with the same seeded
``random.Random`` handed to both: the answers (node ids picked, vids,
counters, layouts, errors) must be identical. Placement picks through
its ``rng`` argument only, so nothing here touches the stdlib
``random`` module's shared state. Also a 100-node growth walk (the
``tests/test_scale_placement.py`` topology) placed volume by volume, and
``to_topology_info`` key for key."""

import random
import types

import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.pb import messages as ref_msgs  # noqa: E402
from seaweedfs_tpu.storage import types as ref_t  # noqa: E402
from seaweedfs_tpu.topology import node as ref_node  # noqa: E402
from seaweedfs_tpu.topology import topology as ref_topology  # noqa: E402
from seaweedfs_tpu.topology import volume_growth as ref_growth  # noqa: E402
from seaweedfs_tpu.topology import volume_layout as ref_layout  # noqa: E402
from seaweedfs_tpu_torch.pb import messages as port_msgs  # noqa: E402
from seaweedfs_tpu_torch.storage import types as port_t  # noqa: E402
from seaweedfs_tpu_torch.topology import node as port_node  # noqa: E402
from seaweedfs_tpu_torch.topology import (  # noqa: E402
    topology as port_topology,
)
from seaweedfs_tpu_torch.topology import (  # noqa: E402
    volume_growth as port_growth,
)
from seaweedfs_tpu_torch.topology import (  # noqa: E402
    volume_layout as port_layout,
)

torch.set_num_threads(2)


def _pkg(name, msgs, t, node, topology, growth, layout):
    return types.SimpleNamespace(
        name=name, Heartbeat=msgs.Heartbeat,
        Vol=msgs.VolumeInformationMessage,
        Ec=msgs.EcShardInformationMessage, t=t,
        Topology=topology.Topology, VolumeGrowth=growth.VolumeGrowth,
        VolumeGrowOption=growth.VolumeGrowOption,
        NoFreeSpaceError=node.NoFreeSpaceError,
        NoWritableVolumeError=layout.NoWritableVolumeError,
    )


REF = _pkg("ref", ref_msgs, ref_t, ref_node, ref_topology, ref_growth,
           ref_layout)
PORT = _pkg("port", port_msgs, port_t, port_node, port_topology,
            port_growth, port_layout)

SPEC = {
    "dc1": {
        "r1": [("10.0.0.1", 8080, 10), ("10.0.0.2", 8080, 10)],
        "r2": [("10.0.0.3", 8080, 10), ("10.0.0.4", 8080, 10)],
    },
    "dc2": {
        "r3": [("10.0.1.1", 8080, 10), ("10.0.1.2", 8080, 10)],
        "r4": [("10.0.1.3", 8080, 10)],
    },
}


def build_topology(p, spec: dict):
    topo = p.Topology()
    for dc_name, racks in spec.items():
        for rack_name, nodes in racks.items():
            for ip, port, max_count in nodes:
                topo.register_data_node(p.Heartbeat(
                    ip=ip, port=port, max_volume_count=max_count,
                    data_center=dc_name, rack=rack_name,
                ))
    return topo


def _grown_volumes():
    grown = []

    def allocate(dn, vid, option):
        grown.append((dn.id, vid))

    return grown, allocate


def _counters(node):
    return (node.volume_count, node.active_volume_count,
            node.ec_shard_count, node.max_volume_count, node.max_volume_id)


# -- the cases of tests/test_topology.py, one observation list each -------


def case_register_and_counters(p):
    topo = build_topology(p, SPEC)
    assert topo.max_volume_count == 70
    assert len(topo.data_nodes()) == 7
    dn = topo.find_data_node("10.0.0.1:8080")
    assert dn is not None and dn.available_space() == 10
    return [_counters(topo), [n.id for n in topo.data_nodes()],
            [_counters(dc) for dc in topo.children.values()]]


def case_heartbeat_full_sync_register_unregister(p):
    topo = build_topology(p, SPEC)
    dn = topo.find_data_node("10.0.0.1:8080")
    hb = p.Heartbeat(
        ip="10.0.0.1", port=8080, max_volume_count=10,
        volumes=[p.Vol(id=1, size=100), p.Vol(id=2, size=100,
                                              collection="c")],
    )
    new, deleted = topo.sync_data_node_registration(hb, dn)
    assert sorted(new) == [1, 2] and deleted == []
    assert topo.lookup("", 1)[0].id == "10.0.0.1:8080"
    assert topo.lookup("c", 2)[0].id == "10.0.0.1:8080"
    obs = [sorted(new), deleted, _counters(topo), _counters(dn)]
    hb2 = p.Heartbeat(ip="10.0.0.1", port=8080, max_volume_count=10,
                      volumes=[p.Vol(id=1, size=100)])
    new, deleted = topo.sync_data_node_registration(hb2, dn)
    assert new == [] and deleted == [2]
    assert topo.lookup("c", 2) == []
    obs += [new, deleted, _counters(topo)]
    topo.unregister_data_node(dn)
    assert topo.lookup("", 1) == []
    assert len(topo.data_nodes()) == 6
    return obs + [_counters(topo), [n.id for n in topo.data_nodes()]]


def case_ec_shard_sync(p):
    topo = build_topology(p, SPEC)
    dn = topo.find_data_node("10.0.0.1:8080")
    topo.sync_data_node_ec_shards([p.Ec(id=5, ec_index_bits=0b111)], dn)
    locs = topo.lookup_ec_shards(5)
    assert locs is not None
    first = [len(s) for s in locs.locations]
    assert first[:4] == [1, 1, 1, 0]
    topo.sync_data_node_ec_shards([p.Ec(id=5, ec_index_bits=0b011)], dn)
    locs = topo.lookup_ec_shards(5)
    assert [len(s) for s in locs.locations[:4]] == [1, 1, 0, 0]
    assert dn.ec_shard_count == 2
    return [first, [len(s) for s in locs.locations], _counters(topo),
            dn.ec_shards, dn.ec_collections]


SPREADS = [
    ("000", {"dcs": 1, "racks": 1, "nodes": 1}),
    ("001", {"dcs": 1, "racks": 1, "nodes": 2}),
    ("010", {"dcs": 1, "racks": 2, "nodes": 2}),
    ("100", {"dcs": 2, "racks": 2, "nodes": 2}),
    ("110", {"dcs": 2, "racks": 3, "nodes": 3}),
]


def case_growth_placement_spread(p, replication, expect_spread):
    topo = build_topology(p, SPEC)
    grown, allocate = _grown_volumes()
    vg = p.VolumeGrowth(allocate, random.Random(42))
    option = p.VolumeGrowOption(
        replica_placement=p.t.ReplicaPlacement.parse(replication))
    servers = vg.find_empty_slots_for_one_volume(topo, option)
    rp = p.t.ReplicaPlacement.parse(replication)
    assert len(servers) == rp.copy_count
    assert len({s.id for s in servers}) == expect_spread["nodes"]
    assert len({s.parent.id for s in servers}) == expect_spread["racks"]
    assert len({s.parent.parent.id for s in servers}) == expect_spread["dcs"]
    return [s.id for s in servers]


def case_growth_registers_writable(p):
    topo = build_topology(p, SPEC)
    grown, allocate = _grown_volumes()
    vg = p.VolumeGrowth(allocate, random.Random(1))
    option = p.VolumeGrowOption(
        replica_placement=p.t.ReplicaPlacement.parse("001"))
    count = vg.automatic_grow_by_type(option, topo)
    assert count == 12
    layout = topo.get_volume_layout(
        "", p.t.ReplicaPlacement.parse("001"), p.t.TTL())
    assert layout.active_volume_count == 6
    vid, locations = layout.pick_for_write(random.Random(3))
    assert len(locations) == 2
    return [count, grown, list(layout.writables), vid,
            [d.id for d in locations], _counters(topo)]


def case_growth_impossible_placement(p):
    topo = build_topology(p, {"dc1": {"r1": [("h", 1, 5)]}})
    grown, allocate = _grown_volumes()
    vg = p.VolumeGrowth(allocate, random.Random(1))
    with pytest.raises(p.NoFreeSpaceError) as e:
        vg.find_empty_slots_for_one_volume(topo, p.VolumeGrowOption(
            replica_placement=p.t.ReplicaPlacement.parse("100")))
    return [str(e.value), grown]


def case_pick_for_write_no_volumes(p):
    topo = build_topology(p, SPEC)
    with pytest.raises(p.NoWritableVolumeError) as e:
        topo.pick_for_write()
    return [str(e.value)]


def case_oversized_volume_leaves_writable(p):
    topo = build_topology(p, SPEC)
    dn = topo.find_data_node("10.0.0.1:8080")
    layout = topo.get_volume_layout("", p.t.ReplicaPlacement(), p.t.TTL())
    v = p.Vol(id=9, size=10)
    dn.add_or_update_volume(v)
    layout.register_volume(v, dn)
    assert 9 in layout.writables
    layout.register_volume(p.Vol(id=9, size=topo.volume_size_limit), dn)
    assert 9 not in layout.writables
    return [list(layout.writables), sorted(layout.oversized_volumes)]


def case_next_volume_id_monotonic(p):
    topo = build_topology(p, SPEC)
    a = topo.next_volume_id()
    b = topo.next_volume_id()
    assert b == a + 1
    dn = topo.find_data_node("10.0.0.1:8080")
    dn.add_or_update_volume(p.Vol(id=100))
    c = topo.next_volume_id()
    assert c == 101
    return [a, b, c, topo.max_volume_id]


CASES = [
    case_register_and_counters,
    case_heartbeat_full_sync_register_unregister,
    case_ec_shard_sync,
    case_growth_registers_writable,
    case_growth_impossible_placement,
    case_pick_for_write_no_volumes,
    case_oversized_volume_leaves_writable,
    case_next_volume_id_monotonic,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_topology_case_matches_reference(case):
    assert case(PORT) == case(REF)


@pytest.mark.parametrize("replication,expect_spread", SPREADS,
                         ids=[r for r, _ in SPREADS])
def test_growth_placement_spread_matches_reference(replication,
                                                   expect_spread):
    assert (case_growth_placement_spread(PORT, replication, expect_spread)
            == case_growth_placement_spread(REF, replication,
                                            expect_spread))


# -- at fleet size: 5 dcs x 4 racks x 5 servers ----------------------------


def _fleet(p):
    topo = p.Topology()
    for i in range(100):
        topo.register_data_node(p.Heartbeat(
            ip="127.0.0.1", port=10000 + i, data_center=f"dc{i // 20}",
            rack=f"rack{(i // 5) % 4}", max_volume_count=8,
        ))
    return topo


@pytest.mark.parametrize("replication", ["000", "001", "010", "100", "110",
                                         "200"])
def test_fleet_growth_places_every_volume_as_the_reference(replication):
    def run(p):
        topo = _fleet(p)
        grown, allocate = _grown_volumes()
        vg = p.VolumeGrowth(allocate, rng=random.Random(42))
        option = p.VolumeGrowOption(
            replica_placement=p.t.ReplicaPlacement.parse(replication))
        n = vg.grow_by_count_and_type(60, option, topo)
        return [n, grown, topo.to_topology_info()]

    port, ref = run(PORT), run(REF)
    assert port[0] == 60 * PORT.t.ReplicaPlacement.parse(
        replication).copy_count
    assert port == ref


def test_topology_info_and_ec_map_match_the_reference():
    """One heartbeat history (full syncs, deltas, EC syncs, a node's
    death) gives the same ``to_topology_info`` dict and EC lookups."""
    def run(p):
        topo = build_topology(p, SPEC)
        rng = random.Random(7)
        obs = []
        for step in range(40):
            dn = rng.choice(topo.data_nodes())
            vids = rng.sample(range(1, 30), rng.randint(0, 5))
            hb = p.Heartbeat(
                ip=dn.ip, port=dn.port, max_volume_count=10,
                volumes=[p.Vol(id=v, size=1000 * v,
                               collection=("", "c")[v % 2],
                               read_only=v % 5 == 0) for v in vids],
                has_no_volumes=not vids,
            )
            obs.append(topo.sync_data_node_registration(hb, dn))
            bits = rng.getrandbits(14)
            topo.sync_data_node_ec_shards(
                [p.Ec(id=40 + step % 3, collection="e", ec_index_bits=bits)],
                dn)
            if step == 30:
                topo.unregister_data_node(dn)
        for vid in range(40, 43):
            locs = topo.lookup_ec_shards(vid)
            obs.append(None if locs is None else
                       [[d.id for d in lst] for lst in locs.locations])
        obs.append(topo.to_topology_info())
        return obs

    assert run(PORT) == run(REF)
