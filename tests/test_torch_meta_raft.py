"""The port's counterpart of tests/test_meta_raft.py: the JAX oracle's cases run
against baikaldb_tpu_torch on the CPU, and the cases at the end run the same
seeded work on both packages and compare.  The oracle's text follows.

Raft-replicated meta service (VERDICT r02 missing #3).

The reference funnels every meta mutation through a raft state machine
(include/meta_server/meta_state_machine.h:22) with a separate TSO FSM whose
snapshot carries the max physical time so timestamps stay monotonic across
failover (tso_state_machine.cpp:237-241).  These tests kill the meta leader
mid-stream and assert no routing/TSO state is lost.
"""

import pytest

from baikaldb_tpu_torch.meta.replicated_meta import MetaUnavailable, ReplicatedMeta
from baikaldb_tpu_torch.meta.service import HeartbeatRequest



def make_meta(**kw):
    return ReplicatedMeta(n_replicas=3, peer_count=3, seed=31, **kw)


def test_mutations_replicate_to_all_replicas():
    m = make_meta()
    for a in ("s1:1", "s2:1", "s3:1"):
        m.add_instance(a)
    metas = m.create_regions(table_id=7, n_regions=2)
    assert len(metas) == 2
    m.bus.pump()
    states = [(sorted(r.service.instances), sorted(r.service.regions))
              for r in m.bus.nodes.values()]
    assert states[0] == states[1] == states[2]
    assert sorted(states[0][1]) == [metas[0].region_id, metas[1].region_id]


def test_leader_kill_preserves_routing_state():
    m = make_meta()
    for a in ("s1:1", "s2:1", "s3:1"):
        m.add_instance(a)
    metas = m.create_regions(table_id=7, n_regions=2)
    hb = HeartbeatRequest("s1:1", {metas[0].region_id: (1, 42)},
                          [metas[0].region_id])
    m.heartbeat(hb)
    dead = m.kill_leader()
    # new leader serves the SAME region registry and heartbeat-updated state
    assert sorted(m.regions) == sorted(r.region_id for r in metas)
    assert m.regions[metas[0].region_id].num_rows == 42
    assert m.regions[metas[0].region_id].leader == "s1:1"
    # and keeps accepting mutations
    more = m.create_regions(table_id=8, n_regions=1)
    assert more[0].region_id not in [r.region_id for r in metas]
    assert m.bus.leader() != dead


def test_tso_monotonic_across_failover():
    m = make_meta()
    seen = [m.tso_gen(10) for _ in range(5)]
    m.kill_leader()
    seen += [m.tso_gen(10) for _ in range(5)]
    m.kill_leader()   # down to exactly quorum (1 of 3 dead? no: 2 dead = no quorum)
    # with 2 of 3 dead there is no quorum: TSO must refuse, not regress
    with pytest.raises(MetaUnavailable):
        m.tso_gen(1)
    assert seen == sorted(seen)
    assert len(set(seen)) == len(seen)


def test_tso_monotonic_after_snapshot_install():
    m = make_meta()
    first = m.tso_gen(100)
    m.compact_all()          # snapshot carries the TSO high-water mark
    m.kill_leader()
    second = m.tso_gen(1)
    assert second > first


def test_region_ids_never_reused_after_drop_and_snapshot():
    m = make_meta()
    for a in ("s1:1", "s2:1", "s3:1"):
        m.add_instance(a)
    metas = m.create_regions(table_id=7, n_regions=2)
    high = max(r.region_id for r in metas)
    m.drop_regions([r.region_id for r in metas])
    m.compact_all()
    m.kill_leader()
    fresh = m.create_regions(table_id=9, n_regions=1)
    assert fresh[0].region_id > high


def test_fleet_control_loop_over_replicated_meta():
    """The store fleet's heartbeat/balance loop works unchanged against the
    raft-replicated meta (the facade keeps the MetaService API)."""
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    meta = make_meta()
    fleet = StoreFleet(meta, ["a:1", "b:1", "c:1"], seed=13)
    fleet.create_table_regions(table_id=1, n_regions=2)
    n = fleet.control_tick()      # heartbeats in, orders out, applied
    assert n >= 0
    # meta leader failover mid-operation: the loop keeps going
    meta.kill_leader()
    assert fleet.control_tick() >= 0
    assert len(meta.regions) == 2


def test_reads_survive_meta_quorum_loss():
    """Meta down must not stop data-path reads: routing hints degrade to
    live elections (the reference serves reads off cached SchemaFactory
    routing when meta is unreachable)."""
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    meta = make_meta()
    fleet = StoreFleet(meta, ["a:1", "b:1", "c:1"], seed=13)
    s = Session(Database("cpu", fleet=fleet))
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1, 1.0), (2, 2.0)")
    meta.kill_leader()
    meta.kill_leader()          # 2 of 3 dead: no meta quorum
    with pytest.raises(MetaUnavailable):
        meta.tso_gen(1)
    assert s.query("SELECT id FROM t ORDER BY id") == [{"id": 1}, {"id": 2}]
    # the replicated tier's scan path (fresh frontend rebuild) also holds
    tier = fleet.row_tiers["default.t"]
    assert tier.num_rows() == 2


def test_sql_on_fleet_with_replicated_meta():
    """End-to-end: SQL DML over a fleet whose placement/routing comes from
    the raft-replicated meta, surviving a meta leader kill."""
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    meta = make_meta()
    fleet = StoreFleet(meta, ["a:1", "b:1", "c:1"], seed=13)
    s = Session(Database("cpu", fleet=fleet))
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1, 1.0), (2, 2.0)")
    meta.kill_leader()
    s.execute("INSERT INTO t VALUES (3, 3.0)")
    assert s.query("SELECT COUNT(*) n FROM t") == [{"n": 3}]


def test_duplicate_command_uid_applies_once():
    """A re-proposed copy of an already-applied command must be served from
    the dedup record, not applied twice: a duplicated alloc_ids would hand
    two coordinators the same txn-id range shifted, and a duplicated split
    would mint overlapping regions (ADVICE r03 low #4)."""
    import json

    m = make_meta()
    ldr = m.leader_replica()
    payload = json.dumps({"op": "alloc_ids", "table_id": 9, "n": 5,
                          "floor": 0, "_uid": "dup-1"}).encode()
    i1 = ldr.core.propose(payload)
    i2 = ldr.core.propose(payload)
    assert i1 >= 0 and i2 >= 0
    m.bus.pump()
    assert ldr.results[i1] == ldr.results[i2]       # second = dedup'd
    # the allocator advanced once, not twice
    fresh = m.alloc_ids(table_id=9, n=1)
    assert fresh == ldr.results[i1] + 5


def test_dedup_memory_survives_snapshot_install():
    """The uid dedup set rides the snapshot: a replica that catches up via
    snapshot must still recognize a late re-proposed copy."""
    import json

    m = make_meta()
    ldr = m.leader_replica()
    payload = json.dumps({"op": "alloc_ids", "table_id": 3, "n": 4,
                          "floor": 0, "_uid": "snap-dup"}).encode()
    i1 = ldr.core.propose(payload)
    assert i1 >= 0
    m.bus.pump()
    before = m.alloc_ids(table_id=3, n=1)
    for node in m.bus.nodes.values():
        node.compact()
    m.bus.pump()
    # replay the same uid AFTER everyone snapshotted
    i2 = m.leader_replica().core.propose(payload)
    assert i2 >= 0
    m.bus.pump()
    after = m.alloc_ids(table_id=3, n=1)
    assert after == before + 1                       # no second allocation


# -- differential: the same seeded meta group on the JAX package ------------

def _meta_trace(mod):
    m = mod.ReplicatedMeta(n_replicas=3, peer_count=3, seed=31)
    for a in ("s1:1", "s2:1", "s3:1"):
        m.add_instance(a)
    metas = m.create_regions(table_id=7, n_regions=3)
    out = [("regions", [(r.region_id, sorted(r.peers)) for r in metas])]
    m.kill_leader()
    more = m.create_regions(table_id=8, n_regions=1)
    out.append(("after_kill", [r.region_id for r in more]))
    m.drop_regions([r.region_id for r in metas[:2]])
    out.append(("left", sorted(m.regions)))
    return out


def test_seeded_meta_group_matches_jax():
    import baikaldb_tpu.meta.replicated_meta as jrm
    import baikaldb_tpu_torch.meta.replicated_meta as trm

    assert _meta_trace(trm) == _meta_trace(jrm)
