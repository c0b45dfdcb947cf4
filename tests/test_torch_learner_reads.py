"""The port's counterpart of tests/test_learner_reads.py: the JAX oracle's cases run
against baikaldb_tpu_torch on the CPU, and the cases at the end run the same
seeded work on both packages and compare.  The oracle's text follows.

Learner replicas + follower reads (VERDICT r03 missing #4 / next #7).

Reference: learner (non-voting) replicas on regions
(include/store/region.h:261-267), frontends choosing follower/learner
replicas for reads with resource isolation by instance tag
(src/exec/fetcher_store.cpp:351 choose_opt_instance), learner balancing
(region_manager.cpp:197).  Here: learners live in the native raft core
(replicated to, never counted for quorum, never electing), the tier read
path picks a non-leader replica under a bounded applied-index staleness
check, and resource tags pin reads to isolated instances.
"""

import pytest

from baikaldb_tpu_torch.exec.session import Database, Session
from baikaldb_tpu_torch.raft.cluster import RaftGroup



def rows_of(g, nid=None):
    nid = nid if nid is not None else g.leader()
    return {r["k"]: r["v"] for r in g.bus.nodes[nid].rows()}


def put(g, k, v):
    rep = g.bus.nodes[g.leader()]
    row = {"k": k, "v": v}
    assert g.write([(0, rep.table.key_codec.encode_one(row),
                     rep.table.row_codec.encode(row))])


# -- raft-core semantics ---------------------------------------------------

def test_learner_replicates_but_never_votes_or_leads():
    g = RaftGroup(region_id=1, peer_ids=[1, 2, 3], seed=5)
    put(g, 1, "a")
    assert g.add_learner(9)
    put(g, 2, "b")
    g.bus.advance(3)
    # the learner applied every commit
    assert rows_of(g, 9) == {1: "a", 2: "b"}
    ldr = g.leader()
    assert g.bus.nodes[ldr].core.learners() == [9]
    # a dead learner never blocks quorum
    g.bus.kill(9)
    put(g, 3, "c")
    g.bus.revive(9)
    g.bus.advance(3)
    assert rows_of(g, 9)[3] == "c"          # caught right back up
    # kill the leader: a VOTER wins the election, never the learner
    g.bus.kill(ldr)
    new = g.bus.elect()
    assert new != 9 and new in (set(g.bus.nodes) - {ldr, 9})
    put(g, 4, "d")
    assert rows_of(g)[4] == "d"


def test_learner_survives_snapshot_catchup():
    g = RaftGroup(region_id=2, peer_ids=[1, 2, 3], seed=7)
    for i in range(5):
        put(g, i, f"v{i}")
    assert g.add_learner(9)
    g.bus.advance(2)
    # compact everyone, then verify membership survives a snapshot install
    for node in g.bus.nodes.values():
        node.compact()
    g.bus.kill(9)
    for i in range(5, 10):
        put(g, i, f"v{i}")
    for nid in list(g.bus.nodes):
        if nid != 9:
            g.bus.nodes[nid].compact()     # log truncated past learner
    g.bus.revive(9)
    g.bus.advance(5)
    assert rows_of(g, 9) == {i: f"v{i}" for i in range(10)}
    assert g.bus.nodes[g.leader()].core.learners() == [9]


def test_promote_learner_to_voter():
    g = RaftGroup(region_id=3, peer_ids=[1, 2, 3], seed=9)
    put(g, 1, "x")
    assert g.add_learner(9)
    g.bus.advance(2)
    # promotion: add_peer on an existing learner
    ldr = g.leader()
    import struct
    from baikaldb_tpu_torch.raft.core import CONFIG

    idx = g.bus.nodes[ldr].core.propose(struct.pack("<Bq", 0, 9),
                                        kind=CONFIG)
    assert idx > 0
    g.bus.advance(5)
    core = g.bus.nodes[g.leader()].core
    assert 9 in core.peers() and core.learners() == []


# -- tier read path --------------------------------------------------------

def fleet_session():
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    meta = MetaService(peer_count=3)
    fleet = StoreFleet(meta, ["a:1", "b:1", "c:1"], seed=41)
    return Session(Database("cpu", fleet=fleet)), fleet


def test_follower_read_bounded_staleness():
    """Reads served by a follower while the leader takes writes; a replica
    lagging past the bound is never chosen (applied-index check)."""
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(10):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    tier = fleet.row_tiers["default.t"]
    g = tier.groups[0]
    ldr = g.leader()
    followers = [n for n in g.bus.nodes if n != ldr]
    # cut one follower off, keep writing through the remaining quorum
    g.bus.partition([followers[0]], [n for n in g.bus.nodes
                                     if n != followers[0]])
    for i in range(10, 20):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    # the lagging follower is beyond any reasonable bound; the healthy one
    # qualifies — the follower read returns COMPLETE data
    rows = tier.follower_rows(max_lag=0)
    ids = {r["id"] for r in rows if not r.get("__del")}
    assert ids == set(range(20))
    picked = tier._pick_read_replica(g, 0, "")
    assert picked.node_id != ldr            # a follower actually served
    assert picked.node_id != followers[0]   # and not the lagging one
    # the cut follower really is behind the bound
    lag_node = g.bus.nodes[followers[0]]
    assert g.bus.nodes[ldr].core.commit_index - lag_node.applied_index > 0
    g.bus.heal()
    # no replica matches an unknown resource tag: fall back to the leader
    picked = tier._pick_read_replica(g, 10 ** 6, "no-such-tag")
    assert picked.node_id == g.leader()


def test_resource_isolated_learner_reads():
    """An OLAP-tagged learner instance serves a read-isolated frontend:
    reads route to it by tag, writes never need it."""
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(8):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    s.execute("HANDLE add_instance olap:1 olap")
    tier = fleet.row_tiers["default.t"]
    for m in tier.metas:
        s.execute(f"HANDLE add_learner {m.region_id} olap:1")
    rm = fleet.meta.regions[tier.metas[0].region_id]
    assert rm.learners == ["olap:1"]        # meta records the learner
    # an OLAP frontend pinned to the tag sees every committed row
    s2 = Session(Database("cpu", fleet=fleet, read_replica="follower",
                          read_tag="olap"))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n FROM t") == [{"n": 8}]
    # and the replica picked for the tag IS the learner instance
    g = tier.groups[0]
    picked = tier._pick_read_replica(g, 0, "olap")
    assert fleet._addr[picked.node_id] == "olap:1"
    # writes keep flowing with the learner dead (no quorum impact)
    fleet.kill_store("olap:1")
    s.execute("INSERT INTO t VALUES (100, 1.0)")
    assert s.query("SELECT COUNT(*) n FROM t") == [{"n": 9}]


# -- differential: a learner-read frontend on both packages ------------------

def test_learner_read_frontend_matches_jax():
    from baikaldb_tpu.exec.session import Database as JDatabase, Session as JSession
    from baikaldb_tpu.meta.service import MetaService as JMeta
    from baikaldb_tpu.raft.fleet import StoreFleet as JFleet
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    def run(mk_fleet, mk_db, mk_session):
        fleet = mk_fleet()
        s = mk_session(mk_db(fleet=fleet))
        s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
        for i in range(12):
            s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
        s.execute("UPDATE t SET v = v * 2 WHERE id < 4")
        s.execute("DELETE FROM t WHERE id = 7")
        s.execute("HANDLE add_instance olap:1 olap")
        tier = fleet.row_tiers["default.t"]
        for m in tier.metas:
            s.execute(f"HANDLE add_learner {m.region_id} olap:1")
        r = mk_session(mk_db(fleet=fleet, read_replica="follower", read_tag="olap"))
        r.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
        picked = fleet._addr[tier._pick_read_replica(tier.groups[0], 0, "olap").node_id]
        return (picked, r.query("SELECT id, v FROM t ORDER BY id"),
                r.query("SELECT learners FROM information_schema.regions"))

    got = run(lambda: StoreFleet(MetaService(peer_count=3), ["a:1", "b:1", "c:1"], seed=41),
              lambda **kw: Database("cpu", **kw), Session)
    want = run(lambda: JFleet(JMeta(peer_count=3), ["a:1", "b:1", "c:1"], seed=41),
               JDatabase, JSession)
    assert got == want and got[0] == "olap:1"
