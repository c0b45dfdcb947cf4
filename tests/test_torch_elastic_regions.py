"""The port's counterpart of tests/test_elastic_regions.py: the JAX oracle's cases run
against baikaldb_tpu_torch on the CPU, and the cases at the end run the same
seeded work on both packages and compare.  The oracle's text follows.

Elastic regions: load-driven live split + learner-first migration.

Covers the meta trigger (row threshold and write-skew outlier, SPLITTING
dedup across ticks), balancer determinism (fixed heartbeat sequence ->
identical order set), the online split executed by the fleet while SQL
writes flow, live migration with clean failpoint rollback, the
split/merge teardown seam (no leaked raft groups, no stale routing),
the information_schema.regions view + SHOW STATUS region.* counters,
and determinism of the split_chaos / migrate_chaos scenarios.
"""

import pytest

from baikaldb_tpu_torch.chaos import failpoint
from baikaldb_tpu_torch.meta.service import (HeartbeatRequest, MetaService,
                                       SERVING, SPLITTING)
from baikaldb_tpu_torch.utils import metrics
from baikaldb_tpu_torch.utils.flags import FLAGS, set_flag



class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def make_meta(n=3):
    m = MetaService(faulty_after=15, dead_after=60, clock=FakeClock())
    for i in range(n):
        m.add_instance(f"s{i}:1", logical_room="r")
    return m


def _fleet_session(stores=3):
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    fleet = StoreFleet(MetaService(peer_count=3),
                       [f"e{i + 1}:1" for i in range(stores)], seed=41)
    db = Database("cpu", fleet=fleet)
    s = Session(db)
    s.execute("CREATE DATABASE el")
    s.execute("USE el")
    s.execute("CREATE TABLE t (k BIGINT, v BIGINT, PRIMARY KEY (k))")
    return fleet, db, s


# ---- meta trigger ----------------------------------------------------------

def test_tick_emits_split_order_on_row_threshold():
    m = make_meta()
    (r,) = m.create_regions(table_id=1, n_regions=1)
    leader = r.peers[0]
    prev = int(FLAGS.region_split_rows)
    set_flag("region_split_rows", 100)
    try:
        for a in list(m.instances):
            m.heartbeat(HeartbeatRequest(address=a))
        m.heartbeat(HeartbeatRequest(
            address=leader, regions={r.region_id: (1, 250, 0, 0)},
            leader_ids=[r.region_id]))
        orders = m.tick()
        splits = [o for o in orders if o.kind == "split"]
        assert [o.region_id for o in splits] == [r.region_id]
        assert m.regions[r.region_id].state == SPLITTING
        # SPLITTING regions don't stack duplicate orders on the next tick
        assert not [o for o in m.tick() if o.kind == "split"]
    finally:
        set_flag("region_split_rows", prev)


def test_tick_emits_split_order_on_write_skew():
    m = make_meta()
    r0, r1 = m.create_regions(table_id=1, n_regions=2)
    for a in list(m.instances):
        m.heartbeat(HeartbeatRequest(address=a))

    def hb(region, rows):
        m.heartbeat(HeartbeatRequest(
            address=region.peers[0],
            regions={region.region_id: (1, rows, 0, 0)},
            leader_ids=[region.region_id]))

    # two leader heartbeats establish write_rate by differencing: r0 is a
    # 600 rows/hb hotspot, r1 trickles at 10 — neither crosses the row cap
    hb(r0, 0), hb(r1, 500)
    hb(r0, 600), hb(r1, 510)
    assert m.regions[r0.region_id].write_rate == 600
    orders = m.tick()
    splits = {o.region_id for o in orders if o.kind == "split"}
    assert splits == {r0.region_id}
    assert m.regions[r1.region_id].state == SERVING


def test_heartbeat_gauges_are_leader_authoritative():
    m = make_meta()
    (r,) = m.create_regions(table_id=1, n_regions=1)
    leader, follower = r.peers[0], r.peers[1]
    m.heartbeat(HeartbeatRequest(address=leader,
                                 regions={r.region_id: (1, 100, 7, 3)},
                                 leader_ids=[r.region_id]))
    assert (r.apply_lag, r.proposal_queue) == (7, 3)
    # a follower's stale gauges must not overwrite the leader's, but its
    # row count still lands (liveness when the leader slot is vacant)
    m.heartbeat(HeartbeatRequest(address=follower,
                                 regions={r.region_id: (1, 90, 99, 99)}))
    assert (r.apply_lag, r.proposal_queue) == (7, 3)
    assert r.num_rows == 90


def test_balancer_is_deterministic():
    """Fixed heartbeat sequence -> bit-identical BalanceOrder sets across
    independent MetaService instances (the acceptance contract)."""
    def run():
        m = MetaService(faulty_after=15, dead_after=60, peer_count=2,
                        balance_threshold=1, clock=FakeClock())
        for i in range(3):
            m.add_instance(f"s{i}", logical_room="r")
        regions = m.create_regions(1, 6)
        for r in regions:
            r.peers = ["s0", "s1"]
            r.leader = "s0"
        m.add_instance("s3", logical_room="r")
        prev = int(FLAGS.region_split_rows)
        set_flag("region_split_rows", 50)
        try:
            for a in sorted(m.instances):
                m.heartbeat(HeartbeatRequest(address=a))
            m.heartbeat(HeartbeatRequest(
                address="s0",
                regions={regions[2].region_id: (1, 80, 0, 0)},
                leader_ids=[regions[2].region_id]))
            out = []
            for _ in range(3):
                out.append([(o.kind, o.region_id, o.target, o.source)
                            for o in m.tick()])
            return out
        finally:
            set_flag("region_split_rows", prev)

    a, b = run(), run()
    assert a == b
    assert any(o[0] == "split" for tick in a for o in tick)
    assert any(o[0] == "migrate" or o[0] == "add_peer"
               for tick in a for o in tick)


# ---- fleet execution -------------------------------------------------------

def test_online_split_tick_to_fleet():
    """The full elastic path: writes -> heartbeats feed load gauges ->
    meta tick emits a split order -> the fleet executes it as a live
    fenced split -> routing tiles, every row still readable."""
    fleet, db, s = _fleet_session()
    tier = fleet.row_tiers["el.t"]
    for i in range(30):
        s.execute(f"INSERT INTO t VALUES ({i}, {i * 2})")
    prev = int(FLAGS.region_split_rows)
    set_flag("region_split_rows", 8)
    try:
        fleet.heartbeat_all()
        fleet.heartbeat_all()
        orders = fleet.meta.tick()
        assert any(o.kind == "split" for o in orders)
        assert fleet.apply_orders(orders) >= 1
    finally:
        set_flag("region_split_rows", prev)
    assert len(tier.metas) >= 2
    # never half-routed: ranges tile, every region SERVING + registered
    assert tier._starts[0] == b"" and tier._ends[-1] == b""
    for i in range(len(tier.metas) - 1):
        assert tier._ends[i] == tier._starts[i + 1]
    for m in tier.metas:
        assert fleet.meta.regions[m.region_id].state == SERVING
        assert m.region_id in fleet.groups
    rows = s.query("SELECT k, v FROM t ORDER BY k")
    assert [(r["k"], r["v"]) for r in rows] == [(i, i * 2)
                                               for i in range(30)]


def test_writes_flow_during_online_split():
    fleet, db, s = _fleet_session()
    tier = fleet.row_tiers["el.t"]
    for i in range(20):
        s.execute(f"INSERT INTO t VALUES ({i}, {i})")
    landed = []

    def hook(phase):
        # both sides of the fence: 100+ lands mid-copy, before the switch
        k = 100 + len(landed)
        s.execute(f"INSERT INTO t VALUES ({k}, {k})")
        landed.append(k)

    child = tier.split_region_online(tier.metas[0].region_id,
                                     chaos_hook=hook)
    assert child.region_id in fleet.groups
    assert len(landed) == 2
    rows = {r["k"] for r in s.query("SELECT k FROM t")}
    assert rows == set(range(20)) | set(landed)


def test_live_migration_learner_first():
    fleet, db, s = _fleet_session(stores=4)
    tier = fleet.row_tiers["el.t"]
    rid = tier.metas[0].region_id
    g = tier.groups[0]
    for i in range(12):
        s.execute(f"INSERT INTO t VALUES ({i}, {i})")
    rm = fleet.meta.regions[rid]
    source = rm.leader
    target = next(a for a in sorted(fleet.addresses) if a not in rm.peers)
    phases = []
    fleet.migrate_replica(rid, source, target,
                          chaos_hook=lambda p: phases.append(p))
    assert phases == ["start", "learner", "promoted", "removed"]
    raft_peers = sorted(fleet._addr[n] for n in g.peers())
    assert sorted(rm.peers) == raft_peers
    assert source not in raft_peers and target in raft_peers
    assert not g.bus.nodes[g.leader()].core.learners()
    assert rm.state == SERVING
    # the moved replica holds the data, and the group is still writable
    rep = fleet.replica(rid, target)
    rep.apply_committed()
    assert {r["k"] for r in rep.rows()} == set(range(12))
    s.execute("INSERT INTO t VALUES (99, 99)")
    assert len(s.query("SELECT k FROM t")) == 13


def test_migration_failpoint_rolls_back_clean():
    from baikaldb_tpu_torch.raft.fleet import MigrateError

    fleet, db, s = _fleet_session(stores=4)
    tier = fleet.row_tiers["el.t"]
    rid = tier.metas[0].region_id
    g = tier.groups[0]
    s.execute("INSERT INTO t VALUES (1, 1)")
    rm = fleet.meta.regions[rid]
    before = sorted(rm.peers)
    source = rm.leader
    target = next(a for a in sorted(fleet.addresses) if a not in rm.peers)
    aborts0 = metrics.region_migrate_aborts.value
    failpoint.set_failpoint("migrate.promote", "1*drop")
    try:
        with pytest.raises(MigrateError):
            fleet.migrate_replica(rid, source, target)
    finally:
        failpoint.clear("migrate.promote")
    assert metrics.region_migrate_aborts.value == aborts0 + 1
    # rolled back, never half-moved: membership restored, learner gone,
    # region back to SERVING, and the retry completes
    assert sorted(rm.peers) == before
    assert not g.bus.nodes[g.leader()].core.learners()
    assert rm.state == SERVING
    fleet.migrate_replica(rid, source, target)
    assert target in rm.peers and source not in rm.peers


def test_split_merge_teardown_clears_fleet_and_routing():
    """Regression for the teardown seam: a split then merge must retire
    the absorbed region everywhere — meta registry, fleet group table,
    tier routing — and DROP TABLE must leave zero groups behind."""
    fleet, db, s = _fleet_session()
    tier = fleet.row_tiers["el.t"]
    for i in range(16):
        s.execute(f"INSERT INTO t VALUES ({i}, {i})")
    child = tier.split_region_online(tier.metas[0].region_id)
    assert len(tier.metas) == 2
    tier.merge_region(0)
    assert len(tier.metas) == 1
    assert child.region_id not in fleet.groups
    assert child.region_id not in fleet.meta.regions
    assert tier._starts == [b""] and tier._ends == [b""]
    assert {r["k"] for r in s.query("SELECT k FROM t")} == set(range(16))
    survivors = {m.region_id for m in tier.metas}
    s.execute("DROP TABLE t")
    for rid in survivors:
        assert rid not in fleet.groups
        assert rid not in fleet.meta.regions


# ---- observability ---------------------------------------------------------

def test_information_schema_regions_view():
    fleet, db, s = _fleet_session()
    tier = fleet.row_tiers["el.t"]
    for i in range(10):
        s.execute(f"INSERT INTO t VALUES ({i}, {i})")
    tier.split_region_online(tier.metas[0].region_id)
    fleet.heartbeat_all()
    rows = s.query("SELECT * FROM information_schema.regions")
    by_id = {r["region_id"]: r for r in rows}
    assert {m.region_id for m in tier.metas} <= set(by_id)
    for m, g in zip(tier.metas, tier.groups):
        r = by_id[m.region_id]
        assert r["table_name"] == "el.t"
        assert r["state"] == "SERVING"
        assert len(r["peers"].split(",")) == 3
        assert r["leader"] in r["peers"].split(",")
        assert r["num_rows"] >= 0 and r["apply_lag"] >= 0
    # adjacent key ranges surface hex-encoded
    first, second = (by_id[m.region_id] for m in tier.metas[:2])
    assert first["start_key"] == "" and first["end_key"] != ""
    assert first["end_key"] == second["start_key"]


def test_region_counters_count_but_stay_out_of_show_status():
    """The JAX oracle reads region.* from SHOW STATUS.  The port counts the
    same events on the same counters (``metrics.region_*``); since the
    network plane (ROADMAP item 6b) they are on the registry, so SHOW
    STATUS lists them, as the JAX session does."""
    fleet, db, s = _fleet_session()
    tier = fleet.row_tiers["el.t"]
    for i in range(10):
        s.execute(f"INSERT INTO t VALUES ({i}, {i})")
    splits0 = metrics.region_splits.value
    handoffs0 = metrics.region_handoff_ms.stats()["count"]
    tier.split_region_online(tier.metas[0].region_id)
    assert metrics.region_splits.value == splits0 + 1
    assert metrics.region_handoff_ms.stats()["count"] == handoffs0 + 1
    for c in (metrics.region_split_aborts, metrics.region_merges,
              metrics.region_migrations, metrics.region_migrate_aborts):
        assert c.value >= 0
    status = {r["Variable_name"]: r["Value"] for r in s.query("SHOW STATUS LIKE 'region.%'")}
    assert status["region.splits.value"] == str(metrics.region_splits.value)
    assert status["region.handoff_ms.count"] == str(metrics.region_handoff_ms.stats()["count"])
    assert {k.rsplit(".", 1)[0] for k in status} == {
        "region.splits", "region.split_aborts", "region.merges", "region.migrations",
        "region.migrate_aborts", "region.handoff_ms"}


# ---- the chaos scenarios' split and migration, on both packages -------------
# The JAX oracle replays chaos/scenarios.py's split_chaos / migrate_chaos
# (ROADMAP item 6c).  Here the same seeded faults run on a JAX fleet session
# and a port fleet session: each run keeps its invariants, a replay of the
# port gives the same state, and the port's state equals the JAX package's.

def _pkg(name):
    import importlib

    root = "baikaldb_tpu" if name == "jax" else "baikaldb_tpu_torch"
    mods = {m: importlib.import_module(f"{root}.{m}") for m in (
        "exec.session", "meta.service", "raft.fleet", "storage.replicated",
        "chaos.failpoint", "utils.flags")}
    return mods


def _chaos_session(mods, seed, stores):
    sess = mods["exec.session"]
    fleet = mods["raft.fleet"].StoreFleet(mods["meta.service"].MetaService(peer_count=3),
                                          [f"c{i + 1}:1" for i in range(stores)],
                                          seed=7 + seed)
    db = sess.Database(fleet=fleet) if mods["exec.session"].__name__.startswith(
        "baikaldb_tpu.") else sess.Database("cpu", fleet=fleet)
    s = sess.Session(db)
    for sql in ("CREATE DATABASE chaos", "USE chaos",
                "CREATE TABLE ck (k BIGINT, v BIGINT, PRIMARY KEY (k))"):
        s.execute(sql)
    return fleet, s


def _split_run(pkg: str, fault: str, writes: int = 24) -> dict:
    mods = _pkg(pkg)
    fp, flags = mods["chaos.failpoint"], mods["utils.flags"]
    SplitError = mods["storage.replicated"].SplitError
    fleet, s = _chaos_session(mods, 11, 3)
    tier = fleet.row_tiers["chaos.ck"]
    schedule, nk = [], [0]

    def put(n):
        for _ in range(min(n, writes - nk[0])):
            s.execute(f"INSERT INTO ck VALUES ({nk[0]}, {nk[0] * nk[0]})")
            nk[0] += 1

    put(writes // 2)
    parent = tier.metas[0].region_id

    def hook(phase):
        schedule.append(["phase", phase])
        put(4)
        if fault == f"partition_{phase}":
            ldr = fleet.meta.regions[parent].leader
            fleet.partition_store(ldr)
            schedule.append(["partition", ldr, phase])

    try:
        if fault == "handoff_drop":
            fp.set_failpoint("region.handoff", "1*drop")
        elif fault == "fence_drop":
            fp.set_failpoint("region.split_fence", "1*drop")
        try:
            child = tier.split_region_online(parent, chaos_hook=hook)
            schedule.append(["split_ok", parent, child.region_id])
        except SplitError:
            schedule.append(["split_abort", parent])
            fleet.heal_all()
            child = tier.split_region_online(parent)
            schedule.append(["split_retry_ok", parent, child.region_id])
    finally:
        fp.clear("region.handoff")
        fp.clear("region.split_fence")
        fleet.heal_all()
    put(writes - nk[0])
    prev = int(flags.FLAGS.region_split_rows)
    flags.FLAGS.set_flag("region_split_rows", max(4, writes // 4))
    try:
        fleet.heartbeat_all()
        fleet.heartbeat_all()
        orders = fleet.meta.tick()
        applied = fleet.apply_orders(orders)
        schedule.append(["tick", sorted([o.kind, o.region_id] for o in orders), applied])
    finally:
        flags.FLAGS.set_flag("region_split_rows", prev)
    rows = s.query("SELECT k, v FROM ck ORDER BY k")
    assert rows == [{"k": i, "v": i * i} for i in range(writes)]
    assert any(o[0] == "split" for o in schedule[-1][1])
    assert tier._starts[0] == b"" and tier._ends[-1] == b""
    for i in range(len(tier.metas) - 1):
        assert tier._ends[i] == tier._starts[i + 1]
    return {"schedule": schedule, "rows": rows,
            "regions": [[m.region_id, tier._starts[i].hex(), tier._ends[i].hex()]
                        for i, m in enumerate(tier.metas)],
            "peers": [sorted(fleet.meta.regions[m.region_id].peers) for m in tier.metas]}


@pytest.mark.parametrize("fault", ["partition_begin", "partition_copied",
                                   "handoff_drop", "fence_drop"])
def test_split_chaos_is_deterministic_and_matches_jax(fault):
    a = _split_run("torch", fault)
    assert len(a["regions"]) >= 2
    assert _split_run("torch", fault) == a
    assert a == _split_run("jax", fault)


def _migrate_run(pkg: str, fault: str, writes: int = 20) -> dict:
    mods = _pkg(pkg)
    fp = mods["chaos.failpoint"]
    MigrateError = mods["raft.fleet"].MigrateError
    fleet, s = _chaos_session(mods, 11, 4)
    tier = fleet.row_tiers["chaos.ck"]
    rid = tier.metas[0].region_id
    g = tier.groups[0]
    schedule, nk, killed = [], [0], []

    def put(n):
        for _ in range(min(n, writes - nk[0])):
            s.execute(f"INSERT INTO ck VALUES ({nk[0]}, {nk[0] * nk[0]})")
            nk[0] += 1

    put(writes // 2)
    rm = fleet.meta.regions[rid]
    source = rm.leader
    target = next(a for a in sorted(fleet.addresses) if a not in rm.peers)

    def hook(phase):
        schedule.append(["phase", phase])
        put(3)
        if fault == f"kill_leader_{phase}":
            victim = g.leader()
            g.bus.kill(victim)
            killed.append(victim)
            schedule.append(["kill_leader", victim, phase])

    try:
        if fault == "snapshot_drop":
            fp.set_failpoint("migrate.snapshot", "1*drop")
        elif fault == "promote_drop":
            fp.set_failpoint("migrate.promote", "1*drop")
        try:
            fleet.migrate_replica(rid, source, target, chaos_hook=hook)
            schedule.append(["migrate_ok", source, target])
        except MigrateError:
            schedule.append(["migrate_abort", source, target])
            for nid in killed:
                g.bus.revive(nid)
            killed.clear()
            fleet.migrate_replica(rid, source, target)
            schedule.append(["migrate_retry_ok", source, target])
    finally:
        fp.clear("migrate.snapshot")
        fp.clear("migrate.promote")
        for nid in killed:
            g.bus.revive(nid)
    put(writes - nk[0])
    rows = s.query("SELECT k, v FROM ck ORDER BY k")
    assert rows == [{"k": i, "v": i * i} for i in range(writes)]
    # completed or rolled back, never half-moved: meta's membership is the
    # raft group's voter set, with no learner left behind
    rm = fleet.meta.regions[rid]
    raft_peers = sorted(fleet._addr[n] for n in g.peers())
    assert sorted(rm.peers) == raft_peers
    assert not g.bus.nodes[g.leader()].core.learners()
    assert source not in raft_peers and target in raft_peers
    assert rm.state == "SERVING"
    return {"schedule": schedule, "rows": rows, "peers": raft_peers}


@pytest.mark.parametrize("fault", ["kill_leader_start", "kill_leader_learner",
                                   "snapshot_drop", "promote_drop"])
def test_migrate_chaos_is_deterministic_and_matches_jax(fault):
    a = _migrate_run("torch", fault)
    assert _migrate_run("torch", fault) == a
    assert a == _migrate_run("jax", fault)
