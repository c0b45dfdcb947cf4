"""The port's multi-process mini-cluster (tools/deploy_cluster.py with a
MySQL frontend process), the cases of tests/test_cluster_procs.py.

Real processes on one host — 1 meta daemon + 3 store daemons + 1 MySQL
frontend (``python -m baikaldb_tpu_torch.server --meta ... --device
cpu``), sockets between them — matching the reference's three-binary
deployment.  SQL DML from a port frontend replicates to the store daemons
over the TCP raft transport; SIGKILLing a store process mid-workload loses
nothing committed; the frontend process answers over the wire from the
daemons' rows.  One module-scoped cluster on free ports: the daemons bind
port 0 and report it, the frontend gets a port bound and released here.
"""

import socket
import time

import pytest

from baikaldb_tpu_torch.exec.session import Database as _Database


def Database(**kw):
    return _Database("cpu", **kw)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def cluster():
    from baikaldb_tpu_torch.tools.deploy_cluster import (spawn_cluster, teardown,
                                                         wait_frontends)

    meta_addr, procs = spawn_cluster(n_stores=3, base_port=0,
                                     mysql_port=_free_port(), device="cpu")
    try:
        assert wait_frontends(procs) == procs["mysql_ports"]
    except BaseException:
        teardown(procs)
        raise
    yield meta_addr, procs
    teardown(procs)


def _wait_port(port: int, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.3)
    raise TimeoutError(f"port {port} never opened")


def test_sql_replicates_across_store_processes(cluster):
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.exec.session import Session

    s = Session(Database(cluster=meta_addr))
    s.execute("CREATE TABLE pt (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(8):
        s.execute(f"INSERT INTO pt VALUES ({i}, {float(i)})")
    assert s.query("SELECT COUNT(*) n FROM pt") == [{"n": 8}]

    # every store process holds replicated state for this table
    from baikaldb_tpu_torch.storage.remote_tier import stable_table_id
    from baikaldb_tpu_torch.utils.net import RpcClient

    meta = RpcClient(meta_addr)
    regions = meta.call("table_regions",
                        table_id=stable_table_id("default.pt"))
    assert regions, "meta lost the table's regions"
    seen_stores = {addr for r in regions for _, addr in r["peers"]}
    assert len(seen_stores) == 3

    # SIGKILL one store process mid-workload: quorum 2/3 keeps serving
    victim = procs["stores"][0]
    victim.kill()
    victim.wait(timeout=10)
    for i in range(8, 16):
        s.execute(f"INSERT INTO pt VALUES ({i}, {float(i)})")
    assert s.query("SELECT COUNT(*) n FROM pt") == [{"n": 16}]

    # a FRESH frontend process-state (new Database/ClusterClient) rebuilds
    # from the surviving replicas: nothing committed was lost
    s2 = Session(Database(cluster=meta_addr))
    s2.execute("CREATE TABLE pt (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    got = s2.query("SELECT COUNT(*) n, SUM(v) s FROM pt")
    assert got == [{"n": 16, "s": float(sum(range(16)))}]


def test_mysql_frontend_process_over_cluster(cluster):
    meta_addr, procs = cluster
    assert procs["mysql"] is not None and procs["mysql"].poll() is None
    port = procs["mysql_ports"][0]
    _wait_port(port)
    from baikaldb_tpu_torch.client.mysql_client import Connection

    c = Connection("127.0.0.1", port, user="root", password="")
    c.query("CREATE TABLE wt (k BIGINT, txt VARCHAR(16), PRIMARY KEY (k))")
    c.query("INSERT INTO wt VALUES (1, 'alpha'), (2, 'beta')")
    res = c.query("SELECT k, txt FROM wt ORDER BY k")
    assert [tuple(r) for r in res.rows] == [("1", "alpha"), ("2", "beta")]
    c.close()

    # the frontend's writes are in the store daemons, not its process memory:
    # read them back through a DIFFERENT frontend (in-test session)
    from baikaldb_tpu_torch.exec.session import Session

    s = Session(Database(cluster=meta_addr))
    s.execute("CREATE TABLE wt (k BIGINT, txt VARCHAR(16), PRIMARY KEY (k))")
    assert s.query("SELECT k, txt FROM wt ORDER BY k") == [
        {"k": 1, "txt": "alpha"}, {"k": 2, "txt": "beta"}]


def test_region_split_and_merge_across_processes(cluster):
    """Range split/merge under consensus on REAL store daemons: an
    oversized region splits while the workload writes; row counts
    reconcile; merge collapses it back (region.cpp:4472/:7198/:4864 over
    the TCP plane)."""
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.storage.remote_tier import stable_table_id
    from baikaldb_tpu_torch.utils.net import RpcClient

    s = Session(Database(cluster=meta_addr))
    s.execute("CREATE TABLE st (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier = s.db.cluster.tiers["default.st"]
    tier.split_rows = 10
    for i in range(40):
        s.execute(f"INSERT INTO st VALUES ({i}, {float(i)})")
        # interleaved reads never lose or double-count a row mid-split
        assert s.query("SELECT COUNT(*) n FROM st") == [{"n": i + 1}]
    assert len(tier.regions) >= 2
    # the ranges partition the keyspace contiguously
    assert tier.regions[0].start_key == b"" and tier.regions[-1].end_key == b""
    for a, b in zip(tier.regions, tier.regions[1:]):
        assert a.end_key == b.start_key
    # meta's routing table agrees (a fresh frontend would see the split)
    meta = RpcClient(meta_addr)
    wire = meta.call("table_regions", table_id=stable_table_id("default.st"))
    assert {w["region_id"] for w in wire} == \
        {r.region_id for r in tier.regions}
    s2 = Session(Database(cluster=meta_addr))
    s2.execute("CREATE TABLE st (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n, SUM(v) sv FROM st") == \
        [{"n": 40, "sv": float(sum(range(40)))}]
    # merge back after the policy loosens
    tier.split_rows = 100_000
    assert tier.maybe_merge() >= 1
    assert s.query("SELECT COUNT(*) n FROM st") == [{"n": 40}]


def test_stale_frontend_routing_refreshes_after_split(cluster):
    """Two frontends: A splits the table; B (cached pre-split ranges) keeps
    writing.  The store answers version_old (region.cpp add_version check),
    B refreshes routing and re-sends — no silently dropped write."""
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.exec.session import Session

    a = Session(Database(cluster=meta_addr))
    a.execute("CREATE TABLE sr (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier_a = a.db.cluster.tiers["default.sr"]
    for i in range(12):
        a.execute(f"INSERT INTO sr VALUES ({i}, 1.0)")
    # B attaches AFTER A's writes (rowids continue past them) but BEFORE
    # the split — so B's cached routing is genuinely stale
    b = Session(Database(cluster=meta_addr))
    b.execute("CREATE TABLE sr (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier_b = b.db.cluster.tiers["default.sr"]
    tier_a.split_rows = 4
    assert tier_a.maybe_split() >= 1
    assert len(tier_b.regions) < len(tier_a.regions)   # B is stale
    # B writes keys across the whole (split) keyspace: every write must
    # land (version_old -> refresh -> re-send), none silently filtered
    for i in range(12, 24):
        b.execute(f"INSERT INTO sr VALUES ({i}, 1.0)")
    assert len(tier_b.regions) == len(tier_a.regions)  # B refreshed
    # cross-frontend visibility is attach-time (each frontend caches its
    # own columnar image): the authoritative check is a FRESH frontend
    # reading every row back from the replicas — nothing silently dropped
    a2 = Session(Database(cluster=meta_addr))
    a2.execute("CREATE TABLE sr (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert a2.query("SELECT COUNT(*) n FROM sr") == [{"n": 24}]


def test_in_doubt_2pc_recovery_on_attach(cluster):
    """A frontend that dies between PREPARE and COMMIT leaves prepared txns
    on the store daemons; the NEXT frontend to attach resolves them from
    the primary's decision record (region.cpp:598/684 in-doubt recovery):
    no decision -> rollback everywhere, decision -> commit completes."""
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.raft.cluster import (CMD_COMMIT, CMD_DECIDE,
                                           CMD_PREPARE, encode_cmd,
                                           encode_ops)

    s = Session(Database(cluster=meta_addr))
    s.execute("CREATE TABLE dt (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO dt VALUES (1, 1.0)")
    tier = s.db.cluster.tiers["default.dt"]
    region = tier.regions[0]
    # simulate a coordinator crash mid-2PC: PREPARE lands, no decision
    ops = [(0, b"\x01\x7f\xff\xff\xff\xff\xff\xff\xff",
            tier.row_codec.encode({**tier.scan_rows()[0], "__rowid": 999}))]
    tier._propose(region, encode_cmd(CMD_PREPARE, 777, encode_ops(ops)))
    # crashed txn WITH a decision record: must complete as committed
    tier._propose(region, encode_cmd(CMD_PREPARE, 778, encode_ops(
        [(0, b"\x01\x7f\xff\xff\xff\xff\xff\xff\xfe", ops[0][2])])))
    tier._propose(region, encode_cmd(CMD_DECIDE, 778, bytes([CMD_COMMIT])))

    # a fresh frontend attaches.  The DECIDED txn completes immediately;
    # the undecided one is DEFERRED (younger than the grace window — a
    # live coordinator must not be aborted), then rolls back once the
    # grace window is treated as elapsed
    s2 = Session(Database(cluster=meta_addr))
    s2.execute("CREATE TABLE dt (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    t2 = s2.db.cluster.tiers["default.dt"]
    st = t2._leader_call(t2.regions[0], "txn_status")
    assert st is not None and st["prepared"] == [777], st   # 778 completed
    t2.IN_DOUBT_GRACE_S = 0.0        # instance override: window elapsed
    out = t2.recover_in_doubt()
    assert out.get(777) == "rolled_back", out
    st = t2._leader_call(t2.regions[0], "txn_status")
    assert st is not None and st["prepared"] == [], st
    # txn 778 (decided) applied its row; txn 777 (undecided) did not
    keys = {k for k, _ in t2._scan_region(t2.regions[0])}
    assert b"\x01\x7f\xff\xff\xff\xff\xff\xff\xfe" in keys
    assert b"\x01\x7f\xff\xff\xff\xff\xff\xff\xff" not in keys
