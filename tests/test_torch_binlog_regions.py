"""The port's distributed binlog (storage/binlog_regions.py) against the
JAX package's.

``tests/test_binlog_regions.py``'s cases on a cluster of the port's daemon
processes (``tools/deploy_cluster.spawn_cluster``, free ports): two
frontends write one BINLOG=1 table and one ``BinlogCapturer`` reads a
single commit-ts-ordered stream; a SIGKILL'd store loses no event; an
orphan prewrite holds the stream back until its grace window expires;
unlinked tables never reach the binlog regions and a transaction's events
appear at COMMIT; the capturer's GC and a resume from its checkpoint.  Then
the same statements on the JAX package's in-process daemons and on the
port's give streams of equal event kinds, rows and order (timestamps
compared by order only).
"""

import time

import pytest

from baikaldb_tpu_torch.utils.flags import set_flag

_OPEN: list = []       # the frontends' Databases, closed with the cluster


@pytest.fixture(scope="module")
def cluster():
    from baikaldb_tpu_torch.tools.deploy_cluster import spawn_cluster, teardown

    meta_addr, procs = spawn_cluster(n_stores=3, base_port=0)
    yield meta_addr, procs
    for db in _OPEN:
        db.close()
    teardown(procs)


def _session(meta_addr):
    from baikaldb_tpu_torch.exec.session import Database, Session

    s = Session(Database("cpu", cluster=meta_addr))
    _OPEN.append(s.db)
    # binlog is opt-in per table, like the reference's link-binlog option
    s.execute("CREATE TABLE bt (id BIGINT NOT NULL, v DOUBLE, "
              "PRIMARY KEY (id)) BINLOG=1")
    return s


def test_two_frontends_one_ordered_stream(cluster):
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.storage.binlog_regions import BinlogCapturer
    from baikaldb_tpu_torch.storage.remote_tier import ClusterClient

    a = _session(meta_addr)
    b = _session(meta_addr)
    cap = BinlogCapturer(ClusterClient(meta_addr))
    # interleave writes from two frontend processes' worth of state
    for i in range(6):
        (a if i % 2 == 0 else b).execute(
            f"INSERT INTO bt VALUES ({i}, {float(i)})")
    deadline = time.monotonic() + 20
    got = []
    while time.monotonic() < deadline and len(got) < 6:
        got.extend(cap.poll())
        time.sleep(0.2)
    assert len(got) == 6
    ts = [e["commit_ts"] for e in got]
    assert ts == sorted(ts) and len(set(ts)) == 6     # ordered, distinct
    assert {e["src"] for e in got} == {a.db._dist_binlog.src,
                                       b.db._dist_binlog.src}
    ids = sorted(ev["row"]["id"] for e in got for ev in e["events"])
    assert ids == [0, 1, 2, 3, 4, 5]
    # every event's start_ts precedes its commit_ts (TSO 2PC)
    assert all(e["start_ts"] < e["commit_ts"] for e in got)


def test_leader_kill_loses_nothing(cluster):
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.storage.binlog_regions import BinlogCapturer
    from baikaldb_tpu_torch.storage.remote_tier import ClusterClient

    s = _session(meta_addr)
    cap = BinlogCapturer(ClusterClient(meta_addr))
    drained = cap.poll()        # skip earlier tests' events
    s.execute("INSERT INTO bt VALUES (100, 1.0)")
    # SIGKILL one store: binlog regions keep quorum 2/3
    victim = procs["stores"][1]
    victim.kill()
    victim.wait(timeout=10)
    s.execute("INSERT INTO bt VALUES (101, 2.0)")
    deadline = time.monotonic() + 25
    got = []
    while time.monotonic() < deadline and len(got) < 2:
        got.extend(cap.poll())
        time.sleep(0.3)
    ids = sorted(ev["row"]["id"] for e in got for ev in e["events"])
    assert ids == [100, 101]
    assert [e["commit_ts"] for e in got] == \
        sorted(e["commit_ts"] for e in got)


def test_orphan_prewrite_stalls_then_expires(cluster):
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.storage.binlog_regions import (BinlogCapturer,
                                                     DistributedBinlog)
    from baikaldb_tpu_torch.storage.remote_tier import ClusterClient

    s = _session(meta_addr)
    cap = BinlogCapturer(ClusterClient(meta_addr))
    cap.poll()
    # a writer dies between prewrite and commit
    dead = DistributedBinlog(ClusterClient(meta_addr))
    dead.prewrite("default.bt")
    s.execute("INSERT INTO bt VALUES (200, 1.0)")
    # the later commit sits ABOVE the orphan's start_ts: the capturer must
    # hold it back (gapless guarantee) ...
    assert cap.poll() == []
    # ... until the grace window expires the orphan
    set_flag("binlog_prewrite_grace_s", 0.2)
    try:
        time.sleep(0.4)
        deadline = time.monotonic() + 10
        got = []
        while time.monotonic() < deadline and not got:
            got = cap.poll()
            time.sleep(0.2)
    finally:
        set_flag("binlog_prewrite_grace_s", 30.0)
    assert [ev["row"]["id"] for e in got for ev in e["events"]] == [200]


def test_unlinked_tables_and_txn_path(cluster):
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.storage.binlog_regions import BinlogCapturer
    from baikaldb_tpu_torch.storage.remote_tier import ClusterClient

    s = _session(meta_addr)
    cap = BinlogCapturer(ClusterClient(meta_addr))
    cap.poll()
    # a table WITHOUT the binlog option never reaches the binlog regions
    s.execute("CREATE TABLE quiet (id BIGINT NOT NULL, PRIMARY KEY (id))")
    s.execute("INSERT INTO quiet VALUES (1)")
    assert cap.poll() == []
    # explicit transactions flush their buffered events at COMMIT
    s.execute("BEGIN")
    s.execute("INSERT INTO bt VALUES (250, 2.5)")
    s.execute("INSERT INTO bt VALUES (251, 2.5)")
    assert cap.poll() == []              # nothing visible before COMMIT
    s.execute("COMMIT")
    deadline = time.monotonic() + 15
    got = []
    while time.monotonic() < deadline and not got:
        got.extend(cap.poll())
        time.sleep(0.2)
    # txn-path events share the autocommit schema (kind/row)
    ids = sorted(ev["row"]["id"] for e in got for ev in e["events"])
    assert ids == [250, 251]
    assert {ev["kind"] for e in got for ev in e["events"]} == {"write"}


def test_capturer_gc_and_resume(cluster):
    meta_addr, procs = cluster
    from baikaldb_tpu_torch.storage.binlog_regions import BinlogCapturer
    from baikaldb_tpu_torch.storage.remote_tier import ClusterClient

    def ids_of(entries):
        out = []
        for e in entries:
            for ev in e["events"]:
                if "row" in ev:
                    out.append(ev["row"]["id"])
                for r in (ev.get("rows") or []):
                    out.append(r["id"])
        return out

    s = _session(meta_addr)
    cap = BinlogCapturer(ClusterClient(meta_addr))
    s.execute("INSERT INTO bt VALUES (300, 3.0)")
    deadline = time.monotonic() + 15
    got = []
    while time.monotonic() < deadline and 300 not in ids_of(got):
        got.extend(cap.poll())
        time.sleep(0.2)
    assert got
    reclaimed = cap.gc()
    assert reclaimed >= 1
    # a fresh capturer resuming from the checkpoint sees nothing old
    cap2 = BinlogCapturer(ClusterClient(meta_addr), since_ts=cap.checkpoint)
    assert cap2.poll() == []


# -- the same statements on both packages -------------------------------------

STATEMENTS = [
    ("a", "INSERT INTO bt VALUES (1, 1.5), (2, 2.5)"),
    ("b", "INSERT INTO bt VALUES (3, NULL)"),
    ("a", "UPDATE bt SET v = 9.25 WHERE id = 2"),
    ("b", "BEGIN"), ("b", "INSERT INTO bt VALUES (4, 4.0)"),
    ("b", "DELETE FROM bt WHERE id = 1"), ("b", "COMMIT"),
    ("a", "DELETE FROM bt WHERE id = 3"),
    ("a", "INSERT INTO quiet VALUES (7)"),
    # the last commit stays behind the capturer's watermark until a later
    # one lands: this write releases the DELETE above
    ("b", "INSERT INTO bt VALUES (5, 5.0)"),
]


def _stream(pkg: str) -> list:
    """The statements through two frontends of ``pkg`` on its own
    in-process daemons -> the captured events, in stream order, with the
    commit timestamps checked and dropped."""
    import importlib

    sess = importlib.import_module(f"{pkg}.exec.session")
    meta_cls = importlib.import_module(f"{pkg}.server.meta_server").MetaServer
    store_cls = importlib.import_module(f"{pkg}.server.store_server").StoreServer
    br = importlib.import_module(f"{pkg}.storage.binlog_regions")
    remote = importlib.import_module(f"{pkg}.storage.remote_tier")
    meta = meta_cls("127.0.0.1:0")
    meta.start()
    meta_addr = f"127.0.0.1:{meta.rpc.port}"
    stores = []
    dbs = []
    try:
        for sid in (1, 2, 3):
            st = store_cls(sid, "127.0.0.1:0", meta_addr, tick_interval=0.02)
            st.address = f"127.0.0.1:{st.rpc.port}"
            st.start()
            stores.append(st)
        fronts = {}
        for name in ("a", "b"):
            db = sess.Database("cpu", cluster=meta_addr) if pkg.endswith("_torch") \
                else sess.Database(cluster=meta_addr)
            db.telemetry.stop()
            dbs.append(db)
            s = fronts[name] = sess.Session(db)
            s.execute("CREATE TABLE bt (id BIGINT NOT NULL, v DOUBLE, PRIMARY KEY (id)) BINLOG=1")
            s.execute("CREATE TABLE quiet (id BIGINT NOT NULL, PRIMARY KEY (id))")
        cap = br.BinlogCapturer(remote.ClusterClient(meta_addr))
        for who, sql in STATEMENTS:
            fronts[who].execute(sql)
        got = []
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and len(got) < 5:
            got.extend(cap.poll())
            time.sleep(0.1)
        ts = [e["commit_ts"] for e in got]
        assert ts == sorted(ts) and len(set(ts)) == len(ts)
        assert all(e["start_ts"] < e["commit_ts"] for e in got)
        return [e["events"] for e in got[:5]]
    finally:
        for db in dbs:
            db.close()
        for st in stores:
            st.stop()
        meta.stop()


def test_stream_equals_jax_for_the_same_statements():
    port, jax = _stream("baikaldb_tpu_torch"), _stream("baikaldb_tpu")
    assert len(port) == 5       # one entry a committed statement or transaction
    assert port == jax
