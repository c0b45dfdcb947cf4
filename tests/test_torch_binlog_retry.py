"""Committed-transaction CDC on the port survives a flaky distributed-binlog
backend, as in the JAX package (exec/session.py ``_TableBinlogRetry``).

``tests/test_binlog_retry.py``'s cases run on the port's Session with a
stand-in cluster handle and a fake distributed writer: a failed append
queues per table and retries on a later commit (an empty one too), order
holds while the backend is down, an autocommit event drains its table's
queue first or queues behind it, overflow drops are counted, one dead table
does not convoy another, and DROP TABLE discards the table's queue.  Each
scenario also runs on the JAX package's Session, and the appended batches
(table keys, event kinds, rows, order) are equal.
"""

import types

import baikaldb_tpu.exec.session as jsession
import baikaldb_tpu.utils.metrics as jmetrics
from baikaldb_tpu_torch.exec.session import Session
from baikaldb_tpu_torch.utils import metrics

PORT = dict(session=lambda: Session(device="cpu"), metrics=metrics)
JAX = dict(session=jsession.Session, metrics=jmetrics)


def _both(scenario, monkeypatch) -> bool:
    """The scenario's assertions on each package, then the appended
    batches compared."""
    got = []
    for pkg in (PORT, JAX):
        ns = types.SimpleNamespace(monkeypatch=monkeypatch, **pkg)
        got.append(scenario(ns))
    assert got[0] == got[1]
    return True


class FlakyDist:
    def __init__(self):
        self.fail = True
        self.appended = []

    def append(self, table_key, events):
        if self.fail:
            raise RuntimeError("binlog backend down")
        self.appended.append((table_key, list(events)))

    def write_with_data(self, tier, ops, table_key, events):
        # the autocommit path: CDC rides the data write
        if self.fail:
            raise RuntimeError("binlog backend down")
        tier.write_ops(ops)
        self.appended.append(("autocommit:" + table_key, list(events)))


def _binlogged_session(ns):
    s = ns.session()
    s.execute("CREATE TABLE bl (id BIGINT PRIMARY KEY, v DOUBLE) BINLOG=1")
    # stand in for the daemon plane: a cluster handle + a fake dist writer
    s.db.cluster = object()
    s.db._dist_binlog = FlakyDist()
    return s, s.db._dist_binlog


def _failed_append_queues_and_retries(ns):
    s, dist = _binlogged_session(ns)
    q0 = ns.metrics.binlog_retry_queued.value
    s.execute("BEGIN")
    s.execute("INSERT INTO bl VALUES (1, 1.0)")
    s.execute("COMMIT")                       # append fails -> queued
    assert s.db.binlog_retry_depth("default.bl") == 1
    assert ns.metrics.binlog_retry_queued.value > q0
    assert dist.appended == []

    dist.fail = False
    s.execute("BEGIN")                        # empty commit still drains
    s.execute("COMMIT")
    assert s.db.binlog_retry_depth() == 0
    assert len(dist.appended) == 1
    assert dist.appended[0][0] == "default.bl"
    return dist.appended


def _order_preserved_while_backend_down(ns):
    s, dist = _binlogged_session(ns)
    for i in range(3):
        s.execute("BEGIN")
        s.execute(f"INSERT INTO bl VALUES ({10 + i}, {float(i)})")
        s.execute("COMMIT")
    assert s.db.binlog_retry_depth("default.bl") == 3   # queued, in order
    dist.fail = False
    s.execute("BEGIN")
    s.execute("INSERT INTO bl VALUES (99, 9.0)")
    s.execute("COMMIT")                       # drains queue THEN appends new
    assert len(dist.appended) == 4
    # the queued batches replay in commit order, the fresh one last
    assert [tk for tk, _ in dist.appended] == ["default.bl"] * 4
    return dist.appended


def _autocommit_drains_queue_first(ns):
    """An autocommit CDC append must not jump ahead of queued (failed)
    txn batches for the same table — the store drains the retry queue
    before its own event rides the data write (and holds the table's
    retry lock across both, so a concurrent flush cannot interleave)."""
    s, dist = _binlogged_session(ns)
    s.execute("BEGIN")
    s.execute("INSERT INTO bl VALUES (1, 1.0)")
    s.execute("COMMIT")                       # backend down -> queued
    assert s.db.binlog_retry_depth("default.bl") == 1

    class FakeTier:
        def write_ops(self, ops):
            pass

        def alloc_rowids(self, n, floor=0):
            return floor

    store = s.db.stores["default.bl"]
    store.replicated = FakeTier()
    store.binlog_sink = dist
    store.binlog_db = s.db
    dist.fail = False
    s.execute("INSERT INTO bl VALUES (2, 2.0)")   # autocommit CDC
    # queued txn batch landed FIRST, then the autocommit event
    assert [tk for tk, _ in dist.appended] == \
        ["default.bl", "autocommit:default.bl"]
    assert s.db.binlog_retry_depth() == 0
    return dist.appended


def _overflow_drops_are_counted(ns):
    s, dist = _binlogged_session(ns)
    ns.monkeypatch.setattr(s.db, "_BINLOG_RETRY_MAX", 2)
    d0 = ns.metrics.binlog_events_dropped.value
    for i in range(4):
        s.execute("BEGIN")
        s.execute(f"INSERT INTO bl VALUES ({20 + i}, 0.5)")
        s.execute("COMMIT")
    assert s.db.binlog_retry_depth("default.bl") == 2   # bounded per table
    assert ns.metrics.binlog_events_dropped.value > d0
    return dist.appended


def _one_dead_table_does_not_convoy_others(ns):
    """Partial backend recovery: bl's binlog region is still leaderless
    while bl2's works.  With per-table queues, bl2's stream drains and
    proceeds — in order — while bl's stays queued.  (The old global queue
    stopped the drain at bl's batch and convoyed bl2 behind it.)"""
    s, dist = _binlogged_session(ns)
    # create the second store before the fake cluster handle is consulted
    saved_cluster, s.db.cluster = s.db.cluster, None
    s.execute("CREATE TABLE bl2 (id BIGINT PRIMARY KEY, v DOUBLE) BINLOG=1")
    s.execute("INSERT INTO bl2 VALUES (0, 0.0)")
    s.db.cluster = saved_cluster
    for t in ("bl", "bl2"):                   # backend down: both queue
        s.execute("BEGIN")
        s.execute(f"INSERT INTO {t} VALUES (1, 1.0)")
        s.execute("COMMIT")
    assert s.db.binlog_retry_depth("default.bl") == 1
    assert s.db.binlog_retry_depth("default.bl2") == 1

    class FakeTier:
        def write_ops(self, ops):
            pass

        def alloc_rowids(self, n, floor=0):
            return floor

    store = s.db.stores["default.bl2"]
    store.replicated = FakeTier()
    store.binlog_sink = dist
    store.binlog_db = s.db
    # partial recovery: bl's binlog region is still leaderless, bl2 is fine
    dist.fail = False
    real_append = dist.append

    def partial_append(table_key, events):
        if table_key == "default.bl":
            raise RuntimeError("bl's binlog region still leaderless")
        real_append(table_key, events)
    dist.append = partial_append

    s.execute("INSERT INTO bl2 VALUES (2, 2.0)")   # autocommit on bl2
    # bl2's queued txn batch lands first, then the autocommit event — bl2
    # is NOT held hostage by bl's dead region; bl's batch stays queued
    assert [tk for tk, _ in dist.appended] == \
        ["default.bl2", "autocommit:default.bl2"]
    assert s.db.binlog_retry_depth("default.bl") == 1
    assert s.db.binlog_retry_depth("default.bl2") == 0

    dist.append = real_append                  # full recovery
    s.db.drain_binlog_retry(dist)
    assert [tk for tk, _ in dist.appended][-1] == "default.bl"
    assert s.db.binlog_retry_depth() == 0
    return dist.appended


def _drop_table_discards_retry_state(ns):
    """DROP TABLE forgets the table's retry queue+lock: the queued batches
    count as dropped (no table to replay for) and later flushes stop
    re-attempting them — the registry stays O(live tables) under
    create/drop churn."""
    s, dist = _binlogged_session(ns)
    s.execute("BEGIN")
    s.execute("INSERT INTO bl VALUES (1, 1.0)")
    s.execute("COMMIT")                       # backend down -> queued
    assert s.db.binlog_retry_depth("default.bl") == 1
    d0 = ns.metrics.binlog_events_dropped.value
    saved_cluster, s.db.cluster = s.db.cluster, None    # drop is local
    s.execute("DROP TABLE bl")
    s.db.cluster = saved_cluster
    assert s.db.binlog_retry_depth() == 0
    assert "default.bl" not in s.db._binlog_retry
    assert ns.metrics.binlog_events_dropped.value > d0
    dist.fail = False
    s.db.drain_binlog_retry(dist)             # nothing phantom replays
    assert dist.appended == []
    return dist.appended


def _autocommit_blocked_table_queues_behind_own_batch(ns):
    """The per-table blocked check: when THIS table's own older batch is
    still queued (its region re-broke mid-drain), the autocommit event
    queues behind it — data still commits, the stream never reorders."""
    s, dist = _binlogged_session(ns)
    s.execute("BEGIN")
    s.execute("INSERT INTO bl VALUES (1, 1.0)")
    s.execute("COMMIT")                       # backend down -> queued
    assert s.db.binlog_retry_depth("default.bl") == 1

    class FakeTier:
        def write_ops(self, ops):
            pass

        def alloc_rowids(self, n, floor=0):
            return floor

    store = s.db.stores["default.bl"]
    store.replicated = FakeTier()
    store.binlog_sink = dist
    store.binlog_db = s.db
    # backend still down: drain fails, autocommit event must queue BEHIND
    s.execute("INSERT INTO bl VALUES (2, 2.0)")
    assert dist.appended == []
    assert s.db.binlog_retry_depth("default.bl") == 2

    dist.fail = False
    s.db.drain_binlog_retry(dist)
    assert [tk for tk, _ in dist.appended] == ["default.bl"] * 2
    assert s.db.binlog_retry_depth() == 0
    return dist.appended


def test_failed_append_queues_and_retries(monkeypatch):
    assert _both(_failed_append_queues_and_retries, monkeypatch)


def test_order_preserved_while_backend_down(monkeypatch):
    assert _both(_order_preserved_while_backend_down, monkeypatch)


def test_autocommit_drains_queue_first(monkeypatch):
    assert _both(_autocommit_drains_queue_first, monkeypatch)


def test_overflow_drops_are_counted(monkeypatch):
    assert _both(_overflow_drops_are_counted, monkeypatch)


def test_one_dead_table_does_not_convoy_others(monkeypatch):
    assert _both(_one_dead_table_does_not_convoy_others, monkeypatch)


def test_drop_table_discards_retry_state(monkeypatch):
    assert _both(_drop_table_discards_retry_state, monkeypatch)


def test_autocommit_blocked_table_queues_behind_own_batch(monkeypatch):
    assert _both(_autocommit_blocked_table_queues_behind_own_batch, monkeypatch)
