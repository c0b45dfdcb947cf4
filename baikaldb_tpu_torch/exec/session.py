"""SQL session: parse -> plan -> stage tables on the device -> execute -> rows.

The port of the query path of ``baikaldb_tpu/exec/session.py``: CREATE
TABLE, INSERT ... VALUES, ``load_arrow`` bulk ingest, SET, EXPLAIN, and
SELECT with joins, IN / EXISTS / scalar subqueries, derived tables and WITH,
UNION, WHERE / GROUP BY / HAVING / ORDER BY / LIMIT / OFFSET (all 22 TPC-H
queries), window functions.  The copied planner plans it; the executor runs
the plan eagerly, and a scalar subquery with more than one row raises
"Subquery returns more than 1 row" as in the JAX session.  Results are
densified on the device and returned as Arrow.  The connection
environment (``@@var``, ``@@session.var`` / ``@@global.var``, ``@var``,
DATABASE() / SCHEMA(), USER() and its aliases, CONNECTION_ID(), VERSION())
becomes literals before planning, as in the JAX session
(``_resolve_session_exprs``); such a statement skips the plan cache, since
the values are session state.  FORMAT, DATE_FORMAT, HEX, BIN and OCT of
numbers are evaluated at egress (exec/egress.py), SELECT ... INTO OUTFILE
writes the rows to a file, and LOAD DATA INFILE reads a CSV file back in
(pyarrow's reader into the bulk ingest, primary key checked).
MATCH(col) AGAINST(...) is the fulltext relevance of index/fulltext.py,
gathered by dictionary code on the device; FULLTEXT KEY declares it.

The statements that need only the catalog are the JAX session's: CREATE /
DROP DATABASE, USE, DROP TABLE (its store and device image go with it),
TRUNCATE, CREATE / DROP VIEW, DESCRIBE, and SHOW DATABASES, [FULL] TABLES,
CREATE TABLE, [FULL] COLUMNS, INDEX, VARIABLES, COLLATION, CHARSET, ENGINES
and TABLE STATUS; ``information_schema`` renders tables, columns, views,
partitions, snapshots, trace_spans, flags, failpoints, column_stats,
query_log and dispatcher; HANDLE runs checkpoint, gc, split and set_flag.

The observability plane and users are the JAX session's too.  Every
statement opens a live progress record (obs/progress.py) that beats at the
host seams (parse, plan, each staged scan, each streamed chunk, each mesh
round, the dispatcher's queued wait, egress): SHOW [FULL] PROCESSLIST and
``information_schema.processlist`` read the records, and KILL [QUERY |
CONNECTION] n flips one's cancel token, so the victim raises
``QueryKilled`` at its next beat.  Every finished statement leaves a
flight-recorder record (``information_schema.flight_recorder``, HANDLE
flightrec dump | clear), with a forensic bundle when it was slow, killed
or failed; SHOW STATUS, ``information_schema.metrics`` and
``cluster_metrics`` read the metrics registry (the kernel launch counters
among it) and the watchdog's health rows; SHOW PROFILES / PROFILE [FOR
QUERY n] read the kept traces.  ``Session(db, user=...)`` runs as that
account: each statement is checked against its grants (CREATE / DROP
USER, GRANT, REVOKE, SHOW GRANTS, HANDLE add_privilege / drop_privilege).
``information_schema.executables`` / ``aot_cache`` (the JAX package's XLA
executable cache, which has no counterpart) raise ``NotPortedError``; a
statement or SHOW form neither package knows raises ``SqlError``, as in
the JAX session.

Tables may be partitioned (``PARTITION BY RANGE (col) (PARTITION p VALUES
LESS THAN (v | MAXVALUE), ...)`` or ``PARTITION BY HASH (col) PARTITIONS
n``; ALTER TABLE ADD / DROP PARTITION): each partition's rows fill their own
regions, and a predicate on the partition column stages only the kept
partitions' regions, as one batch (``access=partition(k/n partitions
pruned)``).  A ``GLOBAL [UNIQUE] INDEX`` keeps its entries in a hidden
backing table (index/globalindex.py), maintained by INSERT, UPDATE, DELETE,
the upserts and LOAD DATA inside the statement's transaction; an equality
on its first column reads through it (``access=global_index(ix:col)``).

A session runs on one device, named when it is made.  ``Session()`` with no
device runs on CUDA and raises when CUDA is unavailable; only an explicit
``Session(device="cpu")`` runs on the CPU.

``Session(mesh=make_mesh(n))`` (parallel/mesh.py) is the MPP mode of the JAX
session: every SELECT plans through plan/distribute.py and runs over the
mesh's shards, each table row-sharded (cached per table version), the
exchanges and partial-aggregate merges as the collectives of
parallel/collectives.py.  EXPLAIN shows the distributed plan.  Under a mesh
no scan streams and no scan takes the ANN path, as in the JAX session; each
query adds its executed repartition rounds to ``shuffle_rounds`` (and the
scheduler's skipped ones to ``shuffle_rounds_saved``), and with tracing on
records ``mpp.repartition`` / ``mpp.join`` / ``mpp.agg`` spans.

VECTOR(d) columns are the JAX session's: d hidden FLOAT components
``__{col}_{i}`` (1 <= d <= 4096), filled by INSERT vector literals or by a
list / fixed-size list column in ``load_arrow`` (read in bulk from Arrow's
values and offsets); DESCRIBE shows ``vector(d)`` and SELECT * hides the
components.  L2_DISTANCE, COSINE_DISTANCE and INNER_PRODUCT expand over the
components in the planner.  An ``ANN INDEX`` (in CREATE TABLE, or ALTER
TABLE ... ADD ANN INDEX / DROP INDEX) makes ``ORDER BY <distance> LIMIT k``
scan only the IVF candidates of index/annindex.py, re-ranked exactly by the
unchanged plan; EXPLAIN shows ``ann(<index> nprobe=N)``.

A single-scan scan -> filter -> aggregate over a table of at least
``streaming_min_rows`` rows streams, as in the JAX session: the scan stages
a ChunkSource (the chunks its zone maps keep) instead of the device image,
and exec/streaming.py folds it chunk by chunk.  The chunks are Parquet
segments in the cold tier (``Database(cold_dir=...)`` or the
``cold_fs_dir`` flag) or in host memory.

The write half is the JAX session's, without its replicated-tier hooks:
INSERT ... VALUES / SELECT (small
ones row by row through the row tier, large ones bulk), AUTO_INCREMENT,
REPLACE and INSERT ... ON DUPLICATE KEY UPDATE, UPDATE and DELETE (WHERE
evaluated region by region with the session's own expression compiler on the
session's device; a full-primary-key equality takes a host mask), BEGIN /
COMMIT / ROLLBACK (one writer lease per table, rollback restores the region
pre-images; DDL commits an open transaction), ALTER TABLE ADD / DROP COLUMN,
and ``Database(data_dir=...)``: the catalog in ``catalog.json``, each table's
WAL and Parquet checkpoint, recovered by the next Database over the
directory (the JAX package's layout: either package reads the other's).

Reads follow MVCC (storage/mvcc.py): ``SET SNAPSHOT = 'now' | <ts> | 0``
pins the session; outside a transaction and off the mesh, an analytical
SELECT (GROUP BY or an aggregate) pins a fresh timestamp for its own run.
A pinned read of a table written past the pin stages the versioned batch
(the live image plus the history alive at the pin, ``visibility_mask`` in
its ``sel``), which the executor and its kernels read like any batch; a
quiet table keeps its fast paths.  A WHERE that fixes the primary key
answers from the host (a point read); a selective equality on a KEY column
stages only its rows; region zone maps drop regions before staging or
streaming; EXPLAIN shows the choice as ``access=...``.

A single-statement SELECT goes through the plan cache, as in the JAX
session: plan/paramize.py hoists its WHERE literals into a params vector
and keys an LRU of plans (``plan_cache_size`` per session) on the
statement's shape, so every literal variant reuses one plan; a table
version bump replans (keeping the entry when the plan signature holds), a
view change or DDL drops it, and a pinned read of a table written past the
pin, or a flag change, plans afresh.  Each SELECT counts one of ``plan_cache_hits`` /
``plan_cache_param_hits`` / ``plan_cache_misses`` and leaves a row in
``information_schema.query_log``.  The access paths (point read, KEY
equality, zone maps, chunk pruning) see each execution's literals.
PREPARE / EXECUTE [USING ...] / DEALLOCATE PREPARE bind ``?`` positions
(user variables too) and ride the same path.  EXPLAIN ANALYZE runs the
query once, always traced, and renders its lines (per-operator live rows,
``-- run``, ``-- batch``, ``-- snapshot``, ``-- params``, ``-- dispatch``,
``-- exchange``, ``-- stream``, ``-- trace``) from the trace's span
records.  ``Database.qos`` (utils/qos.py) gates admission per statement
sign, user and table.  Concurrent parameterized statements of one shape
over full table images run through the batched dispatcher
(exec/dispatch.py): one lane-batched execution (exec/lanes.py) per tick.

The lifecycle planes are the JAX session's, off the cluster.  Every
committed change is a binlog event (storage/binlog.py): INSERT with its row
images (a statement image past ``BINLOG_ROW_IMAGES_MAX`` rows), UPDATE and
DELETE with old / new images when a subscription or view reads the table
(``cdc.wants_rows``), upserts, LOAD DATA, TRUNCATE, ALTER and the TTL purge
with statement images; a transaction's events wait for COMMIT and go at
ROLLBACK.  CREATE / DROP SUBSCRIPTION and FETCH read it (cdc/streams.py).
CREATE MATERIALIZED VIEW keeps an integer GROUP BY's partials folded from
its change stream (cdc/views.py), and ALTER TABLE ADD ROLLUP a hidden
partial-aggregate table refreshed when the base moves (index/rollup.py);
a GROUP BY either covers is rewritten over the hidden table before the
plan cache (``/*mv*/`` / ``/*rollup*/`` in its key), EXPLAIN shows the
rewrite, and the automatic analytical pin defers to them.  Their seeds,
rescans and refreshes are GROUP BYs over the base table, so on the card
they launch the group kernels.  TTL=<s> [TTL_COLUMN=c] tables purge on
``ttl_tick`` / HANDLE ttl; ALTER TABLE ADD [UNIQUE | GLOBAL [UNIQUE]] INDEX
backfills online (meta/ddl.py; HANDLE ddl suspend | resume,
``information_schema.ddl_work``).

A ``Database(fleet=...)`` replicates every table through the in-process
Raft fleet (storage/replicated.py): SHOW REGIONS, ``information_schema.
regions`` and HANDLE's fleet commands (``drop_instance``, ``migrate``,
``add_instance``, ``add_peer``, ``remove_peer``, ``trans_leader``,
``add_learner``, ``remove_learner``, ``split_region``, ``merge_region``,
``store_heartbeat``, ``balance_tick``, ``compact``) read and drive it.

A join's build side or a sorted GROUP BY over a whole table (the planner's
``presort``) takes a host permutation of the table's key columns, cached per
version, instead of a device sort (``_collect_batches``, under the JAX
session's guards); the radix join runs under ``radix_join_buckets``.

A fleet-bound Database with ``cold_dir`` keeps a cold tier: HANDLE
cold_flush <db.t> [upto] evicts hot rows into Parquet segments on the
external FS with the manifest raft-committed, cold_gc merges them, and
cold_status reports; a rebuild spans hot and cold
(``information_schema.cold_segments``).

``Database(device, cluster="host:port")`` is the multi-process variant: the
tables' regions live in store daemons (server/store_server.py) placed by a
meta daemon, reached over TCP (storage/remote_tier.py).  A SELECT of one
table that the stores can evaluate row-wise runs there as a pushed fragment
(plan/fragment.py, dispatched by exec/fragments.py) while the table is not
attached (``pushdown_reads`` = auto), always (= always) or never (= off);
the stores' hosts fold the rows and only partials cross the wire, and
EXPLAIN / EXPLAIN ANALYZE (``-- fragments:``) and
``information_schema.fragments`` show it.  Any other statement pulls the
table's image once (``TableStore.attach_replicated_lazy``) and runs on this
session's device, through the kernels.  A table created with BINLOG=1
writes its change events into the cluster's distributed binlog
(storage/binlog_regions.py), in the data's own 2PC for an autocommit write
and per table at COMMIT, with a per-table retry queue (``_TableBinlogRetry``)
for an append that failed.  The telemetry poller merges the daemons'
metrics (``information_schema.cluster_metrics``, SHOW STATUS
``cluster.*``).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import functools
import itertools
import json
import logging
import os
import re
import shutil
import socket
import tempfile
import threading
import time
import weakref
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..column.batch import ColumnBatch
from ..errors import NotPortedError
from ..exec import dispatch, egress, executor, streaming
from ..exec import fragments as _fragments  # noqa: F401 — registers the
# fragment_pushdown / fragment_retry_max flags at session load
from ..expr.ast import AggCall, Call, ColRef, Lit, Subquery, WindowCall
from ..expr.compile import ExprError, eval_output, eval_predicate
from ..expr.params import PARAMS_KEY, ParamError
from ..cdc import ChangeStreams, MatViews, is_mv_table
from ..index import annindex
from ..index import globalindex as gi
from ..index import rollup
from ..index.selector import analyze_conjuncts, choose_access, is_point_statement, point_key
from ..meta.catalog import Catalog, IndexInfo, parse_type
from ..meta.ddl import DdlManager
from ..meta.privileges import READ, WRITE, AccessError, PrivilegeManager
from ..obs import progress, trace
from ..obs.flightrec import FlightRecorder, device_stats, metric_delta, metric_marks
from ..obs.progress import PROGRESS, QueryKilled
from ..obs.telemetry import Telemetry
from ..obs.watchdog import QueryWatchdog
from ..parallel.mesh import Mesh
from ..plan import paramize
from ..plan.distribute import distribute
from ..plan.nodes import (AggNode, ExchangeNode, JoinNode, MultiJoinNode,
                          PlanNode, ScanNode, plan_signature)
from ..plan.planner import PlanError, Planner, parse_vector
from ..sql.lexer import SqlError
from ..sql.parser import parse_sql
from ..sql.stmt import (AlterTableStmt, CreateDatabaseStmt, CreateMatViewStmt,
                        CreateSubscriptionStmt, CreateTableStmt, CreateUserStmt,
                        CreateViewStmt, DeallocateStmt, DeleteStmt, DescribeStmt,
                        DropDatabaseStmt, DropMatViewStmt, DropSubscriptionStmt,
                        DropTableStmt, DropUserStmt, DropViewStmt, ExecuteStmt,
                        ExplainStmt, FetchStmt, GrantStmt, HandleStmt, InsertStmt, KillStmt,
                        LoadDataStmt, OrderItem, PrepareStmt, RevokeStmt, SelectItem,
                        SelectStmt, SetStmt, ShowStmt, TableRef, TruncateStmt, TxnStmt,
                        UpdateStmt, UseStmt)
from ..storage.binlog import Binlog
from ..storage.coldfs import ExternalFS
from ..storage.column_store import (ROWID, TableStore, check_cold_readable, commit_group,
                                    schema_to_arrow)
from ..storage.mvcc import MvccRuntime, SnapshotRefused
from ..storage.streamchunks import ChunkSource, chunk_set
from ..types import Field, LType, Schema
from ..utils import metrics
from ..utils.device import resolve_device
from ..utils.flags import FLAGS, FlagError, define

define("param_queries", True,
       "auto-parameterize WHERE literals (plan/paramize.py): one plan-cache "
       "entry serves every literal variant of a query shape; 0 restores "
       "SQL-text-keyed caching with baked literals")

_LOG = logging.getLogger(__name__)

# the JAX session's server version string (its _SERVER_VARS["version"])
SERVER_VERSION = "8.0.0-baikaldb-tpu"

# connection ids, one counter per process as in the JAX session
_CONN_IDS = itertools.count(1)


def next_conn_id() -> int:
    """One connection-id space for embedded Sessions and wire connections:
    KILL <id> and the processlist Id column resolve against the same
    counter whichever door the client came through."""
    return next(_CONN_IDS)


# an INSERT ... SELECT of at most this many rows goes row by row through the
# row tier (primary-key checked, WAL-durable); a larger one is a bulk append
# (the JAX session's HOT_INSERT_ROWS)
HOT_INSERT_ROWS = 100_000

# DDL commits an open transaction first (MySQL)
_DDL = (CreateTableStmt, DropTableStmt, CreateDatabaseStmt, DropDatabaseStmt,
        TruncateStmt, AlterTableStmt, CreateViewStmt, DropViewStmt, CreateMatViewStmt,
        DropMatViewStmt)

# what SHOW VARIABLES reports beside the flags (the JAX session's
# _SERVER_VARS; only version_comment names this package)
_SERVER_VARS = {
    "version": SERVER_VERSION,
    "version_comment": "baikaldb_tpu_torch (PyTorch/CUDA)",
    "lower_case_table_names": "0",
    "max_allowed_packet": str(1 << 24),
    "character_set_server": "utf8mb4",
    "character_set_client": "utf8mb4",
    "character_set_results": "utf8mb4",
    "collation_server": "utf8mb4_bin",
    "collation_connection": "utf8mb4_bin",
    "autocommit": "ON",
    "sql_mode": "STRICT_TRANS_TABLES",
    "tx_isolation": "REPEATABLE-READ",
    "transaction_isolation": "REPEATABLE-READ",
    "wait_timeout": "28800",
    "interactive_timeout": "28800",
    "net_write_timeout": "60",
    "time_zone": "SYSTEM",
    "system_time_zone": "UTC",
    "init_connect": "",
    "license": "Apache-2.0",
    "performance_schema": "0",
}

# the connection-environment functions answered before planning
_ENV_FNS = ("database", "schema", "user", "current_user", "session_user",
            "system_user", "connection_id", "version")

# an event of more rows than this carries a statement image instead of
# row images (the JAX session's cut)
BINLOG_ROW_IMAGES_MAX = 1000

# information_schema tables of the JAX package's XLA executable cache,
# which has no counterpart in the port
_INFO_XLA = ("executables", "aot_cache")


def _opt_on(v) -> bool:
    """Table-option truth: parser option values arrive as strings, so
    BINLOG=0 / BINLOG=false read as off."""
    if v is None:
        return False
    return str(v).strip().lower() not in ("", "0", "false", "off", "no")


def _env_alias(e):
    """MySQL column captions of environment expressions: SELECT @@version
    titles its column '@@version', DATABASE() titles it 'DATABASE()'."""
    if isinstance(e, Call):
        if e.op == "__sysvar__":
            return "@@" + e.args[0].value
        if e.op == "__uservar__":
            return "@" + e.args[0].value
        if e.op in _ENV_FNS and not e.args:
            return f"{e.op.upper()}()"
    return None


@functools.lru_cache(maxsize=64)
def _show_like_rx(pat: str):
    """SHOW ... LIKE matcher: MySQL LIKE, case-insensitive."""
    from ..expr.compile import _like_to_regex

    return re.compile(_like_to_regex(pat), re.IGNORECASE)


def _component_owner(name: str, vcols: dict):
    for v in vcols:
        if name.startswith(f"__{v}_") and name[len(v) + 3:].isdigit():
            return v
    return None


def _vector_matrix(col, name: str, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """A list or fixed-size list column -> ([n, dim] float32 matrix, [n]
    NULL mask), read from Arrow's values and offsets; a NULL vector's row
    is zeros and a NULL component reads NaN, as in the JAX session.  A
    vector of another length raises the JAX session's PlanError."""
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    n = len(arr)
    isnull = arr.is_null().to_numpy(zero_copy_only=False)
    if pa.types.is_fixed_size_list(arr.type):
        size = arr.type.list_size
        lengths = np.full(n, size, np.int64)
        starts = (arr.offset + np.arange(n, dtype=np.int64)) * size
    elif pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type):
        offs = arr.offsets.to_numpy().astype(np.int64)
        lengths, starts = np.diff(offs), offs[:-1]
    else:
        raise PlanError(f"vector column {name!r} expects a list column, got {arr.type}")
    if (lengths[~isnull] != dim).any():
        raise PlanError(f"vector column {name!r} expects dim {dim}")
    mat = np.zeros((n, dim), np.float32)
    live = ~isnull
    if not live.any():
        return mat, isnull
    values = arr.values
    flat = np.asarray(values.to_numpy(zero_copy_only=False), np.float32)
    if live.all() and (np.diff(starts) == dim).all():
        first = int(starts[0])
        mat[:] = flat[first:first + n * dim].reshape(n, dim)
    else:
        mat[live] = flat[starts[live][:, None] + np.arange(dim)]
    return mat, isnull


def _expand_vector_arrow(t: pa.Table, vcols: dict) -> pa.Table:
    """Split list-typed vector columns into float32 component columns
    (NULL vectors allowed, like the row path), in bulk: one matrix from the
    column's flattened values, no Python object per element."""
    for name, dim in vcols.items():
        if name not in t.column_names:
            continue
        mat, isnull = _vector_matrix(t.column(name), name, dim)
        comps = torch.from_numpy(mat).T.contiguous().numpy()   # a blocked transpose
        mask = isnull if isnull.any() else None
        t = t.drop_columns([name])
        for i in range(dim):
            t = t.append_column(f"__{name}_{i}",
                                pa.array(comps[i], pa.float32(), mask=mask))
    return t


def _expand_vector_row(r: dict, vcols: dict) -> dict:
    out = dict(r)
    for name, dim in vcols.items():
        if name in out:
            vals = parse_vector(out.pop(name), dim)
            for i, x in enumerate(vals):
                out[f"__{name}_{i}"] = x
    return out


@dataclass
class Result:
    """Query result: a result set or an affected-rows count."""
    columns: list[str] = field(default_factory=list)
    arrow: Optional[pa.Table] = None
    affected_rows: int = 0
    plan_text: Optional[str] = None

    @property
    def rows(self) -> list[tuple]:
        if self.arrow is None:
            return []
        cols = [self.arrow.column(i).to_pylist() for i in range(self.arrow.num_columns)]
        return [tuple(c[i] for c in cols) for i in range(self.arrow.num_rows)]

    def to_pylist(self) -> list[dict]:
        return [] if self.arrow is None else self.arrow.to_pylist()

    def scalar(self):
        r = self.rows
        return r[0][0] if r else None


class _TableBinlogRetry:
    """One table's CDC retry state: a queue of failed distributed-binlog
    event batches and the lock that serializes this table's drain / append
    rounds (rank 20 in the JAX package's order: taken inside the store lock,
    10, by the autocommit CDC path, and before the replicated tier's, 30,
    when a queued append retries; two tables' locks are never nested)."""

    __slots__ = ("mu", "q")

    def __init__(self):
        self.mu = threading.Lock()
        self.q: deque = deque()


class Database:
    """Catalog + table stores, all on one device, and the MVCC plane (one
    TSO client and one snapshot pin registry).  ``cold_dir`` (or the
    ``cold_fs_dir`` flag) roots the cold tier the streamed scans keep their
    chunk segments in.  With ``data_dir`` the database is durable: each
    table gets a WAL for its committed DML, DDL persists the catalog as
    ``catalog.json``, ``checkpoint()`` flushes Parquet and resets the WALs,
    and a new Database over the directory recovers the committed state.

    The lifecycle planes: ``binlog`` (storage/binlog.py, WAL-backed as
    ``binlog.wal`` under ``data_dir``) takes every committed change as an
    event; ``cdc`` (cdc/streams.py) holds the subscriptions over it and
    ``matviews`` (cdc/views.py) the materialized views, both attached
    before recovery so that recovery re-arms them on the recovered
    cursors; ``ddl`` (meta/ddl.py) runs online ADD INDEX backfills on a
    daemon thread, and recovery resubmits the unfinished ones.

    The observability planes: ``telemetry`` (obs/telemetry.py: this
    frontend's registry, the device and process gauges), ``privileges``
    (meta/privileges.py: users and grants), ``processlist`` (the wire
    server's connections, server/mysql_server.py), ``flightrec``
    (obs/flightrec.py: every finished statement, with a forensic bundle for
    slow, killed and failed ones) and ``watchdog`` (obs/watchdog.py: scans
    this database's live queries on demand; its thread runs only in
    cluster mode, as in the JAX package).

    ``fleet`` (a raft.fleet.StoreFleet over a meta.service.MetaService):
    every table's row tier is raft-replicated across the fleet's stores
    (storage/replicated.py): DML quorum-commits through the region groups,
    the MVCC clock is the meta service's TSO (one per fleet, shared by every
    Database on it), and a new Database over the same fleet rebuilds each
    table it creates from the replicas.  ``read_replica="follower"`` rebuilds
    from non-leader replicas within ``read_max_lag`` applied entries,
    optionally only on instances tagged ``read_tag`` (an OLAP-isolated
    reader).  A fleet-bound Database takes no ``data_dir`` (the replicas are
    its durability); with ``cold_dir`` it keeps a cold tier of Parquet
    segments whose manifest the region groups replicate.

    ``cluster`` (a storage.remote_tier.ClusterClient, or "host:port" of the
    meta daemon) is the multi-process variant of ``fleet``: the same
    replication, but the regions live in store daemon processes reached over
    TCP (server/store_server.py).  The meta daemon and its stores join the
    telemetry scrape, which polls in the background, and the watchdog's
    thread runs.  Binlogged tables (BINLOG=1) write the cluster's
    distributed binlog (``dist_binlog``); an append that fails queues per
    table and retries on later commits."""

    def __init__(self, device=None, cold_dir: Optional[str] = None,
                 data_dir: Optional[str] = None, fleet=None, cluster=None,
                 read_replica: str = "leader", read_tag: str = "",
                 read_max_lag: int = 0):
        if isinstance(cluster, str):
            from ..storage.remote_tier import ClusterClient

            cluster = ClusterClient(cluster)
        if data_dir and (fleet is not None or cluster is not None):
            # the replicated tier is the durability of a fleet-bound table;
            # skipping the WAL the caller asked for would be worse
            raise ValueError("data_dir cannot combine with fleet/cluster "
                             "mode: durability lives in the replicated tier")
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.stores: dict[str, TableStore] = {}
        self.cold_dir = cold_dir
        self._cold_fs = None
        self.fleet = fleet
        self.cluster = cluster
        self.read_replica = read_replica
        self.read_tag = read_tag
        self.read_max_lag = int(read_max_lag)
        self.mvcc = MvccRuntime(fleet.meta.tso.gen if fleet is not None else None)
        self.data_dir = data_dir
        # admission control (utils/qos.QosManager), off unless set; the
        # engine-wide batched dispatcher; the query log
        # (information_schema.query_log)
        self.qos = None
        self.dispatcher = dispatch.BatchDispatcher()
        self.query_log: deque = deque(maxlen=1000)
        self.telemetry = Telemetry()
        self.privileges = PrivilegeManager()
        self.processlist: dict[int, dict] = {}
        self.flightrec = FlightRecorder()
        self.watchdog = QueryWatchdog(db=self)
        # per-table queues of distributed-binlog batches whose append failed
        # (bounded; overflow counts in metrics.binlog_events_dropped)
        self._binlog_retry: dict[str, _TableBinlogRetry] = {}
        self._binlog_retry_reg_mu = threading.Lock()    # the registry dict only
        self._dist_binlog = None
        if cluster is not None:
            # the meta daemon and its registered stores join the scrape set
            # (the store list refreshes per poll), polled in the background
            self.telemetry.attach_meta(f"{cluster.meta.host}:{cluster.meta.port}")
            self.telemetry.start()
            self.watchdog.start()
        self.ddl = DdlManager(self)
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self.binlog = Binlog(path=os.path.join(data_dir, "binlog.wal"))
        else:
            self.binlog = Binlog()
        self.cdc = ChangeStreams(self)
        self.matviews = MatViews(self)
        if data_dir:
            self._recover()

    def close(self) -> None:
        """Stop the telemetry and the watchdog, the MVCC GC thread, if one
        was started, and the DDL worker."""
        self.telemetry.stop()
        self.watchdog.stop()
        self.mvcc.stop_gc()
        self.ddl.stop()

    _BINLOG_RETRY_MAX = 1024    # queued batches a table; beyond, the oldest drop

    def binlog_retry_queue(self, table_key: str) -> _TableBinlogRetry:
        """This table's retry state (made at first use)."""
        rq = self._binlog_retry.get(table_key)
        if rq is None:
            with self._binlog_retry_reg_mu:
                rq = self._binlog_retry.setdefault(table_key, _TableBinlogRetry())
        return rq

    def binlog_retry_pending(self) -> list[str]:
        """Tables with queued retry batches (an unlocked snapshot: callers
        take the table's lock before acting)."""
        return [tk for tk, rq in list(self._binlog_retry.items()) if rq.q]

    def binlog_retry_depth(self, table_key: Optional[str] = None) -> int:
        """Queued batches, of one table or of all."""
        if table_key is not None:
            rq = self._binlog_retry.get(table_key)
            return len(rq.q) if rq is not None else 0
        return sum(len(rq.q) for rq in list(self._binlog_retry.values()))

    def discard_binlog_retry(self, table_key: str) -> None:
        """Forget a dropped table's retry state: its queued batches count as
        dropped (no table, nothing to replay them to)."""
        with self._binlog_retry_reg_mu:
            rq = self._binlog_retry.pop(table_key, None)
        if rq is not None:
            with rq.mu:
                while rq.q:
                    metrics.binlog_events_dropped.add(len(rq.q.popleft()))

    def drain_binlog_retry(self, dist) -> None:
        """Re-attempt the queued appends, table by table: one table's dead
        binlog region stops only its own queue."""
        for tk in self.binlog_retry_pending():
            rq = self.binlog_retry_queue(tk)
            with rq.mu:
                self._drain_rq_locked(rq, tk, dist)

    def _drain_rq_locked(self, rq: _TableBinlogRetry, table_key: str, dist) -> None:
        """Arrival-order drain of one table's queue; the first failure stops
        it (later batches must not jump the queue).  Caller holds rq.mu."""
        q = rq.q
        for _ in range(len(q)):
            events = q.popleft()
            try:
                dist.append(table_key, events)
            except Exception:   # noqa: BLE001 — the region is still down: retry later
                q.appendleft(events)
                break

    def _queue_rq_locked(self, rq: _TableBinlogRetry, events: list) -> None:
        """Caller holds rq.mu."""
        rq.q.append(events)
        metrics.binlog_retry_queued.add(len(events))
        while len(rq.q) > self._BINLOG_RETRY_MAX:
            metrics.binlog_events_dropped.add(len(rq.q.popleft()))

    def dist_binlog(self):
        """The cluster's distributed binlog writer (storage/binlog_regions.py),
        or None off the daemon plane or with the binlog_regions flag off."""
        if self.cluster is None:
            return None
        # the module defines the binlog_regions flag
        from ..storage.binlog_regions import DistributedBinlog

        if not FLAGS.binlog_regions:
            return None
        if self._dist_binlog is None:
            self._dist_binlog = DistributedBinlog(self.cluster)
        return self._dist_binlog

    def make_store(self, info) -> TableStore:
        """A table's store on this database's device, joined to its MVCC
        plane; under ``data_dir`` it loads its checkpoint and replays its
        WAL; on a fleet it binds to the table's replicated tier (made at the
        first CREATE over the fleet) and replays the replicas' rows."""
        st = TableStore(info, self.device)
        st.attach_mvcc(self.mvcc)
        if self.fleet is not None:
            from ..storage.replicated import ReplicatedRowTier

            key = f"{info.database}.{info.name}"
            tier = ReplicatedRowTier.get_or_create(self.fleet, info.table_id, key,
                                                   st._row_schema(), [ROWID])
            fs = self.cold_fs()
            check_cold_readable(tier, fs, key)
            cold = tier.cold_rows(fs) if fs is not None else None
            hot = None
            if self.read_replica == "follower":
                hot = tier.follower_rows(max_lag=self.read_max_lag,
                                         resource_tag=self.read_tag)
            st.attach_replicated(tier, cold_rows=cold, hot_rows=hot)
            return st
        if self.cluster is not None:
            from ..storage.remote_tier import RemoteRowTier

            key = f"{info.database}.{info.name}"
            tier = RemoteRowTier.get_or_create(self.cluster, key, st._row_schema(), [ROWID])
            fs = self.cold_fs()
            # checked now even for a deferred attach: a frontend that cannot
            # read the cold tier refuses the table at CREATE, not at a query
            check_cold_readable(tier, fs, key)
            if not info.name.startswith("__") and \
                    _opt_on((info.options or {}).get("binlog")):
                # binlog is opt-in a table (BINLOG=1); hidden backing tables
                # (global indexes, rollups) ride their main table's events
                st.binlog_sink = self.dist_binlog()
                st.binlog_db = self
            if str(FLAGS.pushdown_reads) != "off":
                # defer the full-region pull: eligible SELECTs run as pushed
                # fragments on the store daemons; the image is pulled when a
                # statement needs it
                st.attach_replicated_lazy(tier, fs)
                return st
            cold = tier.cold_rows(fs) if fs is not None else None
            st.attach_replicated(tier, cold_rows=cold)
            return st
        if self.data_dir:
            key = f"{info.database}.{info.name}"
            pq_dir = os.path.join(self.data_dir, key)
            if os.path.isdir(pq_dir):
                st.load_parquet(pq_dir)
            st.durable_dir = pq_dir
            st.attach_wal(os.path.join(self.data_dir, key + ".wal"))
        return st

    def save_catalog(self) -> None:
        """``catalog.json`` in the JAX package's layout (written to a
        temporary name, then moved into place), the subscriptions and
        materialized views with it."""
        if not self.data_dir:
            return
        dbs = [d for d in self.catalog.databases() if d != "information_schema"]
        out = {"databases": dbs, "tables": []}
        for db in dbs:
            for t in self.catalog.tables(db):
                info = self.catalog.get_table(db, t)
                out["tables"].append({
                    "database": db, "name": t,
                    "fields": [[f.name, f.ltype.value, f.nullable]
                               for f in info.schema.fields],
                    "indexes": [[ix.name, ix.kind, list(ix.columns),
                                 {k: v for k, v in ix.params.items() if k != "fresh_at"}]
                                for ix in info.indexes],
                    "options": dict(info.options or {}),
                })
        out["views"] = [{"database": k.split(".", 1)[0], "name": k.split(".", 1)[1], **v}
                        for k, v in sorted(self.catalog._views.items())
                        if k.split(".", 1)[0] in dbs]
        out["subscriptions"] = self.cdc.to_meta()
        out["matviews"] = self.matviews.to_meta()
        tmp = os.path.join(self.data_dir, "catalog.json.tmp")
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, os.path.join(self.data_dir, "catalog.json"))

    def _recover(self) -> None:
        path = os.path.join(self.data_dir, "catalog.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            saved = json.load(f)
        for db in saved["databases"]:
            if db not in self.catalog.databases():
                self.catalog.create_database(db, if_not_exists=True)
        resume: list[tuple[str, IndexInfo]] = []
        for t in saved["tables"]:
            fields = tuple(Field(n, LType(v), nullable) for n, v, nullable in t["fields"])
            indexes = [IndexInfo(ix[0], ix[1], ix[2], ix[3] if len(ix) > 3 else {})
                       for ix in t["indexes"]]
            info = self.catalog.create_table(t["database"], t["name"], Schema(fields),
                                             indexes, options=t["options"],
                                             if_not_exists=True)
            key = f"{t['database']}.{t['name']}"
            self.stores[key] = self.make_store(info)
            resume += [(key, ix) for ix in indexes if ix.params.get("state") == "backfilling"]
        for v in saved.get("views", []):
            self.catalog.create_view(v["database"], v["name"], v["sql"],
                                     v.get("columns"), or_replace=True)
        # the binlog recovered its cursors first: these re-attach the
        # subscriptions (and their GC holds) and the views to them
        self.cdc.recover(saved.get("subscriptions"))
        self.matviews.recover(saved.get("matviews"))
        # interrupted backfills resume once every table is loaded: the
        # worker saves the catalog at publish
        for key, ix in resume:
            self.ddl.submit(key, ix)

    def checkpoint(self) -> None:
        """Flush every table's live state to Parquet and reset the WALs."""
        if not self.data_dir:
            raise RuntimeError("checkpoint requires a data_dir")
        for key, st in self.stores.items():
            st.checkpoint(os.path.join(self.data_dir, key))
        self.save_catalog()

    def cold_fs(self, required: bool = False):
        """The external cold-storage FS, or None when unconfigured
        (``required``: a PlanError instead)."""
        if self._cold_fs is None:
            root = self.cold_dir or str(FLAGS.cold_fs_dir)
            if root:
                self._cold_fs = ExternalFS(root)
        if required and self._cold_fs is None:
            raise PlanError("no cold storage configured (set cold_dir or "
                            "the cold_fs_dir flag)")
        return self._cold_fs


class Session:
    def __init__(self, db: Optional[Database] = None, database: str = "default",
                 device=None, mesh: Optional[Mesh] = None, user: str = "root"):
        """``mesh``: when set, every SELECT is distributed over its shards
        (the MPP mode); the database, unless given, lives on the mesh's
        first device.  ``user``: the authenticated account; each statement
        is checked against its grants before it runs."""
        if db is None:
            db = Database(mesh.home if device is None and mesh is not None else device)
        elif device is not None and resolve_device(device) != db.device:
            raise ValueError(f"session device {device} differs from the "
                             f"database's {db.device}")
        self.db = db
        self.device = db.device
        self.mesh = mesh
        self.current_db = database
        self.session_vars: dict = {}     # SET name = value without GLOBAL
        self._conn_id = next_conn_id()
        self.user = user
        # the open SQL transaction: table key -> TxnContext, or None; its
        # binlog events, appended at COMMIT and dropped at ROLLBACK
        self._sql_txn: Optional[dict] = None
        self._txn_binlog: list = []
        # set while a view's seed / rescan or a rollup's refresh runs its
        # internal GROUP BY: it reads the base table, never a rewrite
        self._in_mv_refresh = False
        self._in_rollup_refresh = False
        # SET SNAPSHOT: (pin id, snapshot ts) in the database's registry
        self._snapshot: Optional[tuple[int, int]] = None
        # the snapshot ts the current SELECT reads at (0 = unpinned)
        self._snap_ts = 0
        # access-path batches (secondary gathers, zone-map subsets), keyed
        # by table, version and path; bounded
        self._access_batches: dict = {}
        # the plan cache (lookup key -> entry, LRU) and PREPAREd statements
        self._plan_cache: OrderedDict = OrderedDict()
        self._prepared: dict = {}
        # per-SELECT state of the parameterized path: the slots the access
        # paths substitute, whether this SELECT already counted its cache
        # outcome, the query_log outcome override, the mesh's selectivity
        self._param_subst: Optional[dict] = None
        self._param_counted = False
        self._qlog_outcome: Optional[str] = None
        self._where_sel_hint = None

    def connection_id(self) -> int:
        """This session's id in the processlist and KILL space, answered by
        CONNECTION_ID()."""
        return self._conn_id

    # -- access control ---------------------------------------------------
    def _stmt_dbs(self, s) -> set[str]:
        """Databases a SELECT reads: FROM, joins, CTEs, unions and the
        expression subqueries (WHERE, items, HAVING), so a subquery cannot
        read around the grants (database-granular, as the reference)."""
        out: set[str] = set()

        def walk_expr(e):
            if e is None:
                return
            if isinstance(e, Subquery):
                walk_sel(e.stmt)
                return
            for a in getattr(e, "args", ()):
                walk_expr(a)

        def walk_sel(st):
            refs = ([st.table] if st.table is not None else []) + [j.table for j in st.joins]
            for r in refs:
                if r.subquery is not None:
                    walk_sel(r.subquery)
                else:
                    out.add(r.database or self.current_db)
            for j in st.joins:
                walk_expr(j.on)
            for it in st.items:
                walk_expr(it.expr)
            walk_expr(st.where)
            walk_expr(st.having)
            for _, sub in st.ctes:
                walk_sel(sub)
            if st.union is not None:
                walk_sel(st.union[1])

        walk_sel(s)
        return out or {self.current_db}

    def _access_check(self, s) -> None:
        """Raise ``AccessError`` unless this session's user may run ``s``:
        user and grant statements and HANDLE need SUPER, reads a READ grant
        on every database they read, writes and DDL a WRITE grant (and READ
        on what feeds them), as in the JAX session."""
        P = self.db.privileges
        if isinstance(s, (CreateUserStmt, DropUserStmt, GrantStmt, RevokeStmt, HandleStmt)):
            u = P.users.get(self.user)
            if u is None or not u.is_super:
                raise AccessError(f"{type(s).__name__} requires SUPER")
            return
        if isinstance(s, SelectStmt):
            for db in self._stmt_dbs(s):
                P.check(self.user, db, READ)
            return
        if isinstance(s, (InsertStmt, UpdateStmt, DeleteStmt, TruncateStmt, LoadDataStmt)):
            P.check(self.user, s.table.database or self.current_db, WRITE)
            # the reads feeding the write need grants too (INSERT ... SELECT,
            # subqueries in WHERE and assignments)
            if isinstance(s, InsertStmt) and s.select is not None:
                for db in self._stmt_dbs(s.select):
                    P.check(self.user, db, READ)

            def sub_dbs(e):
                if e is None:
                    return
                if isinstance(e, Subquery):
                    for db in self._stmt_dbs(e.stmt):
                        P.check(self.user, db, READ)
                    return
                for a in getattr(e, "args", ()):
                    sub_dbs(a)

            sub_dbs(getattr(s, "where", None))
            for _, e in getattr(s, "assignments", []) or []:
                sub_dbs(e)
            return
        if isinstance(s, (CreateTableStmt, DropTableStmt, AlterTableStmt, CreateViewStmt,
                          DropViewStmt, CreateMatViewStmt, DropMatViewStmt)):
            P.check(self.user, s.table.database or self.current_db, WRITE)
            return
        if isinstance(s, (CreateSubscriptionStmt, DropSubscriptionStmt)):
            db = (s.table.database if getattr(s, "table", None) is not None
                  else None) or self.current_db
            P.check(self.user, db, READ)
            return
        if isinstance(s, (CreateDatabaseStmt, DropDatabaseStmt)):
            P.check(self.user, s.name, WRITE)
            return
        if isinstance(s, UseStmt):
            P.check(self.user, s.database, READ)
            return
        if isinstance(s, ExplainStmt):
            for db in self._stmt_dbs(s.stmt):
                P.check(self.user, db, READ)
            return
        if isinstance(s, DescribeStmt):
            P.check(self.user, s.table.database or self.current_db, READ)
            return
        if isinstance(s, ShowStmt):
            # a SHOW of another database needs a grant there
            db = s.database or (s.table.database if s.table is not None
                                else None) or self.current_db
            P.check(self.user, db, READ)

    def _log_binlog(self, event_type, db_name, table, rows=None, statement="",
                    affected=0) -> None:
        """One change event: row images up to ``BINLOG_ROW_IMAGES_MAX`` rows,
        else the statement image; inside a transaction it waits for
        COMMIT."""
        if rows and len(rows) > BINLOG_ROW_IMAGES_MAX:
            statement = statement or f"bulk insert {len(rows)} rows"
            rows = None
        if self._sql_txn is not None:
            self._txn_binlog.append((event_type, db_name, table, rows, statement, affected))
            return
        self.db.binlog.append(event_type, db_name, table, rows=rows, statement=statement,
                              affected=affected)

    # -- the connection environment ----------------------------------------
    def _sysvar(self, name: str):
        """@@name: a session SET overrides the server's value; the flags are
        visible too (SHOW VARIABLES lists them)."""
        if name in ("tx_isolation", "transaction_isolation"):
            # one variable under two spellings in MySQL
            for k in ("transaction_isolation", "tx_isolation"):
                if k in self.session_vars:
                    return self.session_vars[k]
            return _SERVER_VARS[name]
        if name in self.session_vars:
            return self.session_vars[name]
        if name in _SERVER_VARS:
            if name == "autocommit":
                return 1 if self.session_vars.get("autocommit", "ON") in ("ON", 1) else 0
            return _SERVER_VARS[name]
        flags = FLAGS.snapshot()
        if name in flags:
            return flags[name]
        raise SqlError(f"Unknown system variable '{name}'")

    def _resolve_session_exprs(self, stmt):
        """The connection environment (@@sysvars, @user vars, DATABASE() /
        USER() / VERSION() / CONNECTION_ID()) -> literals before planning,
        with MySQL's column captions where an item has no alias, in a
        SELECT and in the expressions of UPDATE, DELETE and INSERT ...
        SELECT.  A statement that names none comes back as it was (the
        caller's test for keeping the plan cache)."""
        changed = [False]

        def lit(v):
            changed[0] = True
            return Lit(v)

        def walk_e(e):
            if isinstance(e, Call):
                if e.op == "__sysvar__":
                    return lit(self._sysvar(e.args[0].value))
                if e.op == "__uservar__":
                    return lit(self.session_vars.get("@" + e.args[0].value))
                if e.op in ("database", "schema") and not e.args:
                    return lit(self.current_db or None)
                if e.op in ("user", "current_user", "session_user",
                            "system_user") and not e.args:
                    return lit(f"{self.user}@localhost")
                if e.op == "connection_id" and not e.args:
                    return lit(self.connection_id())
                if e.op == "version" and not e.args:
                    return lit(SERVER_VERSION)
                return Call(e.op, tuple(walk_e(a) for a in e.args))
            if isinstance(e, AggCall):
                return AggCall(e.op, tuple(walk_e(a) for a in e.args), e.distinct)
            if isinstance(e, WindowCall):
                return WindowCall(e.op, tuple(walk_e(a) for a in e.args),
                                  tuple(walk_e(p) for p in e.partition_by),
                                  tuple((walk_e(oe), asc) for oe, asc in e.order_by),
                                  e.running, e.frame)
            if isinstance(e, Subquery):
                return Subquery(walk_s(e.stmt))
            return e

        def opt(e):
            return None if e is None else walk_e(e)

        def walk_t(t):
            if t is not None and t.subquery is not None:
                return replace(t, subquery=walk_s(t.subquery))
            return t

        def walk_s(st: SelectStmt) -> SelectStmt:
            return replace(
                st,
                items=[SelectItem(opt(it.expr), it.alias or _env_alias(it.expr),
                                  it.star_table) for it in st.items],
                table=walk_t(st.table),
                where=opt(st.where),
                group_by=[walk_e(g) for g in st.group_by],
                having=opt(st.having),
                order_by=[OrderItem(walk_e(o.expr), o.asc) for o in st.order_by],
                joins=[replace(j, table=walk_t(j.table), on=opt(j.on)) for j in st.joins],
                ctes=[(n, walk_s(c)) for n, c in st.ctes],
                union=None if st.union is None else (st.union[0], walk_s(st.union[1])))

        if isinstance(stmt, SelectStmt):
            out = walk_s(stmt)
        elif isinstance(stmt, UpdateStmt):
            out = replace(stmt, assignments=[(n, walk_e(e)) for n, e in stmt.assignments],
                          where=opt(stmt.where))
        elif isinstance(stmt, DeleteStmt):
            out = replace(stmt, where=opt(stmt.where))
        elif isinstance(stmt, InsertStmt) and stmt.select is not None:
            out = replace(stmt, select=walk_s(stmt.select))
        else:
            return stmt
        return out if changed[0] else stmt

    # -- entry points ---------------------------------------------------
    def execute(self, sql: str) -> Result:
        metrics.queries_total.add(1)
        t0 = time.perf_counter()
        marks = metric_marks()          # the flight recorder's counter baseline
        err: Optional[BaseException] = None
        spans: list = []
        # the progress record lives for the statement's whole life, so SHOW
        # PROCESSLIST, the watchdog and KILL from other threads see it
        with progress.track(sql, conn_id=self.connection_id(), user=self.user,
                            db=self.db, dbname=self.current_db) as qp:
            try:
                tmark = trace.mark()
                with trace.root("query", sql):
                    try:
                        res = self._execute(sql)
                    finally:
                        # the live buffer dies with the root: copy it first
                        spans = trace.since(tmark)
            except Exception as e:
                metrics.queries_failed.add(1)
                err = e
                raise
            finally:
                dur_ms = (time.perf_counter() - t0) * 1e3
                metrics.query_latency.observe(dur_ms)
                if dur_ms > FLAGS.slow_query_ms:
                    metrics.slow_queries.add(1)
                self._flight_record(sql, qp, dur_ms, err, marks, spans)
                # the exception's traceback holds this frame: drop the
                # frame's hold on it, so a killed or failed query's tensors
                # go when the caller lets the exception go, not at a GC pass
                err = None
        if res.arrow is not None:
            metrics.rows_returned.add(res.arrow.num_rows)
        if res.affected_rows:
            metrics.dml_rows.add(res.affected_rows)
        return res

    def _flight_record(self, sql: str, qp, dur_ms: float, err: Optional[BaseException],
                       marks: dict, spans: list) -> None:
        """The flight-recorder entry of the statement that just finished: a
        summary always, and the forensic bundle (plan, trace spans, counter
        deltas, device memory, exchange summary) when it was slow, killed
        or failed."""
        try:
            killed = isinstance(err, QueryKilled)
            slow = dur_ms > float(FLAGS.slow_query_ms)
            summary = {
                "query_id": getattr(qp, "query_id", 0),
                "conn_id": getattr(qp, "conn_id", 0),
                "user": self.user, "db": self.current_db,
                "text": sql, "dur_ms": round(dur_ms, 3),
                "status": "killed" if killed else "error" if err is not None else "ok",
                "error": "" if err is None else f"{type(err).__name__}: {err}",
                "phase_ms": {k: round(v, 3) for k, v in qp.phase_ms().items()},
                "rows": getattr(qp, "rows_done", 0),
                "batches": getattr(qp, "batches_done", 0),
                "rounds": getattr(qp, "round_no", 0),
            }
            bundle = None
            if killed or err is not None or slow:
                plan = getattr(qp, "plan", None)
                bundle = {
                    "plan": (plan.tree_repr() if hasattr(plan, "tree_repr") else str(plan))
                    if plan is not None else "",
                    "spans": spans,
                    "metric_delta": metric_delta(marks),
                    "device_stats": device_stats(),
                    "exchange": getattr(qp, "exchange", None),
                }
            self.db.flightrec.record(summary, bundle=bundle)
        except Exception:       # noqa: BLE001 — forensics never fail a query
            metrics.count_swallowed("session.flight_record")

    def _execute(self, sql: str) -> Result:
        progress.current().beat(phase="parse")
        with trace.span("parse"):
            stmts = parse_sql(sql)
        if self.db.qos is not None:
            # COMMIT / ROLLBACK are exempt: shedding load must never pin a
            # transaction open; a batch is charged per statement
            billable = sum(1 for s in stmts if not isinstance(s, TxnStmt))
            if billable:
                self.db.qos.admit(sql, cost=float(billable), user=self.user,
                                  tables=self._qos_tables(stmts))
        if len(stmts) == 1 and isinstance(stmts[0], SelectStmt):
            self._access_check(stmts[0])
            stmt = self._resolve_session_exprs(stmts[0])
            # session-substituted literals are session state: never cached
            return self._select(stmt, cache_key=(sql, self.current_db)
                                if stmt is stmts[0] else None)
        res = Result()
        for s in stmts:
            # checked right before each statement: an earlier USE in the
            # batch changes what an unqualified name resolves to
            self._access_check(s)
            res = self._execute_stmt(s)
        return res

    def _qos_tables(self, stmts) -> tuple:
        """Base tables a statement batch touches directly (FROM, joins, DML
        target): the per-table admission dimension.  Shallow on purpose, as
        in the JAX session: subquery tables ride free."""
        out: list[str] = []
        for s in stmts:
            for t in [getattr(s, "table", None)] + \
                    [j.table for j in getattr(s, "joins", ()) or ()]:
                if t is not None and getattr(t, "subquery", None) is None \
                        and getattr(t, "name", None):
                    out.append(f"{t.database or self.current_db}.{t.name}")
        return tuple(dict.fromkeys(out))

    def query(self, sql: str) -> list[dict]:
        return self.execute(sql).to_pylist()

    def load_arrow(self, table_name: str, table: pa.Table,
                   database: str | None = None) -> int:
        """Bulk ingest: append an Arrow table straight into the store; a
        vector column arrives as a list or fixed-size list column."""
        store = self._store(TableRef(database, table_name))
        vcols = (store.info.options or {}).get("vector_cols") or {}
        if vcols:
            table = _expand_vector_arrow(table, vcols)
        self._ingest_arrow(store, table)
        return table.num_rows

    # -- statements -----------------------------------------------------
    def _execute_stmt(self, s) -> Result:
        if isinstance(s, _DDL):
            self._commit_txn()
            # this session's plans may name what the DDL changes; other
            # sessions' entries go stale through store identity, versions
            # and the catalog's view generation
            self._plan_cache.clear()
        if isinstance(s, PrepareStmt):
            return self._prepare_stmt(s)
        if isinstance(s, ExecuteStmt):
            return self._execute_prepared(s)
        if isinstance(s, DeallocateStmt):
            if s.name not in self._prepared:
                raise PlanError(f"unknown prepared statement {s.name!r}")
            del self._prepared[s.name]
            return Result()
        if isinstance(s, (SelectStmt, UpdateStmt, DeleteStmt, InsertStmt)):
            # the environment is legal wherever MySQL takes an expression
            s = self._resolve_session_exprs(s)
        if isinstance(s, SelectStmt):
            return self._select(s)
        if isinstance(s, ExplainStmt) and s.fmt == "analyze":
            return self._explain_analyze(self._resolve_session_exprs(s.stmt))
        if isinstance(s, CreateTableStmt):
            return self._create_table(s)
        if isinstance(s, InsertStmt):
            return self._insert(s)
        if isinstance(s, UpdateStmt):
            return self._update(s)
        if isinstance(s, DeleteStmt):
            return self._delete(s)
        if isinstance(s, TxnStmt):
            return self._txn_stmt(s)
        if isinstance(s, SetStmt):
            return self._set_stmt(s)
        if isinstance(s, ExplainStmt) and s.fmt != "analyze":
            cand = self._pushdown_candidate(s.stmt)
            if cand is not None:
                # a pushed fragment shows what the stores run and what this
                # frontend finishes
                text = self._render_pushdown(*cand)
                return Result(columns=["plan"], plan_text=text,
                              arrow=pa.table({"plan": text.split("\n")}))
            # a view or rollup that would answer shows as its rewrite
            stmt = self._try_matview(s.stmt, refresh=False) or \
                self._try_rollup(s.stmt, refresh=False) or s.stmt
            text = self._annotate_access(self._plan_select(stmt)).tree_repr()
            return Result(columns=["plan"], plan_text=text,
                          arrow=pa.table({"plan": text.split("\n")}))
        if isinstance(s, AlterTableStmt):
            return self._alter_table(s)
        if isinstance(s, CreateViewStmt):
            return self._create_view(s)
        if isinstance(s, DropViewStmt):
            try:
                self.db.catalog.drop_view(s.table.database or self.current_db,
                                          s.table.name, s.if_exists)
            except ValueError as e:
                raise PlanError(str(e)) from None
            self.db.save_catalog()
            return Result()
        if isinstance(s, DropTableStmt):
            db = s.table.database or self.current_db
            indexes = []
            if self.db.catalog.has_table(db, s.table.name):
                indexes = self.db.catalog.get_table(db, s.table.name).indexes
            self.db.catalog.drop_table(db, s.table.name, s.if_exists)
            key = f"{db}.{s.table.name}"
            self._drop_durable(key, self.db.stores.pop(key, None))
            self._forget_access(key)
            annindex.manager(self.db).forget(key)
            # the views over it, its rollups' and global indexes' hidden
            # tables go with it
            self.db.matviews.drop_for_base(self, key)
            for ix in indexes:
                if ix.kind == "rollup":
                    self._drop_hidden(db, rollup.rollup_table_name(s.table.name, ix.name))
                elif gi.is_global(ix):
                    self._drop_global_backing(db, s.table.name, ix)
            self.db.save_catalog()
            return Result()
        if isinstance(s, TruncateStmt):
            store = self._store(s.table)
            store.truncate()
            self._forget_access(f"{store.info.database}.{store.info.name}")
            for _, bstore in self._coupled_global(store):
                bstore.truncate()       # the index entries go with the rows
            self._log_binlog("truncate", s.table.database or self.current_db, s.table.name,
                             statement="truncate")
            return Result()
        if isinstance(s, CreateMatViewStmt):
            try:
                self.db.matviews.create(self, s.table.database or self.current_db,
                                        s.table.name, s.select_sql, s.if_not_exists)
            except ValueError as e:
                raise PlanError(str(e)) from None
            return Result()
        if isinstance(s, DropMatViewStmt):
            self.db.matviews.drop(self, s.table.database or self.current_db, s.table.name,
                                  s.if_exists)
            return Result()
        if isinstance(s, CreateSubscriptionStmt):
            table_key = None
            if s.table is not None:
                tdb = s.table.database or self.current_db
                self.db.catalog.get_table(tdb, s.table.name)   # unknown: raises now
                table_key = f"{tdb}.{s.table.name}"
            try:
                self.db.cdc.create(s.name, table_key, if_not_exists=s.if_not_exists)
            except ValueError as e:
                raise PlanError(str(e)) from None
            self.db.save_catalog()
            return Result()
        if isinstance(s, DropSubscriptionStmt):
            try:
                sub = self.db.cdc.subs.get(s.name)
                if sub is not None and sub.internal:
                    raise PlanError(f"subscription {s.name!r} maintains a materialized "
                                    "view; drop the view instead")
                self.db.cdc.drop(s.name, s.if_exists)
            except KeyError as e:
                raise PlanError(str(e.args[0])) from None
            self.db.save_catalog()
            return Result()
        if isinstance(s, FetchStmt):
            return self._fetch_stmt(s)
        if isinstance(s, CreateDatabaseStmt):
            self.db.catalog.create_database(s.name, if_not_exists=s.if_not_exists)
            self.db.save_catalog()
            return Result()
        if isinstance(s, DropDatabaseStmt):
            self.db.catalog.drop_database(s.name, s.if_exists)
            for k in [k for k in self.db.stores if k.startswith(s.name + ".")]:
                self._drop_durable(k, self.db.stores.pop(k))
                self._forget_access(k)
                annindex.manager(self.db).forget(k)
            self.db.save_catalog()
            return Result()
        if isinstance(s, UseStmt):
            if s.database not in self.db.catalog.databases():
                raise PlanError(f"unknown database {s.database!r}")
            self.current_db = s.database
            return Result()
        if isinstance(s, DescribeStmt):
            return self._describe(s)
        if isinstance(s, ShowStmt):
            return self._show(s)
        if isinstance(s, LoadDataStmt):
            return self._load_data(s)
        if isinstance(s, HandleStmt):
            return self._handle(s)
        if isinstance(s, KillStmt):
            return self._kill(s)
        if isinstance(s, CreateUserStmt):
            self.db.privileges.create_user(s.name, s.password, s.if_not_exists)
            return Result()
        if isinstance(s, DropUserStmt):
            self.db.privileges.drop_user(s.name, s.if_exists)
            return Result()
        if isinstance(s, GrantStmt):
            self.db.privileges.grant(s.user, s.level, s.db)
            return Result()
        if isinstance(s, RevokeStmt):
            self.db.privileges.revoke(s.user, s.db)
            return Result()
        raise SqlError(f"unsupported statement {type(s).__name__}")

    def _kill(self, s: KillStmt) -> Result:
        """KILL [QUERY | CONNECTION] <id>: flip the cancel token of the
        connection's live statements; the victim's own thread raises
        ``QueryKilled`` at its next progress beat, so no exception is
        injected across threads and no side effect is torn.  CONNECTION
        also marks a wire connection for teardown and shuts its socket
        (server/mysql_server.py registers it), so even an idle connection
        dies now."""
        tid = int(s.target_id)
        n = PROGRESS.kill(conn_id=tid, db=self.db, reason=f"kill {s.kind} {tid}")
        known = bool(n) or tid in self.db.processlist or tid == self._conn_id
        if s.kind == "connection":
            ent = self.db.processlist.get(tid)
            if ent is not None:
                ent["kill"] = True
                sock = ent.get("_sock")
                if sock is not None:
                    # wakes a connection blocked in read(); the serve loop
                    # sees the kill marker and tears down
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
        if not known:
            raise SqlError(f"Unknown thread id: {tid}")
        return Result()

    def _set_stmt(self, s: SetStmt) -> Result:
        """SET GLOBAL name = value updates the flag registry; SET SNAPSHOT
        pins or releases this session's read timestamp; other names are
        kept per session (SHOW VARIABLES reports them), as MySQL clients set
        them on connect and expect silent success."""
        for name, value in [(s.name, s.value)] + list(s.more):
            if name.lower() == "snapshot":
                self._set_snapshot(value)
            elif s.scope == "global":
                try:
                    FLAGS.set_flag(name, value)
                except FlagError as e:
                    raise SqlError(str(e)) from None
            else:
                self.session_vars[name] = value
        return Result()

    # -- catalog statements (the JAX session's, without the planes the
    # port lacks: no durable catalog, binlog, rollups or global indexes) --
    def _create_view(self, s: CreateViewStmt) -> Result:
        db = s.table.database or self.current_db
        cat = self.db.catalog
        prior = cat.get_view(db, s.table.name)
        try:
            cat.create_view(db, s.table.name, s.select_sql, s.columns, s.or_replace)
        except ValueError as e:
            raise PlanError(str(e)) from None
        # the body must plan against the current tables: its errors surface
        # at CREATE, and a failed OR REPLACE keeps the previous definition
        try:
            self._plan_select(parse_sql(f"SELECT * FROM `{db}`.`{s.table.name}`")[0])
        except Exception:
            if prior is not None:
                cat.create_view(db, s.table.name, prior["sql"], prior.get("columns"),
                                or_replace=True)
            else:
                cat.drop_view(db, s.table.name, if_exists=True)
            raise
        self.db.save_catalog()
        return Result()

    def _describe(self, s: DescribeStmt) -> Result:
        db = s.table.database or self.current_db
        if self.db.catalog.get_view(db, s.table.name) is not None:
            # a view: plan its body (no execution) and read the root's schema
            stmt = parse_sql(f"SELECT * FROM `{db}`.`{s.table.name}`")[0]
            fields = self._plan_select(stmt).schema.fields
            return Result(columns=["Field", "Type", "Null", "Key"],
                          arrow=pa.table({"Field": [f.name for f in fields],
                                          "Type": [f.ltype.value for f in fields],
                                          "Null": ["YES" if f.nullable else "NO"
                                                   for f in fields],
                                          "Key": [""] * len(fields)}))
        info = self.db.catalog.get_table(db, s.table.name)
        pk = info.primary_key()
        pkcols = set(pk.columns) if pk else set()
        vcols = (info.options or {}).get("vector_cols") or {}
        names, types, nulls, keys = [], [], [], []
        for f in info.schema.fields:
            owner = _component_owner(f.name, vcols)
            if owner is not None:
                # a vector column shows once, as vector(d)
                if not names or names[-1] != owner:
                    names.append(owner)
                    types.append(f"vector({vcols[owner]})")
                    nulls.append("YES")
                    keys.append("")
                continue
            names.append(f.name)
            types.append(f.ltype.value)
            nulls.append("YES" if f.nullable else "NO")
            keys.append("PRI" if f.name in pkcols else "")
        return Result(columns=["Field", "Type", "Null", "Key"],
                      arrow=pa.table({"Field": names, "Type": types, "Null": nulls,
                                      "Key": keys}))

    def _show(self, s: ShowStmt) -> Result:
        """The SHOW forms that read only the catalog, the stores and the
        flags.  Global-index backing tables and the hidden tables of rollups
        and materialized views are internal: SHOW TABLES and TABLE STATUS
        leave them out."""
        cat = self.db.catalog

        def like(name: str) -> bool:
            return s.pattern is None or _show_like_rx(s.pattern).match(name) is not None

        def visible(db):
            return ([n for n in cat.tables(db) if not gi.is_backing_table(n)
                     and not rollup.is_rollup_table(n) and not is_mv_table(n)],
                    list(cat.views(db)))

        if s.what in ("profile", "profiles"):
            return self._show_profile(s)
        if s.what == "databases":
            return Result(columns=["Database"],
                          arrow=pa.table({"Database": cat.databases()}))
        if s.what in ("tables", "full_tables"):
            db = s.database or self.current_db
            tbls, views = visible(db)
            names = [n for n in sorted(tbls + views) if like(n)]
            cols = {f"Tables_in_{db}": names}
            if s.what == "full_tables":
                cols["Table_type"] = ["VIEW" if n in views else "BASE TABLE" for n in names]
            return Result(columns=list(cols), arrow=pa.table(cols))
        if s.what == "create_table":
            return self._show_create(s)
        if s.what == "collation":
            # the collations the engine implements: _bin comparisons, and
            # utf8mb4_general_ci through COLLATE
            rows = [r for r in (("utf8mb4_bin", "utf8mb4", 46, "Yes"),
                                ("utf8mb4_general_ci", "utf8mb4", 45, ""),
                                ("binary", "binary", 63, "Yes")) if like(r[0])]
            return Result(
                columns=["Collation", "Charset", "Id", "Default", "Compiled", "Sortlen"],
                arrow=pa.table({"Collation": [r[0] for r in rows],
                                "Charset": [r[1] for r in rows],
                                "Id": pa.array([r[2] for r in rows], pa.int64()),
                                "Default": [r[3] for r in rows],
                                "Compiled": ["Yes"] * len(rows),
                                "Sortlen": pa.array([1] * len(rows), pa.int64())}))
        if s.what == "charset":
            rows = [r for r in (("utf8mb4", "UTF-8 Unicode", "utf8mb4_bin", 4),
                                ("binary", "Binary pseudo charset", "binary", 1))
                    if like(r[0])]
            return Result(
                columns=["Charset", "Description", "Default collation", "Maxlen"],
                arrow=pa.table({"Charset": [r[0] for r in rows],
                                "Description": [r[1] for r in rows],
                                "Default collation": [r[2] for r in rows],
                                "Maxlen": pa.array([r[3] for r in rows], pa.int64())}))
        if s.what == "engines":
            # the JAX session's row, with this engine's own comment
            return Result(
                columns=["Engine", "Support", "Comment", "Transactions", "XA", "Savepoints"],
                arrow=pa.table({"Engine": ["BaikalTPU"], "Support": ["DEFAULT"],
                                "Comment": ["columnar HTAP engine (PyTorch/CUDA)"],
                                "Transactions": ["YES"], "XA": ["NO"],
                                "Savepoints": ["YES"]}))
        if s.what == "table_status":
            db = s.database or self.current_db
            tbls, views = visible(db)
            rows = []
            for n in (n for n in tbls if like(n)):
                # a table no statement touched has no store: Rows is NULL
                # (unknown), and listing it stages nothing
                st = self.db.stores.get(f"{db}.{n}")
                pspec = (cat.get_table(db, n).options or {}).get("partition")
                rows.append((n, "BaikalTPU", st.num_rows if st is not None else None,
                             "partitioned" if pspec else "", ""))
            rows += [(n, None, None, "", "VIEW") for n in views if like(n)]
            rows.sort(key=lambda r: r[0])
            return Result(
                columns=["Name", "Engine", "Rows", "Collation", "Create_options", "Comment"],
                arrow=pa.table({
                    "Name": [r[0] for r in rows],
                    "Engine": pa.array([r[1] for r in rows], pa.string()),
                    "Rows": pa.array([r[2] for r in rows], pa.int64()),
                    "Collation": pa.array(["utf8mb4_bin" if r[1] else None for r in rows],
                                          pa.string()),
                    "Create_options": [r[3] for r in rows],
                    "Comment": [r[4] for r in rows]}))
        if s.what in ("columns", "full_columns"):
            base = self._describe(DescribeStmt(s.table)).arrow
            if s.pattern is not None:
                base = base.take([i for i, f in enumerate(base.column("Field").to_pylist())
                                  if like(f)])
            if s.what == "columns":
                return Result(columns=list(base.column_names), arrow=base)
            fields = base.column("Field").to_pylist()
            types = base.column("Type").to_pylist()
            db = s.table.database or self.current_db
            auto_col = None
            if cat.get_view(db, s.table.name) is None:
                auto_col = (cat.get_table(db, s.table.name).options or {}).get("auto_increment")
            n = len(fields)
            return Result(
                columns=["Field", "Type", "Collation", "Null", "Key", "Default", "Extra",
                         "Privileges", "Comment"],
                arrow=pa.table({
                    "Field": fields, "Type": types,
                    "Collation": pa.array(["utf8mb4_bin" if t == "string" else None
                                           for t in types], pa.string()),
                    "Null": base.column("Null"), "Key": base.column("Key"),
                    "Default": pa.array([None] * n, pa.string()),
                    "Extra": ["auto_increment" if f == auto_col else "" for f in fields],
                    "Privileges": ["select,insert,update,references"] * n,
                    "Comment": [""] * n}))
        if s.what == "index":
            info = cat.get_table(s.table.database or self.current_db, s.table.name)
            rows = [(s.table.name, ix.name, ix.kind, seq, c)
                    for ix in info.indexes for seq, c in enumerate(ix.columns, 1)]
            return Result(
                columns=["Table", "Key_name", "Index_type", "Seq_in_index", "Column_name"],
                arrow=pa.table({"Table": [r[0] for r in rows],
                                "Key_name": [r[1] for r in rows],
                                "Index_type": [r[2] for r in rows],
                                "Seq_in_index": pa.array([r[3] for r in rows], pa.int64()),
                                "Column_name": [r[4] for r in rows]}))
        if s.what == "variables":
            vals = dict(_SERVER_VARS)
            vals.update({k: str(v) for k, v in self.session_vars.items()
                         if not k.startswith("@")})
            vals.update({k: str(v).lower() if isinstance(v, bool) else str(v)
                         for k, v in FLAGS.snapshot().items()})
            items = [(k, v) for k, v in sorted(vals.items()) if like(k)]
            return Result(columns=["Variable_name", "Value"],
                          arrow=pa.table({"Variable_name": [k for k, _ in items],
                                          "Value": [v for _, v in items]}))
        if s.what == "status":
            vals = {"Threads_connected": str(len(self.db.processlist)), "Uptime": "0"}
            # the engine's counters flattened (the bvar dump), the kernel
            # launch counters among them
            for name, st in metrics.REGISTRY.expose().items():
                for k, v in st.items():
                    vals[f"{name}.{k}"] = str(v)
            # the fleet's cluster.* rows appear only with daemons registered
            if self.db.telemetry.has_daemons():
                vals.update(self.db.telemetry.status_rows())
            vals.update(self.db.watchdog.status_rows())
            items = [(k, v) for k, v in sorted(vals.items()) if like(k)]
            return Result(columns=["Variable_name", "Value"],
                          arrow=pa.table({"Variable_name": [k for k, _ in items],
                                          "Value": [v for _, v in items]}))
        if s.what == "processlist":
            return self._show_processlist(s)
        if s.what == "grants":
            user = s.user or self.user
            lines = [f"GRANT {lv} ON {'*' if db == '*' else db}.* TO '{user}'"
                     for db, lv in self.db.privileges.grants_of(user)]
            return Result(columns=[f"Grants for {user}"],
                          arrow=pa.table({f"Grants for {user}": lines}))
        if s.what == "regions":
            # the stores' column regions (the raft regions of a fleet are
            # information_schema.regions), as the JAX session lists them
            rows = []
            for key, st in sorted(self.db.stores.items()):
                if s.table is not None and \
                        key != f"{s.table.database or self.current_db}.{s.table.name}":
                    continue
                rows += [(key, r.region_id, r.num_rows, r.version) for r in st.regions]
            return Result(columns=["Table", "Region_id", "Rows", "Version"],
                          arrow=pa.table({
                              "Table": [r[0] for r in rows],
                              "Region_id": pa.array([r[1] for r in rows], pa.int64()),
                              "Rows": pa.array([r[2] for r in rows], pa.int64()),
                              "Version": pa.array([r[3] for r in rows], pa.int64())}))
        raise SqlError(f"unsupported SHOW {s.what!r}")

    def _show_processlist(self, s: ShowStmt) -> Result:
        """The wire connections (``db.processlist``) merged with the live
        progress records of this database: an embedded session mid-query
        shows with no socket.  Info is cut at 100 characters unless FULL."""
        now = time.time()
        merged: dict[int, dict] = {}
        for cid, ent in dict(self.db.processlist).items():
            merged[cid] = {"user": ent.get("user", ""), "host": ent.get("host", ""),
                           "db": ent.get("db", ""), "command": ent.get("command", "Sleep"),
                           "time_s": int(now - ent.get("since", now)), "state": "",
                           "info": ent.get("info", "")}
        for qp in PROGRESS.live(self.db):
            row = merged.setdefault(qp.conn_id, {"user": qp.user, "host": qp.host,
                                                 "db": qp.dbname})
            row.update(command=qp.command, time_s=int(qp.elapsed_s()), state=qp.state(),
                       info=qp.text)
        rows = sorted(merged.items())
        infos = [r.get("info", "") for _, r in rows]
        if not s.full:
            infos = [i[:100] for i in infos]
        return Result(
            columns=["Id", "User", "Host", "db", "Command", "Time", "State", "Info"],
            arrow=pa.table({
                "Id": pa.array([i for i, _ in rows], pa.int64()),
                "User": [r.get("user", "") for _, r in rows],
                "Host": [r.get("host", "") for _, r in rows],
                "db": [r.get("db", "") for _, r in rows],
                "Command": [r.get("command", "Sleep") for _, r in rows],
                "Time": pa.array([r.get("time_s", 0) for _, r in rows], pa.int64()),
                "State": [r.get("state", "") for _, r in rows],
                "Info": infos}))

    def _show_profile(self, s: ShowStmt) -> Result:
        """SHOW PROFILES / SHOW PROFILE [FOR QUERY n] over the kept traces
        (obs/trace.py): the span tree EXPLAIN ANALYZE renders from, one row
        a span, indented by depth."""
        # introspection never keeps its own trace
        trace.discard()
        if s.what == "profiles":
            recs = trace.TRACER.list()
            return Result(
                columns=["Query_ID", "Duration_ms", "Kind", "Query"],
                arrow=pa.table({
                    "Query_ID": pa.array([r["query_id"] for r in recs], pa.int64()),
                    "Duration_ms": pa.array([r["duration_ms"] for r in recs], pa.float64()),
                    "Kind": [r["kind"] for r in recs],
                    "Query": [r["text"] for r in recs]}))
        rec = trace.TRACER.get(s.query_id) if s.query_id is not None else trace.TRACER.last()
        if rec is None:
            where = f"query {s.query_id}" if s.query_id is not None else "any query"
            raise PlanError(f"no kept trace for {where} (enable tracing: "
                            "SET GLOBAL tracing = 1; see SHOW PROFILES)")
        rows = trace.span_tree(rec)
        return Result(
            columns=["Status", "Duration_ms", "Node"],
            arrow=pa.table({
                "Status": ["  " * d + sp["name"] for d, sp in rows],
                "Duration_ms": pa.array([sp["dur_ms"] for _, sp in rows], pa.float64()),
                "Node": [sp.get("node") or "frontend" for _, sp in rows]}))

    def _show_create(self, s: ShowStmt) -> Result:
        db = s.table.database or self.current_db
        cat = self.db.catalog
        view = cat.get_view(db, s.table.name)
        if view is not None:
            cols = f" ({', '.join(view['columns'])})" if view["columns"] else ""
            ddl = f"CREATE VIEW `{s.table.name}`{cols} AS {view['sql']}"
            return Result(columns=["View", "Create View"],
                          arrow=pa.table({"View": [s.table.name], "Create View": [ddl]}))
        info = cat.get_table(db, s.table.name)
        lines = []
        pk = info.primary_key()
        auto_col = (info.options or {}).get("auto_increment")
        for f in info.schema.fields:
            lines.append(f"  `{f.name}` {f.ltype.value.upper()}"
                         + ("" if f.nullable else " NOT NULL")
                         + (" AUTO_INCREMENT" if f.name == auto_col else ""))
        if pk:
            lines.append("  PRIMARY KEY (" + ", ".join(f"`{c}`" for c in pk.columns) + ")")
        for ix in info.indexes:
            if ix.kind != "primary":
                # the JAX session's keywords (an ANN index shows as KEY)
                kw = {"unique": "UNIQUE KEY", "fulltext": "FULLTEXT KEY",
                      "global": "GLOBAL KEY",
                      "global_unique": "GLOBAL UNIQUE KEY"}.get(ix.kind, "KEY")
                lines.append(f"  {kw} `{ix.name}` ("
                             + ", ".join(f"`{c}`" for c in ix.columns) + ")")
        ddl = f"CREATE TABLE `{s.table.name}` (\n" + ",\n".join(lines) + "\n)"
        pspec = (info.options or {}).get("partition")
        if pspec and pspec["kind"] == "hash":
            ddl += f"\nPARTITION BY HASH (`{pspec['column']}`) PARTITIONS {pspec['n']}"
        elif pspec and pspec["kind"] == "range":
            parts = ", ".join(f"PARTITION {nm} VALUES LESS THAN "
                              + ("MAXVALUE" if u is None else f"({u!r})")
                              for nm, u in zip(pspec["names"], pspec["uppers"]))
            ddl += f"\nPARTITION BY RANGE (`{pspec['column']}`) ({parts})"
        return Result(columns=["Table", "Create Table"],
                      arrow=pa.table({"Table": [s.table.name], "Create Table": [ddl]}))

    def _store(self, tref) -> TableStore:
        db = tref.database or self.current_db
        if db == "information_schema":
            raise PlanError("information_schema tables are read-only")
        key = f"{db}.{tref.name}"
        if key not in self.db.stores:
            info = self.db.catalog.get_table(db, tref.name)
            self.db.stores[key] = self.db.make_store(info)
        return self.db.stores[key]

    def _drop_hidden(self, db: str, name: str) -> None:
        """A hidden table (a rollup's, a global index's backing table) goes:
        its catalog entry, store and files."""
        self.db.catalog.drop_table(db, name, if_exists=True)
        key = f"{db}.{name}"
        self._drop_durable(key, self.db.stores.pop(key, None))
        self._forget_access(key)

    def _drop_durable(self, key: str, store) -> None:
        """A dropped table's images go, on a fleet its replicated tier's
        raft groups, and under ``data_dir`` its WAL and Parquet
        checkpoint."""
        if store is not None:
            store.release()
        if self.db.fleet is not None:
            tier = self.db.fleet.row_tiers.pop(key, None)
            if tier is not None:
                tier.release_regions()   # no ghost raft groups in the fleet
        if self.db.cluster is not None:
            tier = self.db.cluster.tiers.pop(key, None)
            if tier is not None:
                tier.release_regions()
        self.db.discard_binlog_retry(key)
        if not self.db.data_dir:
            return
        if store is not None:
            store.row_table = None      # closes the WAL file
        wal = os.path.join(self.db.data_dir, key + ".wal")
        if os.path.exists(wal):
            os.remove(wal)
        pq_dir = os.path.join(self.db.data_dir, key)
        if os.path.isdir(pq_dir):
            shutil.rmtree(pq_dir)

    def _create_table(self, s: CreateTableStmt) -> Result:
        db = s.table.database or self.current_db
        # BINLOG=1 is kept and changes nothing off the cluster (every change
        # goes to the local binlog); TTL / TTL_COLUMN are read by ttl_tick
        opts = dict(s.options or {})
        fields = []
        vector_cols: dict[str, int] = {}
        for c in s.columns:
            tl = c.type_name.strip().lower()
            if tl.startswith("vector"):
                # VECTOR(d): stored as d hidden FLOAT components, so a
                # distance is an expression over columns, as in the JAX
                # session
                try:
                    dim = int(tl.split("(")[1].rstrip(") "))
                except (IndexError, ValueError):
                    raise PlanError("VECTOR needs a dimension: VECTOR(d)")
                if not 1 <= dim <= 4096:
                    raise PlanError("VECTOR dimension out of range")
                vector_cols[c.name] = dim
                for i in range(dim):
                    fields.append(Field(f"__{c.name}_{i}", LType.FLOAT32, True))
                continue
            fields.append(Field(c.name, parse_type(c.type_name),
                                c.nullable and c.name not in s.primary_key))
        options = opts
        if vector_cols:
            options["vector_cols"] = vector_cols
        pspec = options.get("partition")
        if pspec:
            self._check_partition_spec(pspec, fields)
        auto_cols = [c for c in s.columns if c.auto_increment]
        if auto_cols:
            if len(auto_cols) > 1:
                raise PlanError("only one AUTO_INCREMENT column allowed")
            if not parse_type(auto_cols[0].type_name).is_integer:
                raise PlanError("AUTO_INCREMENT requires an integer column")
            options["auto_increment"] = auto_cols[0].name
        indexes = [IndexInfo("PRIMARY", "primary", list(s.primary_key))] \
            if s.primary_key else []
        for kind, name, cols in s.indexes:
            if kind == "ann":
                if len(cols) != 1 or cols[0] not in vector_cols:
                    raise PlanError("ANN INDEX needs exactly one VECTOR column")
                indexes.append(IndexInfo(name or f"ann_{cols[0]}", kind, cols))
            else:
                indexes.append(IndexInfo(name or f"idx_{'_'.join(cols)}", kind, cols))
        info = self.db.catalog.create_table(
            db, s.table.name, Schema(tuple(fields)), indexes, options=options or None,
            if_not_exists=s.if_not_exists)
        key = f"{db}.{s.table.name}"
        if key not in self.db.stores:
            self.db.stores[key] = self.db.make_store(info)
        for ix in info.indexes:
            if gi.is_global(ix):
                self._create_global_backing(db, info, ix)
        self.db.save_catalog()
        return Result()

    @staticmethod
    def _check_partition_spec(pspec: dict, fields: list) -> None:
        """A partition clause names a column of the table; RANGE bounds are
        distinctly named, of the column's type and strictly increasing;
        HASH takes at least one partition."""
        names = {f.name: f for f in fields}
        if pspec["column"] not in names:
            raise PlanError(f"unknown partition column {pspec['column']!r}")
        if pspec["kind"] == "range":
            if len(set(pspec["names"])) != len(pspec["names"]):
                raise PlanError("duplicate partition name")
            pf = names[pspec["column"]]
            try:
                finite = [TableStore._norm_part_scalar(u, pf)
                          for u in pspec["uppers"] if u is not None]
                bad = any(b <= a for a, b in zip(finite, finite[1:]))
            except (TypeError, ValueError) as e:
                raise PlanError(f"partition bounds do not match column "
                                f"{pspec['column']!r}: {e}") from None
            if bad:
                raise PlanError("partition bounds must be strictly increasing")
        elif pspec["kind"] == "hash" and int(pspec["n"]) < 1:
            raise PlanError("PARTITIONS must be at least 1")

    def _create_global_backing(self, db: str, info, ix) -> TableStore:
        """A global index's hidden backing table: its own catalog entry and
        its own store, keyed by (index cols, primary-key cols)."""
        for c in ix.columns:
            if c not in info.schema:
                raise PlanError(f"unknown column {c!r} in global index {ix.name!r}")
        bname = gi.backing_table_name(info.name, ix.name)
        bkey = f"{db}.{bname}"
        if bkey not in self.db.stores:
            binfo = self.db.catalog.create_table(
                db, bname, gi.backing_schema(info, ix),
                [IndexInfo("PRIMARY", "primary", gi.backing_pk(info, ix))],
                if_not_exists=True)
            self.db.stores[bkey] = self.db.make_store(binfo)
        return self.db.stores[bkey]

    def _drop_global_backing(self, db: str, table: str, ix) -> None:
        self._drop_hidden(db, gi.backing_table_name(table, ix.name))

    def _insert(self, s: InsertStmt) -> Result:
        store = self._store(s.table)
        schema = store.info.schema
        db_name = s.table.database or self.current_db
        if s.select is not None:
            t = self._select(s.select).arrow
            t = t.rename_columns(s.columns or schema.names()[:t.num_columns])
            if s.replace or s.on_dup:
                return self._insert_upsert(store, s, t.to_pylist())
            if t.num_rows <= HOT_INSERT_ROWS:
                self._insert_rows(store, t.to_pylist())
            else:
                self._ingest_arrow(store, t, check_dups=True)
            if t.num_rows > BINLOG_ROW_IMAGES_MAX:
                self._log_binlog("insert", db_name, s.table.name,
                                 statement=f"bulk insert {t.num_rows} rows",
                                 affected=t.num_rows)
            else:
                self._log_binlog("insert", db_name, s.table.name, rows=t.to_pylist(),
                                 affected=t.num_rows)
            return Result(affected_rows=t.num_rows)
        vcols = (store.info.options or {}).get("vector_cols") or {}
        # positional VALUES address user-visible columns (vector columns by
        # their own names, components hidden)
        cols = s.columns or self._user_columns(store)
        if any(len(r) != len(cols) for r in s.rows):
            raise SqlError("VALUES row length does not match column list")
        rows = [dict(zip(cols, r)) for r in s.rows]
        if vcols:
            rows = [_expand_vector_row(r, vcols) for r in rows]
        auto_col = (store.info.options or {}).get("auto_increment")
        if auto_col:
            missing = [i for i, r in enumerate(rows) if r.get(auto_col) is None]
            if missing:
                for i, v in zip(missing, store.next_auto_incr(auto_col, len(missing))):
                    rows[i][auto_col] = v
        for r in rows:
            for f in schema.fields:
                v = r.get(f.name)
                if f.ltype.is_temporal and isinstance(v, str):
                    r[f.name] = _temporal_value(v, f.ltype)
        if s.replace or s.on_dup:
            return self._insert_upsert(store, s, rows)
        self._insert_rows(store, rows)
        self._log_binlog("insert", db_name, s.table.name, rows=rows, affected=len(rows))
        return Result(affected_rows=len(rows))

    # -- global-index maintenance (the JAX session's coupled DML) ----------
    def _coupled_global(self, store: TableStore) -> list:
        """[(IndexInfo, backing store)] of the table's public global
        indexes: DML maintains their backing tables in the statement's own
        transaction."""
        info = store.info
        if gi.is_backing_table(info.name):
            return []
        out = []
        for ix in gi.public_global_indexes(info):
            bname = gi.backing_table_name(info.name, ix.name)
            bkey = f"{info.database}.{bname}"
            if bkey not in self.db.stores:
                self.db.stores[bkey] = self.db.make_store(
                    self.db.catalog.get_table(info.database, bname))
            out.append((ix, self.db.stores[bkey]))
        return out

    def _run_coupled(self, store: TableStore, coupled: list, fn_main, fns_backing: list):
        """The main table's write and each backing table's maintenance as
        one transaction: inside an open transaction they ride its contexts
        (COMMIT groups them); in autocommit they run under contexts of their
        own, committed together by ``commit_group`` (one commit stamp)."""
        if self._sql_txn is not None:
            r = fn_main(self._tctx(store))
            for (_, bstore), fb in zip(coupled, fns_backing):
                fb(self._tctx(bstore), r)
            return r
        tctxs = [store.begin_txn()]
        try:
            tctxs += [bstore.begin_txn() for _, bstore in coupled]
            r = fn_main(tctxs[0])
            for fb, t in zip(fns_backing, tctxs[1:]):
                fb(t, r)
        except BaseException:
            for t in tctxs:
                try:
                    t.rollback()
                except Exception:       # noqa: BLE001 — unwind the rest, counted
                    metrics.count_swallowed("session.coupled_rollback")
            raise
        commit_group(tctxs)
        return r

    def _ingest_arrow(self, store: TableStore, table: pa.Table,
                      check_dups: bool = False) -> None:
        """Bulk ingest; the entries of each global index land in its backing
        table in the same transaction."""
        with store._lock:
            coupled = self._coupled_global(store)
            if not coupled:
                store.insert_arrow(table, self._tctx(store), check_dups=check_dups)
                return
            info = store.info
            if any(ix.kind == "global_unique" for ix, _ in coupled):
                rows = table.to_pylist()
                for ix, bstore in coupled:
                    gi.check_unique(info, ix, bstore, rows)
            fbs = [(lambda t, _r, ix=ix, b=bstore:
                    b.insert_arrow(gi.entry_table(info, ix, table), t))
                   for ix, bstore in coupled]
            self._run_coupled(store, coupled,
                              lambda t: store.insert_arrow(table, t, check_dups=check_dups),
                              fbs)

    def _insert_rows(self, store: TableStore, rows: list[dict]) -> None:
        with store._lock:
            coupled = self._coupled_global(store)
            if not coupled:
                store.insert_rows(rows, self._tctx(store))
                return
            info = store.info
            for ix, bstore in coupled:
                gi.check_unique(info, ix, bstore, rows)
            fbs = [(lambda t, _r, ix=ix, b=bstore: b.insert_rows(gi.entry_rows(info, ix, rows), t))
                   for ix, bstore in coupled]
            self._run_coupled(store, coupled, lambda t: store.insert_rows(rows, t), fbs)

    def _delete_rows(self, store: TableStore, mask_fn, captured: Optional[list] = None) -> int:
        """``captured``: the deleted rows' images are appended to it, unless
        a global index couples the delete (the JAX session captures none
        there)."""
        with store._lock:
            coupled = self._coupled_global(store)
            if not coupled:
                if captured is not None:
                    def mask_fn(t, _inner=mask_fn):
                        m = np.asarray(_inner(t), bool)
                        if m.any():
                            captured.extend(t.filter(pa.array(m)).to_pylist())
                        return m
                return store.delete_where(mask_fn, self._tctx(store))
            info = store.info
            cols = sorted({f.name for ix, _ in coupled
                           for f in gi.backing_schema(info, ix).fields})

            def fb(t, r, ix, b):
                entries = gi.entry_table(info, ix, r[1])
                if entries.num_rows:
                    b.delete_where(None, t, rowids=b.pk_rowids(entries))
            fbs = [(lambda t, r, ix=ix, b=bstore: fb(t, r, ix, b)) for ix, bstore in coupled]
            return self._run_coupled(
                store, coupled, lambda t: store.delete_where(mask_fn, t, collect_cols=cols),
                fbs)[0]

    def _update_rows(self, store: TableStore, mask_fn, assign_fn, changed: list[str],
                     captured: Optional[list] = None) -> int:
        """``captured``: {"old", "new"} row-image pairs are appended to it,
        unless the table has a public global index (as in the JAX
        session)."""
        with store._lock:
            coupled = self._coupled_global(store)
            if captured is not None and not coupled:
                def assign_fn(t, mask, _inner=assign_fn):
                    cond = pa.array(np.asarray(mask, bool))
                    old = t.filter(cond).to_pylist()
                    out = _inner(t, mask)
                    captured.extend({"old": o, "new": w}
                                    for o, w in zip(old, out.filter(cond).to_pylist()))
                    return out
            pk = store.info.primary_key()
            pk_cols = list(pk.columns) if pk else []
            # only the indexes whose entries the assignments can change
            touched = [(ix, b) for ix, b in coupled
                       if set(changed) & set(list(ix.columns) + pk_cols)]
            if not touched:
                return store.update_where(mask_fn, assign_fn, self._tctx(store),
                                          changed_cols=changed)
            info = store.info
            cols = sorted({f.name for ix, _ in touched
                           for f in gi.backing_schema(info, ix).fields})
            # the unique check before any write: a dry run gives the rows'
            # old and new entries (the lock holds them still)
            _, dry_old, dry_new = store.update_where(
                mask_fn, assign_fn, self._tctx(store), changed_cols=changed,
                collect_cols=cols, dry_run=True)
            exclude = set(zip(*[dry_old.column(c).to_pylist() for c in pk_cols])) \
                if pk_cols and dry_old.num_rows else set()
            for ix, bstore in touched:
                gi.check_unique(info, ix, bstore, dry_new.to_pylist(), exclude_pks=exclude)

            def fb(t, r, ix, b):
                old_e, new_e = gi.entry_table(info, ix, r[1]), gi.entry_table(info, ix, r[2])
                if old_e.num_rows:
                    b.delete_where(None, t, rowids=b.pk_rowids(old_e))
                if new_e.num_rows:
                    b.insert_rows(new_e.to_pylist(), t)
            fbs = [(lambda t, r, ix=ix, b=bstore: fb(t, r, ix, b)) for ix, bstore in touched]
            return self._run_coupled(
                store, touched,
                lambda t: store.update_where(mask_fn, assign_fn, t, changed_cols=changed,
                                             collect_cols=cols),
                fbs)[0]

    def _user_columns(self, store: TableStore) -> list[str]:
        """Declared column order with vector components collapsed back to
        their user-visible vector column name."""
        vcols = (store.info.options or {}).get("vector_cols") or {}
        out: list[str] = []
        for n in store.info.schema.names():
            owner = _component_owner(n, vcols)
            if owner is None:
                out.append(n)
            elif not out or out[-1] != owner:
                out.append(owner)
        return out

    def _alter_table(self, s: AlterTableStmt) -> Result:
        """ALTER TABLE ADD / DROP COLUMN (the store rewrites its regions; a
        checkpoint boundary under ``data_dir``; a ``ddl`` binlog event), ADD
        / DROP PARTITION, ADD / DROP ROLLUP, and the index forms, as the JAX
        session does them: ADD [UNIQUE] INDEX and ADD GLOBAL [UNIQUE] INDEX
        register the index as ``backfilling`` and hand its backfill to the
        online-DDL worker (meta/ddl.py), returning the ``work_id`` at once;
        an ANN index is trained lazily on its first ANN query
        (index/annindex) and a fulltext index is built per dictionary
        (index/fulltext), so neither has a backfill; DROP INDEX takes the
        secondary kinds only (a global one's backing table with it), never
        a rollup."""
        db = s.table.database or self.current_db
        info = self.db.catalog.get_table(db, s.table.name)
        if s.action in ("add_rollup", "drop_rollup"):
            return self._alter_rollup(s, db, info)
        if s.action in ("add_partition", "drop_partition"):
            return self._alter_partition(s, db, info)
        if s.action == "drop_index":
            kept = [ix for ix in info.indexes
                    if not (ix.name == s.index_name and
                            ix.kind in ("key", "unique", "fulltext", "ann", "global",
                                        "global_unique"))]
            if len(kept) == len(info.indexes):
                raise PlanError(f"unknown index {s.index_name!r}")
            dropped = [ix for ix in info.indexes if ix not in kept]
            info.indexes = kept
            info.version += 1
            for ix in dropped:
                if gi.is_global(ix):
                    self._drop_global_backing(db, info.name, ix)
            self.db.save_catalog()
            return Result()
        if s.action == "add_index":
            return self._alter_index(s, db, info)
        if s.action not in ("add_column", "drop_column"):
            raise PlanError(f"unsupported ALTER action {s.action!r}")
        self._alter_columns(s, info)
        self.db.binlog.append("ddl", db, s.table.name,
                              statement=f"ALTER TABLE {s.table.name} {s.action}")
        self.db.save_catalog()
        return Result()

    def _alter_index(self, s: AlterTableStmt, db: str, info) -> Result:
        if s.index_kind == "ann":
            vcols = (info.options or {}).get("vector_cols") or {}
            if len(s.index_cols) != 1 or s.index_cols[0] not in vcols:
                raise PlanError("ANN INDEX needs exactly one VECTOR column")
        else:
            if not s.index_cols:
                raise PlanError("index needs at least one column")
            for c in s.index_cols:
                if c not in info.schema:
                    raise PlanError(f"unknown column {c!r}")
        prefix = {"fulltext": "ft", "global": "gidx", "global_unique": "gidx",
                  "ann": "ann"}.get(s.index_kind, "idx")
        name = s.index_name or f"{prefix}_{'_'.join(s.index_cols)}"
        if any(ix.name == name for ix in info.indexes):
            raise PlanError(f"index {name!r} exists")
        if s.index_kind in ("ann", "fulltext"):
            info.indexes.append(IndexInfo(name, s.index_kind, list(s.index_cols)))
            info.version += 1
            self.db.save_catalog()
            return Result()
        # online: choosable (and, if global, maintained by DML) only once
        # the worker publishes it
        ix = IndexInfo(name, s.index_kind, list(s.index_cols), {"state": "backfilling"})
        info.indexes.append(ix)
        if gi.is_global(ix):
            self._create_global_backing(db, info, ix)
        self.db.save_catalog()
        work = self.db.ddl.submit(f"{db}.{s.table.name}", ix)
        return Result(columns=["work_id"], arrow=pa.table({"work_id": [work.work_id]}))

    def _alter_rollup(self, s: AlterTableStmt, db: str, info) -> Result:
        """ADD ROLLUP registers the rollup and its hidden table (filled at
        the first query it answers); DROP ROLLUP drops both."""
        if s.action == "add_rollup":
            if any(ix.name == s.rollup_name for ix in info.indexes):
                raise PlanError(f"index {s.rollup_name!r} exists")
            for c in s.rollup_keys + s.rollup_aggs:
                if c not in info.schema:
                    raise PlanError(f"unknown column {c!r}")
            if not s.rollup_keys:
                raise PlanError("rollup needs at least one key column")
            sch = rollup.rollup_schema(info.schema, s.rollup_keys, s.rollup_aggs)
            rt = rollup.rollup_table_name(info.name, s.rollup_name)
            rinfo = self.db.catalog.create_table(db, rt, sch, [])
            self.db.stores[f"{db}.{rt}"] = self.db.make_store(rinfo)
            info.indexes.append(IndexInfo(s.rollup_name, "rollup", list(s.rollup_keys),
                                          {"measures": list(s.rollup_aggs), "fresh_at": -1}))
            self.db.save_catalog()
            return Result()
        kept = [ix for ix in info.indexes
                if not (ix.kind == "rollup" and ix.name == s.rollup_name)]
        if len(kept) == len(info.indexes):
            raise PlanError(f"unknown rollup {s.rollup_name!r}")
        info.indexes = kept
        self._drop_hidden(db, rollup.rollup_table_name(info.name, s.rollup_name))
        self.db.save_catalog()
        return Result()

    def _alter_partition(self, s: AlterTableStmt, db: str, info) -> Result:
        """ADD PARTITION extends a RANGE table's bounds; DROP PARTITION
        deletes the partition's rows (and their global-index entries) and
        renumbers the later partitions' region tags.  An open transaction
        was committed before this DDL ran, so no ROLLBACK crosses it."""
        spec = (info.options or {}).get("partition")
        if spec is None:
            raise PlanError(f"table {info.name!r} is not partitioned")
        store = self._store(s.table)
        if spec["kind"] != "range":
            raise PlanError(f"{s.action.replace('_', ' ').upper()} applies to RANGE "
                            "partitioning")
        if s.action == "add_partition":
            if s.partition_name in spec["names"]:
                raise PlanError(f"partition {s.partition_name!r} exists")
            if spec["uppers"] and spec["uppers"][-1] is None:
                raise PlanError("cannot ADD PARTITION after MAXVALUE")
            f = info.schema.field(spec["column"])
            if s.partition_upper is not None and spec["uppers"]:
                if store._norm_part_scalar(s.partition_upper, f) <= \
                        store._norm_part_scalar(spec["uppers"][-1], f):
                    raise PlanError("new partition bound must exceed the last bound")
            with store._lock:
                spec["names"].append(s.partition_name)
                spec["uppers"].append(s.partition_upper)
                info.version += 1
                store._bump()
            self.db.save_catalog()
            return Result()
        if s.partition_name not in spec["names"]:
            raise PlanError(f"unknown partition {s.partition_name!r}")
        if len(spec["names"]) == 1:
            raise PlanError("cannot remove all partitions; use DROP TABLE")
        pid = spec["names"].index(s.partition_name)
        with store._lock:
            def mask_fn(t):
                return store.partition_ids(t) == pid
            n = self._delete_rows(store, mask_fn)
            spec["names"].pop(pid)
            spec["uppers"].pop(pid)
            for r in store.regions:
                if r.part == pid:
                    r.part = -1          # emptied: the tag goes
                elif r.part > pid:
                    r.part -= 1
            info.version += 1
            store._bump()
        self.db.save_catalog()
        return Result(affected_rows=n)

    def _alter_columns(self, s: AlterTableStmt, info) -> None:
        fields = list(info.schema.fields)
        store = self._store(s.table)
        if s.action == "add_column":
            if s.column.name in info.schema:
                raise PlanError(f"column {s.column.name!r} exists")
            if not s.column.nullable and store.num_rows:
                raise PlanError("cannot ADD COLUMN ... NOT NULL to a non-empty "
                                "table (existing rows would hold NULL)")
            fields.append(Field(s.column.name, parse_type(s.column.type_name),
                                s.column.nullable))
        else:
            if s.column_name not in info.schema:
                raise PlanError(f"unknown column {s.column_name!r}")
            if len(fields) == 1:
                raise PlanError("cannot drop the last column")
            fields = [f for f in fields if f.name != s.column_name]
            info.indexes = [ix for ix in info.indexes if s.column_name not in ix.columns]
        store.alter_schema(Schema(tuple(fields)))

    def _load_data(self, s: LoadDataStmt) -> Result:
        """LOAD DATA INFILE: pyarrow's CSV reader into the bulk ingest, the
        primary key checked (global indexes maintained), one binlog event
        with the statement image, as in the JAX session."""
        from pyarrow import csv as pacsv

        store = self._store(s.table)
        types = {f.name: f.type for f in store.arrow_schema}
        table = pacsv.read_csv(
            s.path,
            read_options=pacsv.ReadOptions(column_names=list(types), skip_rows=s.ignore_lines),
            parse_options=pacsv.ParseOptions(delimiter=s.sep),
            convert_options=pacsv.ConvertOptions(column_types=types,
                                                 null_values=["", "\\N", "NULL"],
                                                 strings_can_be_null=True))
        self._ingest_arrow(store, table, check_dups=True)
        self._log_binlog("insert", s.table.database or self.current_db, s.table.name,
                         statement=f"LOAD DATA INFILE {s.path!r}", affected=table.num_rows)
        return Result(affected_rows=table.num_rows)

    def _handle(self, s: HandleStmt) -> Result:
        """HANDLE's in-process commands: checkpoint, gc (the row tier's MVCC
        versions), split <db.table> <rows>, set_flag <name> <value>, ttl /
        ttl_tick (``ttl_tick``), ddl suspend | resume (the online-DDL
        worker), flightrec dump '<path>' [id] | clear, add_privilege <user>
        <db|*> <read|write|all> and drop_privilege <user> <db|*>, then the
        fleet's commands (``_handle_fleet``) and the cold tier's
        (``_handle_cold``)."""
        if s.command == "checkpoint":
            self.db.checkpoint()
            return Result()
        if s.command == "flightrec" and s.args:
            # the JSON-lines export of the flight recorder
            op = s.args[0].lower()
            if op == "dump" and len(s.args) >= 2:
                rid = int(s.args[2]) if len(s.args) > 2 else None
                return Result(affected_rows=self.db.flightrec.dump(s.args[1], rec_id=rid))
            if op == "clear":
                self.db.flightrec.clear()
                return Result()
        if s.command in ("ttl", "ttl_tick"):
            return Result(affected_rows=self.ttl_tick())
        if s.command == "ddl" and s.args:
            op = s.args[0]
            if op == "suspend":
                self.db.ddl.suspend()
                return Result()
            if op in ("resume", "restart"):
                self.db.ddl.resume()
                return Result()
            raise SqlError(f"unsupported HANDLE ddl {op!r}")
        if s.command == "gc":
            for st in self.db.stores.values():
                if st.row_table is not None:
                    st.row_table.gc(st.row_table.snapshot())
            return Result()
        if s.command == "split" and len(s.args) >= 2:
            # `db.t` lexes as three tokens: the row count is the last one
            key, rows = "".join(s.args[:-1]), int(s.args[-1])
            st = self.db.stores.get(key)
            if st is None:
                raise PlanError(f"unknown table {key!r}")
            with st._lock:
                st.region_rows = rows
                for r in list(st.regions):
                    st._maybe_split(r)
                st._bump()
            return Result()
        if s.command == "add_privilege" and len(s.args) >= 3:
            self.db.privileges.grant(s.args[0], s.args[2], s.args[1])
            return Result()
        if s.command == "drop_privilege" and len(s.args) >= 2:
            self.db.privileges.revoke(s.args[0], s.args[1])
            return Result()
        if s.command == "set_flag" and len(s.args) >= 2:
            FLAGS.set_flag(s.args[0], " ".join(s.args[1:]))
            return Result()
        fleet_cmd = self._handle_fleet(s)
        if fleet_cmd is not None:
            return fleet_cmd
        if s.command in ("cold_flush", "cold_gc", "cold_status") and s.args:
            return self._handle_cold(s)
        raise SqlError(f"unsupported HANDLE command {s.command!r}")

    def _handle_cold(self, s: HandleStmt) -> Result:
        """HANDLE cold_flush <db.t> [upto_rowid]: hot rows -> one immutable
        segment a region on the external FS, manifest and eviction
        raft-committed; cold_gc merges a region's segments (the latest
        version a rowid, deletes dropped); cold_status reports the hot bytes
        and the manifest's size."""
        has_upto = s.command == "cold_flush" and len(s.args) > 1 and \
            str(s.args[-1]).isdigit()
        key = "".join(s.args[:-1] if has_upto else s.args)
        st = self.db.stores.get(key)
        if st is None or st.replicated is None:
            raise PlanError(f"no cold-capable replicated tier for {key!r}")
        fs = self.db.cold_fs(required=True)
        tier = st.replicated
        if s.command == "cold_flush":
            upto = int(s.args[-1]) if has_upto else None
            return Result(affected_rows=tier.flush_cold(fs, upto=upto))
        if s.command == "cold_gc":
            return Result(affected_rows=tier.cold_gc(fs))
        entries = sum(len(tier.cold_manifest(i)) for i in range(len(tier.region_ids())))
        return Result(columns=["hot_bytes", "cold_segments"],
                      arrow=pa.table({"hot_bytes": [tier.hot_bytes()],
                                      "cold_segments": [entries]}))

    def _handle_fleet(self, s: HandleStmt) -> Optional[Result]:
        """HANDLE's commands of a fleet-bound Database, as the JAX session
        runs them; None for any other command."""
        if s.command in ("drop_instance", "migrate") and s.args:
            # mark a store MIGRATE: balancing drains its peers
            self._fleet_required().meta.drop_instance("".join(s.args))
            return Result()
        if s.command == "add_instance" and s.args:
            # add_instance <store_addr> [resource_tag]; the lexer splits
            # "host:port" into tokens, so the tag is only a trailing token
            # that cannot be part of an address
            args = [str(a) for a in s.args]
            tag = ""
            if len(args) > 1 and ":" not in args[-1] and not args[-1].isdigit():
                tag = args[-1]
                args = args[:-1]
            self._fleet_required().meta.add_instance("".join(args), resource_tag=tag)
            return Result()
        if s.command in ("add_peer", "remove_peer", "trans_leader", "add_learner",
                         "remove_learner") and len(s.args) >= 2:
            # <region_id> <store>: validated, run and recorded in meta by the
            # fleet; a failure raises, never a success for an op not done
            try:
                self._fleet_required().operator_order(s.command, int(s.args[0]),
                                                      "".join(s.args[1:]))
            except (ValueError, RuntimeError) as e:
                raise PlanError(str(e)) from None
            return Result(affected_rows=1)
        if s.command in ("split_region", "merge_region") and s.args:
            tier, idx = self._find_region(int(s.args[0]))
            if s.command == "split_region":
                tier.split_region(idx)
            else:
                tier.merge_region(idx)
            return Result()
        if s.command in ("store_heartbeat", "balance_tick"):
            # one control-loop turn: heartbeats in, balance orders run
            return Result(affected_rows=self._fleet_required().control_tick())
        if s.command == "compact":
            # raft log compaction over every replicated tier and the meta
            fleet = self.db.fleet
            if fleet is not None:
                for tier in fleet.row_tiers.values():
                    tier.compact_all()
                if hasattr(fleet.meta, "compact_all"):
                    fleet.meta.compact_all()
            return Result()
        return None

    def _fleet_required(self):
        if self.db.fleet is None:
            raise PlanError("this HANDLE command needs a fleet-bound "
                            "Database (store fleet + meta)")
        return self.db.fleet

    def _find_region(self, region_id: int):
        """(tier, index) of the replicated region ``region_id``."""
        for tier in self._fleet_required().row_tiers.values():
            for i, m in enumerate(tier.metas):
                if m.region_id == region_id:
                    return tier, i
        raise PlanError(f"unknown region {region_id}")

    def ttl_tick(self, now=None) -> int:
        """Purge the expired rows of every TTL table (reference: store-side
        TTL timers): a table with option TTL=<seconds> drops the rows whose
        TTL_COLUMN (default create_time) is older; one delete event each.
        A misconfigured table is skipped, logged, and does not stop the
        sweep."""
        now = now or datetime.datetime.now()
        purged = 0
        for key, store in list(self.db.stores.items()):
            opts = store.info.options or {}
            if "ttl" not in opts:
                continue
            try:
                col = opts.get("ttl_column", "create_time")
                f = store.info.schema.field(col) if col in store.info.schema else None
                if f is None or not f.ltype.is_temporal:
                    raise ValueError(f"TTL column {col!r} missing or not temporal")
                cutoff = now - datetime.timedelta(seconds=int(opts["ttl"]))
                if f.ltype is LType.DATE:
                    cutoff = cutoff.date()
                n = store.purge_expired(col, cutoff)
            except Exception as exc:    # noqa: BLE001 — one table must not block the sweep
                _LOG.warning("TTL skip %s: %s", key, exc)
                continue
            if n:
                db, name = key.split(".", 1)
                self.db.binlog.append("delete", db, name,
                                      statement=f"TTL purge {col} < {cutoff}", affected=n)
            purged += n
        return purged

    # -- transactions ------------------------------------------------------
    def _txn_stmt(self, s: TxnStmt) -> Result:
        """BEGIN / COMMIT / ROLLBACK: each table the transaction touches gets
        a storage TxnContext (writer lease, row locks, buffered row-tier
        writes, region pre-images); COMMIT is one commit timestamp and one
        WAL batch per table."""
        if s.kind == "begin":
            self._commit_txn()          # BEGIN commits an open transaction
            self._sql_txn = {}
            return Result()
        if self._sql_txn is None:
            return Result()             # COMMIT / ROLLBACK outside: no-op
        if s.kind == "commit":
            self._commit_txn()
            return Result()
        txn, self._sql_txn = self._sql_txn, None
        for tctx in txn.values():
            tctx.rollback()
        self._txn_binlog.clear()        # rolled back: no subscriber sees them
        return Result()

    def _commit_txn(self) -> None:
        """COMMIT, then the transaction's binlog events in order; a failed
        commit publishes none of them."""
        if self._sql_txn is not None:
            txn, self._sql_txn = self._sql_txn, None
            try:
                commit_group(list(txn.values()))
            except BaseException:
                self._txn_binlog.clear()
                raise
        events, self._txn_binlog = self._txn_binlog, []
        # an empty commit still flows through on a cluster: queued retry
        # batches (failed appends of earlier commits) drain on any commit
        if events or self.db.binlog_retry_pending():
            with trace.span("binlog.flush", events=len(events)):
                self._flush_txn_binlog(events)

    def _flush_txn_binlog(self, events: list) -> None:
        """A committed transaction's events: the local binlog, then, for
        binlogged tables on a cluster, one distributed-binlog append a table
        (the autocommit path joins the data's own 2PC instead).  A failed
        append queues in the table's retry queue: the data already
        committed, and its events must not be lost or reordered."""
        from ..storage.binlog_regions import DistributedBinlog

        per_table: OrderedDict = OrderedDict()
        for event_type, db_name, table, rows, statement, affected in events:
            self.db.binlog.append(event_type, db_name, table, rows=rows,
                                  statement=statement, affected=affected)
            if self._table_binlogged(db_name, table):
                per_table.setdefault(f"{db_name}.{table}", []).extend(
                    DistributedBinlog.events_from_statement(
                        event_type, rows, statement, affected))
        db = self.db
        # resolved only when a binlogged event exists: it creates the
        # __binlog__ regions cluster-wide at first use
        dist = db.dist_binlog() if per_table or db.binlog_retry_pending() else None
        if dist is None:
            return
        # other tables' queued batches retry on any commit; each table's
        # lock is taken alone, never nested
        for tk in db.binlog_retry_pending():
            if tk not in per_table:
                rq = db.binlog_retry_queue(tk)
                with rq.mu:
                    db._drain_rq_locked(rq, tk, dist)
        for table_key, evs in per_table.items():
            rq = db.binlog_retry_queue(table_key)
            with rq.mu:
                db._drain_rq_locked(rq, table_key, dist)
                if rq.q:
                    # an older batch of this table is still queued: appending
                    # now would reorder the table's stream
                    db._queue_rq_locked(rq, evs)
                    continue
                try:
                    dist.append(table_key, evs)
                except Exception:   # noqa: BLE001 — committed data: queue its events
                    db._queue_rq_locked(rq, evs)

    def _table_binlogged(self, db_name: str, table: str) -> bool:
        try:
            info = self.db.catalog.get_table(db_name, table)
        except ValueError:
            return False
        return _opt_on((info.options or {}).get("binlog"))

    def _tctx(self, store: TableStore):
        """The open transaction's context for ``store`` (made at its first
        touch), or None in autocommit."""
        if self._sql_txn is None:
            return None
        key = f"{store.info.database}.{store.info.name}"
        if key not in self._sql_txn:
            self._sql_txn[key] = store.begin_txn()
        return self._sql_txn[key]

    # -- DML ---------------------------------------------------------------
    def _insert_upsert(self, store: TableStore, s, rows: list[dict]) -> Result:
        """REPLACE INTO (delete the conflicting keys, insert every row; MySQL
        counts 2 per replaced row) and INSERT ... ON DUPLICATE KEY UPDATE
        (insert the new keys, assign literals and VALUES(col) to the
        conflicting rows; 2 per updated row).  Rows are taken in order: a key
        may conflict with the table or with an earlier row of the
        statement."""
        if store._pk_cols is None:
            raise PlanError("REPLACE / ON DUPLICATE KEY needs a PRIMARY KEY")
        incoming = pa.table({f.name: [r.get(f.name) for r in rows]
                             for f in store.arrow_schema}, schema=store.arrow_schema)
        tctx = self._tctx(store)
        with store._lock:
            keys = store._encode_pk_table(incoming)
            idx = store._ensure_pk_index()
            dupset: set = set()
            new_rows: list[dict] = []
            dup_rows: list[tuple] = []
            seen: set = set()
            for k, r in zip(keys, rows):
                if k in idx or k in seen:
                    dup_rows.append((k, r))
                    if k in idx:
                        dupset.add(k)
                else:
                    new_rows.append(r)
                seen.add(k)
            batch_extras = len(rows) - len(seen)

            def mask_over(keyset):
                def pk_mask(t: pa.Table):
                    return np.asarray([k in keyset for k in store._encode_pk_table(t)], bool)
                return pk_mask

            affected = 0
            if s.replace:
                if dupset:
                    affected += self._delete_rows(store, mask_over(dupset))
                effective: dict = {}
                for k, r in zip(keys, rows):
                    effective[k] = r            # the last row of a key wins
                self._insert_rows(store, list(effective.values()))
                affected += len(rows) + batch_extras
            else:
                if new_rows:
                    self._insert_rows(store, new_rows)
                    affected += len(new_rows)
                if dup_rows:
                    mapping: dict = {}
                    for k, r in dup_rows:
                        vals = {}
                        for col, (kind, v) in s.on_dup:
                            if col not in store.info.schema:
                                raise PlanError(f"unknown column {col!r}")
                            vals[col] = r.get(v) if kind == "values" else v
                        mapping[k] = vals
                    assigned = sorted({c for c, _ in s.on_dup})

                    def assign_fn(t: pa.Table, mask):
                        ks = store._encode_pk_table(t)
                        out = t
                        for col in assigned:
                            f = store.arrow_schema.field(col)
                            old = t.column(col).to_pylist()
                            newv = [mapping.get(k, {}).get(col, old[i]) if m else old[i]
                                    for i, (k, m) in enumerate(zip(ks, np.asarray(mask)))]
                            out = out.set_column(out.column_names.index(col), f,
                                                 pa.array(newv, f.type))
                        return out

                    n = self._update_rows(store, mask_over({k for k, _ in dup_rows}), assign_fn,
                                          assigned)
                    affected += 2 * n
        # a statement image: the rows an upsert leaves differ from its VALUES
        self._log_binlog("insert", store.info.database, store.info.name, affected=affected,
                         statement=_stmt_image("replace" if s.replace else "upsert", s))
        return Result(affected_rows=affected)

    def _host_mask(self, store: TableStore, where):
        """The WHERE of an UPDATE / DELETE as a host mask function, evaluated
        by the session's own expression compiler over each region on the
        session's device: one semantics for reads and writes.  Only the
        columns WHERE reads are staged.  Each region's batch has its own
        string dictionaries, and comparisons stay within it."""
        pred = None if where is None else _qualify_free(where)

        def fn(region_table: pa.Table):
            if pred is None:
                return np.ones(region_table.num_rows, dtype=bool)
            b = _region_batch(region_table, [pred], self.device)
            return eval_predicate(pred, b).cpu().numpy()
        return fn

    def _pk_mask_fn(self, store: TableStore, key: dict):
        """Host mask of a full primary-key equality: pyarrow compute only, no
        device work.  A literal that does not cast exactly to the key's type
        (``id = 2.5``) raises here and the compiled predicate takes over."""
        sch = store.arrow_schema
        scalars = {col: pa.scalar(v).cast(sch.field(col).type) for col, v in key.items()}
        for col, v in key.items():
            if scalars[col].as_py() != v:
                raise ValueError("lossy literal cast")

        def fn(region_table: pa.Table):
            m = None
            for col, sc in scalars.items():
                c = pc.equal(region_table.column(col), sc)
                m = c if m is None else pc.and_(m, c)
            return np.asarray(pc.fill_null(m, False))
        return fn

    def _point_write_mask(self, store: TableStore, where):
        """The host primary-key mask when WHERE fixes the whole key by
        equality; None otherwise (the compiled predicate)."""
        if store._pk_cols is None or where is None:
            return None
        try:
            key = point_key(SelectStmt(items=[], where=where), store._pk_cols)
            return None if key is None else self._pk_mask_fn(store, key)
        except Exception:       # noqa: BLE001 — an odd literal: compiled path
            return None

    def _update(self, s: UpdateStmt) -> Result:
        store = self._store(s.table)
        schema = store.info.schema
        arrow_schema = store.arrow_schema
        assigns = s.assignments
        for name, _ in assigns:
            if name not in schema:
                raise PlanError(f"unknown column {name!r}")

        def assign_fn(region_table: pa.Table, mask: np.ndarray) -> pa.Table:
            # a columnar merge over the WHERE mask: each assignment evaluates
            # over the region on the device, then if_else into the column
            b = _region_batch(region_table, [_qualify_free(e) for _, e in assigns],
                              self.device)
            out = region_table
            n = region_table.num_rows
            cond = pa.array(np.asarray(mask, bool))
            for name, e in assigns:
                c = eval_output(_qualify_free(e), b)
                data, valid = c.to_numpy()
                f = arrow_schema.field(name)
                if np.ndim(data) == 0:
                    data = np.broadcast_to(data, (n,))
                if c.ltype is LType.STRING and c.dictionary is not None:
                    vals = c.dictionary.decode(np.asarray(data, np.int32))
                else:
                    vals = np.asarray(data)
                if valid is None:
                    nulls = None
                else:
                    v = np.asarray(valid, bool)
                    nulls = ~(np.broadcast_to(v, (n,)) if v.ndim == 0 else v)
                new_arr = pa.array(vals, mask=nulls)
                if new_arr.type != f.type:
                    new_arr = new_arr.cast(f.type)
                merged = pc.if_else(cond, new_arr, out.column(name))
                out = out.set_column(out.column_names.index(name), f, merged)
            return out

        mask_fn = self._point_write_mask(store, s.where)
        if mask_fn is not None:
            # a point update evaluates the assignments over its one row and
            # the columns they read, then merges the values into the region
            needed = {store._pk_cols[0]}
            for name, e in assigns:
                needed.add(name)
                stack = [_qualify_free(e)]
                while stack:
                    x = stack.pop()
                    if isinstance(x, ColRef):
                        needed.add(x.name.split(".")[-1])
                    stack.extend(getattr(x, "args", ()) or ())
            full_assign = assign_fn

            def assign_fn(region_table, mask, _full=full_assign):
                cond = pa.array(np.asarray(mask, bool))
                rows = region_table.filter(cond)
                if rows.num_rows != 1:
                    return _full(region_table, np.asarray(mask, bool))
                rows = rows.select([c for c in region_table.column_names if c in needed])
                try:
                    small = _full(rows, np.ones(1, dtype=bool))
                except Exception:   # noqa: BLE001 — a 1-row slice's odd shape
                    return _full(region_table, np.asarray(mask, bool))
                out = region_table
                for name, _ in assigns:
                    merged = pc.if_else(cond, small.column(name)[0], out.column(name))
                    out = out.set_column(out.column_names.index(name),
                                         arrow_schema.field(name), merged)
                return out
        else:
            mask_fn = self._host_mask(store, s.where)
        db_name = s.table.database or self.current_db
        # row images for the subscriptions and views that read this table,
        # kept only when they account for every affected row
        captured = [] if self.db.cdc.wants_rows(f"{db_name}.{s.table.name}") else None
        n = self._update_rows(store, mask_fn, assign_fn, [name for name, _ in assigns],
                              captured)
        if n:
            self._log_binlog("update", db_name, s.table.name,
                             rows=captured if captured is not None and len(captured) == n
                             else None,
                             statement=_stmt_image("update", s), affected=n)
        return Result(affected_rows=n)

    def _delete(self, s: DeleteStmt) -> Result:
        store = self._store(s.table)
        mask_fn = self._point_write_mask(store, s.where) or self._host_mask(store, s.where)
        db_name = s.table.database or self.current_db
        captured = [] if self.db.cdc.wants_rows(f"{db_name}.{s.table.name}") else None
        n = self._delete_rows(store, mask_fn, captured)
        if n:
            self._log_binlog("delete", db_name, s.table.name,
                             rows=captured if captured is not None and len(captured) == n
                             else None,
                             statement=_stmt_image("delete", s), affected=n)
        return Result(affected_rows=n)

    # -- snapshots ---------------------------------------------------------
    def _set_snapshot(self, value) -> None:
        """SET SNAPSHOT = 'now' | <ts> | 0 / '' / OFF: pin (or release) this
        session's read timestamp.  Every later SELECT sees the state
        committed at the pin; the pin holds the GC watermark until released
        or older than ``snapshot_max_age_s``.  A refused pin raises."""
        raw = "" if value is None else str(value).strip()
        if raw.lower() in ("", "0", "off", "none"):
            if self._snapshot is not None:
                self.db.mvcc.snapshots.unpin(self._snapshot[0])
                self._snapshot = None
            return
        if not bool(FLAGS.mvcc):
            raise SqlError("SET SNAPSHOT requires mvcc=1")
        if raw.lower() == "now":
            ts = self.db.mvcc.now_ts()
        else:
            try:
                ts = int(raw)
            except ValueError:
                raise SqlError(f"SET SNAPSHOT expects 'now', a timestamp, or 0/OFF "
                               f"(got {raw!r})") from None
        try:
            with trace.span("snapshot.pin", ts=ts, explicit=True):
                pid = self.db.mvcc.snapshots.pin(ts, query="SET SNAPSHOT", holder=self.user)
        except SnapshotRefused as e:
            raise SqlError(str(e)) from None
        if self._snapshot is not None:
            self.db.mvcc.snapshots.unpin(self._snapshot[0])
        self._snapshot = (pid, ts)

    @contextmanager
    def _snapshot_pinned(self, stmt: SelectStmt):
        """This SELECT's snapshot scope: ``_snap_ts`` holds its read
        timestamp while it runs, and an automatic pin is released after."""
        pin = self._snapshot_scope(stmt)
        if pin is None:
            yield
            return
        pid, ts = pin
        prev = self._snap_ts
        self._snap_ts = ts
        try:
            yield
        finally:
            self._snap_ts = prev
            if pid is not None:
                self.db.mvcc.snapshots.unpin(pid)

    def _snapshot_scope(self, stmt: SelectStmt):
        """(pin id | None, ts) for this SELECT, or None to read unpinned.  An
        explicit SET SNAPSHOT applies (and stays pinned); otherwise an
        analytical statement (GROUP BY or an aggregate) pins a fresh ts for
        its own run, outside transactions and off the mesh, as in the JAX
        session.  A refused automatic pin degrades to an unpinned read."""
        if not bool(FLAGS.mvcc) or self._snap_ts:
            return None         # off, or a nested SELECT inheriting its scope
        if self._snapshot is not None:
            return (None, self._snapshot[1])
        if self._sql_txn is not None or self.mesh is not None:
            return None
        if not (stmt.group_by or any(isinstance(it.expr, AggCall) for it in stmt.items)):
            return None
        if self._try_matview(stmt, refresh=False) is not None or \
                self._try_rollup(stmt, refresh=False) is not None:
            # a view or rollup answers: its maintenance writes one consistent
            # cut of the base, and a pin taken first would hide those writes
            return None
        if self._pushdown_candidate(stmt) is not None:
            # served by the daemons' fragments over their own region images;
            # a snapshot ts does not travel with fragments (as in the JAX
            # session), so a pin would only add round trips
            return None
        ts = self.db.mvcc.now_ts()
        try:
            with trace.span("snapshot.pin", ts=ts, explicit=False):
                pid = self.db.mvcc.snapshots.pin(ts, query="auto", holder=self.user)
        except SnapshotRefused:
            metrics.count_swallowed("snapshot.autopin")
            return None
        return (pid, ts)

    def _snap_dirty(self, stmt) -> bool:
        """Does the pinned snapshot differ from the live image of this
        statement's table?  A quiet table keeps its fast paths (egress, the
        point read): its live image is the snapshot's state."""
        if not self._snap_ts:
            return False
        t = stmt.table
        if t is None or stmt.joins:
            return True
        store = self.db.stores.get(f"{t.database or self.current_db}.{t.name}")
        return store is not None and store.mvcc_needs_versioned(self._snap_ts)

    def _snapshot_batch(self, table_key: str, store) -> Optional[ColumnBatch]:
        """The versioned batch of ``table_key`` at the pinned ``_snap_ts``
        (TableStore.versioned_batch), or None when the live image equals the
        snapshot.  Records a ``snapshot`` trace event with the history
        versions it scanned and the GC watermark."""
        snap = self._snap_ts
        with trace.span("mvcc.visibility", table=table_key, ts=snap):
            got = store.versioned_batch(snap)
            wm = self.db.mvcc.snapshots.watermark(self.db.mvcc.tso.last_ts())
            trace.event("snapshot", ts=snap, table=table_key,
                        versions_scanned=0 if got is None else got[1], gc_watermark=wm)
            return None if got is None else got[0]

    # -- daemon-plane pushed-down execution (reference: store-side plan
    # fragments, region.cpp:2671 / store.interface.proto:418) --------------
    def _pushdown_candidate(self, stmt: SelectStmt):
        """(push, info, table_key) when this SELECT can execute as a pushed
        fragment on the store daemons, else None.  Shared by execution and
        EXPLAIN so the displayed plan is the plan that runs."""
        from ..plan.fragment import build_push_query

        db = self.db
        if db.cluster is None:
            return None
        mode = str(FLAGS.pushdown_reads)
        if mode == "off" or self._sql_txn is not None:
            return None
        if self._snap_dirty(stmt):
            # pinned snapshot with version churn: store daemons evaluate
            # the physically-latest region image; the versioned read needs
            # the frontend's MVCC state, so the pin routes this query to
            # the resident path (quiet tables keep the pushed path)
            return None
        t = stmt.table
        if t is None:
            return None
        dbname = t.database or self.current_db
        if dbname == "information_schema":
            return None
        if db.catalog.get_view(dbname, t.name) is not None:
            return None
        try:
            info = db.catalog.get_table(dbname, t.name)
        except ValueError:      # unknown table: the planner raises
            return None
        if (info.options or {}).get("partition"):
            return None          # partitioned layout: image path prunes
        if any(f.ltype is LType.DECIMAL for f in info.schema.fields):
            # the row tier's DECIMAL encoding is scaled; row-wise eval
            # would disagree with the image path — not pushable
            return None
        key = f"{dbname}.{t.name}"
        store = db.stores.get(key)
        if mode != "always" and store is not None \
                and not store.attach_pending:
            return None          # warm image: the device path is faster
        if mode != "always":
            if is_point_statement(stmt):
                # repeated PK point reads: one image pull then
                # microsecond-class local lookups beats a per-query
                # full-region fragment scan (the OLTP path)
                return None
        push = build_push_query(stmt, info)
        if push is None:
            return None
        return push, info, key

    def _render_pushdown(self, push, info, key) -> str:
        """EXPLAIN display of a pushed fragment: what the store daemons
        execute vs what the frontend finishes."""
        from ..expr.roweval import expr_from_wire

        f = push.frag
        lines = [f"PushDown({key} -> store daemons)"]
        if f.get("filter") is not None:
            lines.append(f"  store filter: {expr_from_wire(f['filter'])!r}")
        if push.mode == "rows":
            outs = ", ".join(f"{n}={expr_from_wire(w)!r}"
                             for n, w in f["outputs"])
            lines.append(f"  store project: {outs}")
            if f.get("limit") is not None:
                lines.append(f"  store limit: {f['limit']} per region")
        else:
            if f["keys"]:
                keys = ", ".join(f"{n}={expr_from_wire(w)!r}"
                                 for n, w in f["keys"])
                lines.append(f"  store group by: {keys}")
            aggs = ", ".join(
                "{}={}({})".format(
                    out, kind,
                    repr(expr_from_wire(w)) if w is not None else "*")
                for kind, w, out in f["aggs"])
            lines.append(f"  store partial aggs: {aggs}")
        finish = []
        if push.having is not None:
            finish.append(f"having {push.having!r}")
        if push.order:
            finish.append("order by " + ", ".join(
                f"{e!r} {'asc' if asc else 'desc'}"
                for e, asc in push.order))
        if push.limit is not None:
            finish.append(f"limit {push.limit}"
                          + (f" offset {push.offset}" if push.offset
                             else ""))
        lines.append("  frontend merge: "
                     + ("; ".join(finish) if finish else "concat/combine"))
        lines.append("  items: " + ", ".join(f"{n}={e!r}"
                                             for n, e in push.items))
        return "\n".join(lines)

    def _try_pushdown(self, stmt: SelectStmt) -> Optional[Result]:
        """Execute an eligible SELECT store-side: only qualifying rows /
        aggregate partials cross the wire, and a cold frontend never pulls
        whole regions for it.  The merge is host Python: no tensor."""
        cand = self._pushdown_candidate(stmt)
        if cand is None:
            return None
        push, info, key = cand
        from ..plan.fragment import merge_push_results
        from ..storage.remote_tier import (PushdownUnsupported,
                                           RemoteRowTier, ReplicationError,
                                           StaleRoutingError)

        store = self.db.stores.get(key)
        if store is None:
            store = self.db.stores[key] = self.db.make_store(info)
        tier = store.replicated
        if not isinstance(tier, RemoteRowTier):
            return None
        try:
            if bool(FLAGS.fragment_pushdown):
                # parallel dispatcher: hash-addressed specs, one thread per
                # region owner, split/migration re-targeting
                # (exec/fragments.py).  Same payloads in the same region
                # order as the serial loop -> bit-identical merge
                from .fragments import dispatch_fragments

                payloads, _fstats = dispatch_fragments(tier, push.frag)
            else:
                payloads = tier.exec_fragment(push.frag)
        except (PushdownUnsupported, ReplicationError,
                StaleRoutingError):
            metrics.fragment_fallbacks.add(1)
            return None          # image path retries / surfaces the error
        with trace.span("fragment.merge", table=key,
                        regions=len(payloads)):
            names, rows = merge_push_results(push, payloads)
        return _host_rows_result(names, rows)

    def _try_point_lookup(self, stmt: SelectStmt) -> Optional[Result]:
        """WHERE fixes the whole primary key by equality and the statement
        is a plain row fetch: answer from the host's primary-key index, no
        device work (the OLTP read)."""
        if not is_point_statement(stmt) or stmt.offset or stmt.limit == 0:
            return None
        t = stmt.table
        if t.subquery is not None:
            return None
        store = self.db.stores.get(f"{t.database or self.current_db}.{t.name}")
        if store is None or store._pk_cols is None or \
                (store.info.options or {}).get("vector_cols"):
            return None
        pk = point_key(stmt, store._pk_cols)
        if pk is None:
            return None
        names, cols_of = [], []
        for it in stmt.items:
            if it.expr is None:
                names.extend(f.name for f in store.info.schema.fields)
                cols_of.extend(f.name for f in store.info.schema.fields)
            elif isinstance(it.expr, ColRef):
                cname = it.expr.name.split(".")[-1]
                if cname not in store.info.schema:
                    return None
                names.append(it.alias or cname)
                cols_of.append(cname)
            else:
                return None
        if len(set(names)) != len(names):
            return None     # duplicate names keep the device path's renames
        try:
            row = store.point_lookup(pk)
        except Exception:   # noqa: BLE001 — any host-index hiccup: full path
            return None
        metrics.point_lookups.add(1)
        sch = schema_to_arrow(store.info.schema)
        arrays = [pa.array([] if row is None else [row.get(c)], sch.field(c).type)
                  for c in cols_of]
        return Result(columns=names, arrow=pa.Table.from_arrays(arrays, names=names))

    # -- SELECT -----------------------------------------------------------
    def _stats_fn(self, table_key: str, col: str):
        st = self.db.stores.get(table_key)
        if st is None:
            return None
        if self._snap_ts and self.mesh is None:
            # under a pin the planner sizes its dense domains from the
            # versioned batch, which this stages on first use
            with trace.span("mvcc.visibility", table=table_key, ts=self._snap_ts):
                return st.snapshot_stats(col, self._snap_ts)
        return st.column_stats(col)

    def _plan_select(self, stmt: SelectStmt) -> PlanNode:
        """Logical + physical planning, plus the distribution pass (the
        Separate / MppAnalyzer analog) when the session has a mesh."""
        with trace.span("plan.build"):
            plan = Planner(self.db.catalog, self.db.stores, self.current_db,
                           self._stats_fn).plan_select(stmt)
            self._annotate_ann(stmt, plan)
            if self.mesh is not None:
                plan = self._distribute(stmt, plan)
            return plan

    def _distribute(self, stmt: SelectStmt, plan: PlanNode) -> PlanNode:
        def rows_fn(table_key: str) -> int:
            st = self.db.stores.get(table_key)
            return st.num_rows if st is not None else 0

        def ndv_fn(table_key: str, col: str):
            # index/stats distinct-count estimate feeding the
            # cardinality-adaptive aggregation choice
            return (self._stats_fn(table_key, col) or {}).get("ndv")

        # the parameterized path stashes the bound values' selectivity
        # before planning (this statement carries Params, not values)
        wsel = self._where_sel_hint
        if wsel is None:
            wsel = self._where_selectivity(stmt)
        return distribute(plan, self.mesh.size, rows_fn, ndv_fn=ndv_fn,
                          stats_fn=self._stats_fn, where_selectivity=wsel)

    def _where_selectivity(self, stmt: SelectStmt):
        """Combined selectivity estimate of the WHERE conjuncts that have a
        stats basis (index/stats histograms + MCVs over this statement's
        literal values); None when no conjunct resolves.  Feeds the
        adaptive-agg local-vs-raw decision."""
        if stmt.where is None:
            return None
        from ..expr.ast import ColRef, Lit
        from ..index.stats import conjunct_selectivity
        from ..plan.eqclasses import conjuncts

        flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
        resolve = self._column_resolver(stmt)
        total, basis = 1.0, False
        for cj in conjuncts(stmt.where):
            if not (isinstance(cj, Call)
                    and cj.op in ("eq", "ne", "lt", "le", "gt", "ge")
                    and len(cj.args) == 2):
                continue
            a, b = cj.args
            op = cj.op
            if isinstance(b, ColRef) and isinstance(a, Lit):
                a, b = b, a
                op = flip.get(op, op)
            if not (isinstance(a, ColRef) and isinstance(b, Lit)):
                continue
            table_key = resolve(a.table, a.name)
            if table_key is None:
                continue
            st = self._stats_fn(table_key, a.name.split(".")[-1])
            sel = conjunct_selectivity(st, op, b.value)
            if sel is not None:
                total *= sel
                basis = True
        return total if basis else None

    def _column_resolver(self, stmt: SelectStmt):
        """(table_label, column) -> the table key of its base table (the JAX
        session's ``_param_resolver``).  Only plain base tables resolve;
        derived tables, views and ambiguous names give None."""
        tables: dict = {}
        for r in [stmt.table] + [j.table for j in stmt.joins]:
            if r is None or r.subquery is not None:
                continue
            db = r.database or self.current_db
            try:
                info = self.db.catalog.get_table(db, r.name)
            except (ValueError, KeyError):      # a view or an unknown name
                continue
            tables[r.label] = (f"{db}.{r.name}", info.schema)

        def resolve(tlabel, col):
            cname = col.split(".")[-1]
            if tlabel is not None:
                ent = tables.get(tlabel)
                return ent[0] if ent is not None and cname in ent[1] else None
            hits = [tk for tk, sch in tables.values() if cname in sch]
            return hits[0] if len(hits) == 1 else None
        return resolve

    def _annotate_ann(self, stmt: SelectStmt, plan: PlanNode) -> None:
        """When the statement is the ANN shape over a table with an ANN
        index, mark its ScanNode: the batch builder reduces the scan to
        the IVF candidate set (index/annindex) and the unchanged plan
        re-ranks exactly."""
        t = stmt.table
        if t is None or t.subquery is not None or self.mesh is not None:
            return
        dbname = t.database or self.current_db
        try:
            info = self.db.catalog.get_table(dbname, t.name)
        except Exception:       # noqa: BLE001 — planner already validated
            return
        m = annindex.match_ann_query(stmt, info, t.label)
        if m is None:
            return
        ix, col, metric, qvec, k = m
        key = f"{dbname}.{t.name}"
        scans = []

        def walk(n):
            if isinstance(n, ScanNode) and n.table_key == key:
                scans.append(n)
            for c in n.children:
                walk(c)
        walk(plan)
        if len(scans) == 1:
            # the WHERE flag rides along: filters re-apply AFTER candidate
            # reduction, so the batch builder must widen the pre-filter pool
            # (or fall back to brute force) to still fill LIMIT k
            scans[0].ann = (ix.name, col, metric, qvec, int(k),
                            stmt.where is not None)

    def _select(self, stmt: SelectStmt, cache_key=None) -> Result:
        """The SELECT inside its snapshot scope (``_snapshot_pinned``): every
        batch staged underneath reads ``_snap_ts``.  ``cache_key`` (the SQL
        text and database of a single-statement SELECT) opts it into the
        plan cache."""
        with self._snapshot_pinned(stmt):
            return self._select_impl(stmt, cache_key)

    def _select_impl(self, stmt: SelectStmt, cache_key=None) -> Result:
        if stmt.into_outfile is not None:
            return self._select_into_outfile(stmt)
        pushed = self._try_pushdown(stmt)
        if pushed is not None:
            return pushed
        # a pinned read of a table written past the pin takes the versioned
        # batch: egress and the point read read the live image
        dirty = self._snap_dirty(stmt)
        eg = None if dirty else egress.extract(stmt, self)
        if eg is None and not dirty:
            point = self._try_point_lookup(stmt)
            if point is not None:
                return point
        if eg is not None:
            # the rewritten statement runs on the device; the string
            # skeletons evaluate on the host over its rows
            inner = self._select(eg[0])
            return _host_rows_result(*egress.finish(eg[1], inner))
        # a materialized view (its deltas folded first) or a rollup (refreshed
        # if the base moved) answers a GROUP BY it covers: the statement
        # re-enters over the hidden table, under a cache key of its own
        rewritten, tag = self._try_matview(stmt), " /*mv*/"
        if rewritten is None:
            rewritten, tag = self._try_rollup(stmt), " /*rollup*/"
        if rewritten is not None:
            stmt = rewritten
            cache_key = None if cache_key is None else (cache_key[0] + tag, cache_key[1])
        # auto-parameterization (plan/paramize.py): hoist WHERE literals
        # into a params vector and key the plan cache on the statement's
        # shape, so WHERE id = 42 and WHERE id = 43 share one entry
        norm = None
        lookup_key = cache_key
        stmt_run = stmt
        if cache_key is not None and bool(FLAGS.param_queries):
            try:
                with trace.span("plan.paramize"):
                    n = paramize.normalize(stmt, self._param_resolver(stmt))
            except Exception:   # noqa: BLE001 — an optimization: never fail the query
                metrics.count_swallowed("session.paramize")
                n = None
            if n is not None and n.slots:
                norm = n
                lookup_key = ("//params", self.current_db, n.key)
                stmt_run = n.stmt
                metrics.params_hoisted.add(len(n.slots))
                if self.mesh is not None and stmt.group_by:
                    # the bound values' WHERE selectivity as a coarse class
                    # joins the key (the adaptive-agg local/raw decision),
                    # and the planner reads it from the hint
                    from ..index.stats import selectivity_class

                    wsel = self._where_selectivity(stmt)
                    self._where_sel_hint = wsel
                    cls = selectivity_class(wsel)
                    if cls > 0:
                        lookup_key = lookup_key + (f"selcls{cls}",)
        try:
            if norm is None:
                return self._select_cached(stmt, cache_key, cache_key, None)
            self._param_counted = False
            try:
                return self._select_cached(stmt_run, cache_key, lookup_key, norm)
            except (paramize.BindError, ExprError, ParamError, PlanError) as e:
                # the valve: what the parameterized path cannot express
                # replans with baked literals (a user error re-raises from
                # the baked run); one cache outcome per SELECT either way.
                # An error of a batched tick is not the valve's: only
                # CombineFallback sends a member inline
                if dispatch.from_tick(e):
                    raise
                self._plan_cache.pop(lookup_key, None)
                self._qlog_outcome = "fallback"
                try:
                    res = self._select_cached(stmt, cache_key, cache_key, None,
                                              count=not self._param_counted)
                finally:
                    self._qlog_outcome = None
                metrics.plan_cache_param_fallbacks.add(1)
                return res
        finally:
            self._where_sel_hint = None

    def _select_cached(self, stmt: SelectStmt, text_key, lookup_key, norm,
                       count: bool = True) -> Result:
        """Plan (or reuse the cached plan), stage, run, egress.  A cached
        entry goes stale when a table it read changed (another store, a new
        version, a catalog version: replan, and keep the entry when the new
        plan's signature is the old one's), when a view changed, or when
        any flag moved; under a pin that a table's writes outran, the
        plan is sized from the versioned batch and is neither reused nor
        kept."""
        qp = progress.current()
        qp.beat(phase="plan")
        cache = self._plan_cache
        entry = cache.get(lookup_key) if lookup_key else None
        replanned = False
        ctx = self._plan_context()
        if entry is not None:
            cache.move_to_end(lookup_key)
            if entry["view_gen"] != self.db.catalog.view_gen or entry["ctx"] != ctx \
                    or self._pinned_dirty(entry["versions"]):
                entry = None
            elif entry["versions"] != self._table_versions(entry["versions"]):
                plan = self._plan_select(stmt)
                sig = plan_signature(plan)
                if sig != entry["plan_sig"]:
                    entry["plan"], entry["plan_sig"] = plan, sig
                    entry.pop("progress_totals", None)
                    replanned = True
                entry["versions"] = self._table_versions(_scan_tables(plan))
        hit = entry is not None and not replanned
        hit_text = entry.get("text") if entry is not None else None
        if entry is None:
            plan = self._plan_select(stmt)
            versions = self._table_versions(_scan_tables(plan))
            entry = {"plan": plan, "plan_sig": plan_signature(plan), "versions": versions,
                     "view_gen": self.db.catalog.view_gen, "ctx": ctx,
                     "text": text_key[0] if text_key else None}
            cap = int(FLAGS.plan_cache_size)
            if lookup_key and cap > 0 and not self._pinned_dirty(versions):
                cache[lookup_key] = entry
                while len(cache) > cap:
                    cache.popitem(last=False)
        # each SELECT counts exactly one of {hit, param_hit, miss}, after
        # the fallible planning, so a param-path fallback re-counts only
        # when this attempt never did
        if hit and norm is not None and text_key is not None and hit_text != text_key[0]:
            outcome = "param_hit"
        elif hit:
            outcome = "hit"
        else:
            outcome = "miss"
        if count:
            {"param_hit": metrics.plan_cache_param_hits, "hit": metrics.plan_cache_hits,
             "miss": metrics.plan_cache_misses}[outcome].add(1)
            self._param_counted = True
        qlog_outcome = self._qlog_outcome or outcome
        trace.event("plan.cache", outcome=qlog_outcome)
        plan = entry["plan"]
        # the progress denominators (a host walk of the plan, kept on the
        # entry): SHOW PROCESSLIST renders "batch m/n" / "round m/n" against
        # them; the plan rides the flight-recorder bundle
        totals = entry.get("progress_totals")
        if totals is None:
            totals = entry["progress_totals"] = executor.progress_totals(plan)
        qp.beat(phase="exec.batches", plan=plan, batches_total=totals["scans"],
                rounds_total=totals["rounds"] if self.mesh is not None else 0)
        # the access paths see this execution's literal values
        self._param_subst = {sl.index: sl for sl in norm.slots} if norm is not None else None
        try:
            with trace.span("exec.batches"):
                batches, shape_key, full_scan = self._collect_batches(plan)
        finally:
            self._param_subst = None
        if norm is not None:
            with trace.span("plan.bind"):
                batches[PARAMS_KEY] = paramize.bind(norm.slots, batches)
        t0 = time.perf_counter()
        qp.beat(phase="exec.run")
        with trace.span("exec.run"):
            out = self._maybe_batched_run(entry, batches, shape_key, norm, lookup_key,
                                          full_scan)
        qp.beat(phase="egress.arrow")
        with trace.span("egress.arrow"):
            table = out.to_arrow()
        dur_ms = (time.perf_counter() - t0) * 1e3
        qp.beat(phase="finish", rows_done=table.num_rows)
        if text_key is not None:
            buckets = ";".join(f"{p[0]}={p[2]}" for p in shape_key)
            self.db.query_log.append((text_key[0], dur_ms, table.num_rows, qlog_outcome,
                                      buckets, qp.phase_ms(), self._snap_ts))
        return Result(columns=list(table.column_names), arrow=table)

    def _plan_context(self) -> tuple:
        """What a plan depends on beyond the statement, the tables and the
        views: every flag, and the distribution pass's broadcast bound."""
        from ..plan import distribute as dist

        return (tuple(sorted(FLAGS.snapshot().items())), dist.BROADCAST_ROWS)

    def _table_versions(self, tables) -> dict:
        """table key -> (the store, weakly; store version; catalog version)
        of each table as they stand now: a dropped and re-created table is
        another store.  A table without a store (information_schema, rendered
        fresh at every run) maps to None."""
        out = {}
        for tk in tables:
            st = self.db.stores.get(tk)
            out[tk] = None if st is None else (weakref.ref(st), st.version, st.info.version)
        return out

    def _pinned_dirty(self, tables) -> bool:
        """Is this read pinned at a snapshot that some table's writes
        outran?  Its plan is sized from the versioned batch."""
        if not self._snap_ts:
            return False
        for tk in tables:
            st = self.db.stores.get(tk)
            if st is not None and self.mesh is None and st.mvcc_needs_versioned(self._snap_ts):
                return True
        return False

    def _run_plan(self, plan: PlanNode, batches: dict) -> ColumnBatch:
        """One inline execution: the streamed fold or the resident run, then
        the egress compact."""
        if streaming.stream_source(batches) is not None:
            # out-of-core path: the scan staged a ChunkSource, so this
            # execution is a chunk fold driven from the host
            out = streaming.run_streamed(plan, batches, self.device)
        else:
            qp = progress.current()
            summary = None
            if self.mesh is not None:
                # the planned rounds are the mesh query's denominator; the
                # summary also rides the flight-recorder bundle
                summary = executor.exchange_summary(plan)
                qp.beat(rounds_total=int(summary["rounds"]), round_no=0, exchange=summary)
            # the seam before the device work: a KILL lands here
            qp.checkpoint()
            run = executor.compile_plan(plan, self.device, self.mesh)
            out = run(batches)
            if self.mesh is not None:
                # every round is behind the run once it returns
                qp.beat(round_no=int(summary["rounds"]))
                self._mpp_telemetry(plan, run.exchanges, summary)
        with trace.span("egress.compact"):
            return _egress_compact(out)

    def _maybe_batched_run(self, entry: dict, batches: dict, shape_key, norm,
                           lookup_key, full_scan) -> ColumnBatch:
        """Through the batched dispatcher when this query is groupable: it
        is parameterized, off the mesh, outside a transaction, and every
        scan reads its table's full device image at a real version (no
        access-path, ANN, streamed or versioned batch), as in the JAX
        session; otherwise (and for every bypass) the inline run."""
        plan = entry["plan"]

        def inline():
            return self._run_plan(plan, batches)

        if norm is None or self.mesh is not None or self._sql_txn is not None \
                or not dispatch.enabled():
            return inline()
        for tk, v, *_rest in shape_key:
            if v < 0 or tk not in full_scan:
                return inline()
        # a presort permutation is per-plan-object state: such a query runs
        # inline, as in the JAX session
        if any(isinstance(k, str) and k.startswith("__presort__") for k in batches):
            return inline()
        # members coalesce on (statement shape + pinned values, scan shapes
        # at exact versions, plan signature): they differ only in params
        group_key = (lookup_key, shape_key, entry["plan_sig"])
        return self.db.dispatcher.run(inline, group_key, plan, batches, self.device)

    def _param_resolver(self, stmt: SelectStmt):
        """(table_label, column) -> (table_key, LType) against the live
        catalog, for paramize's string-literal binder analysis; only plain
        base tables resolve (as ``_column_resolver``)."""
        keys = self._column_resolver(stmt)

        def resolve(tlabel, col):
            tk = keys(tlabel, col)
            if tk is None:
                return None
            db, name = tk.split(".", 1)
            return tk, self.db.catalog.get_table(db, name).schema.field(
                col.split(".")[-1]).ltype
        return resolve

    # -- prepared statements (PREPARE name FROM '...'; EXECUTE name [USING
    # ...]; DEALLOCATE PREPARE name), as the JAX session's --------------------
    def _prepare_stmt(self, s: PrepareStmt) -> Result:
        stmts = parse_sql(s.sql)
        if len(stmts) != 1:
            raise PlanError("PREPARE body must be a single statement")
        if not isinstance(stmts[0], (SelectStmt, InsertStmt, UpdateStmt, DeleteStmt)):
            raise PlanError("PREPARE supports SELECT/INSERT/UPDATE/DELETE")
        self._prepared[s.name] = s.sql
        return Result()

    def _execute_prepared(self, s: ExecuteStmt) -> Result:
        sql = self._prepared.get(s.name)
        if sql is None:
            raise PlanError(f"unknown prepared statement {s.name!r}")
        vals = [self.session_vars.get("@" + v) if kind == "var" else v
                for kind, v in s.params]
        stmt = parse_sql(sql)[0]
        need = paramize.count_placeholders(stmt)
        if need != len(vals):
            raise PlanError(f"prepared statement {s.name!r} needs {need} "
                            f"parameters, got {len(vals)}")
        bound = paramize.substitute_placeholders(stmt, vals)
        metrics.prepared_executes.add(1)
        self._access_check(bound)
        if isinstance(bound, SelectStmt):
            resolved = self._resolve_session_exprs(bound)
            # the text key carries the bound values: distinct values in
            # pinned positions (IN lists, LIMIT) must not collide; hoisted
            # ones share the normalized entry anyway
            key = None if resolved is not bound else \
                (f"{sql} /*execute:{vals!r}*/", self.current_db)
            return self._select(resolved, cache_key=key)
        return self._execute_stmt(bound)

    # -- CDC: FETCH, materialized views and rollups -------------------------
    def _fetch_stmt(self, s: FetchStmt) -> Result:
        """FETCH [n] FROM sub: the next ordered batch of events, then a
        durable ack past it (deliver-then-ack: a crash after the reply never
        redelivers the batch, one before it redelivers all of it)."""
        try:
            sub = self.db.cdc.get(s.name)
        except KeyError as e:
            raise PlanError(str(e.args[0])) from None
        events = sub.fetch(s.limit)     # may raise CursorLagging (typed)
        names = ["commit_ts", "event_type", "table_name", "rows", "statement", "affected"]
        rows = [(e.commit_ts, e.event_type, f"{e.database}.{e.table}",
                 json.dumps(e.rows, default=str), e.statement, e.affected) for e in events]
        if events:
            sub.ack(events[-1].commit_ts)
        return _host_rows_result(names, rows)

    def _try_matview(self, stmt: SelectStmt, refresh: bool = True):
        """The statement rewritten over a materialized view's hidden table
        when the view covers it, after its pending deltas are folded
        (``matview_auto_maintain``) and its state flushed there; None
        otherwise.  ``refresh=False`` (EXPLAIN, the pin decision) only
        rewrites.  Never under a pinned snapshot, in a transaction or inside
        a seed / rescan / refresh query."""
        if not bool(FLAGS.matview_answer) or self._in_mv_refresh or self._in_rollup_refresh:
            return None
        if self._snap_ts or self._sql_txn is not None:
            return None
        if stmt.table is None or stmt.joins or stmt.ctes or stmt.union:
            return None
        db = stmt.table.database or self.current_db
        for mv in self.db.matviews.for_base(f"{db}.{stmt.table.name}"):
            rw = rollup.try_rewrite(stmt, stmt.table.name, mv.name, mv.keys, mv.measures,
                                    mv.database, target_table=mv.hidden)
            if rw is None:
                continue
            if refresh:
                if bool(FLAGS.matview_auto_maintain):
                    mv.maintain(self)
                mv.materialize(self)
                mv.answered += 1
                metrics.view_answered_queries.add(1)
                # a marker span: EXPLAIN ANALYZE's `-- view:` line
                with trace.span("view", view=f"{mv.database}.{mv.name}",
                                applied_ts=mv.applied_ts, staleness_ms=mv.staleness_ms(),
                                deltas_folded=mv.deltas_folded,
                                groups=len(mv.state or {})):
                    pass
            return rw
        return None

    def _try_rollup(self, stmt: SelectStmt, refresh: bool = True):
        """The statement rewritten over a rollup's hidden table when the
        rollup covers it, refreshed first if the base table's version moved;
        None otherwise.  ``refresh=False`` only rewrites.  Never under a
        pinned snapshot (the rollup tracks commit-time freshness, and its
        refresh would write after the pin), in a transaction (its own
        uncommitted writes must show) or inside a refresh."""
        if self._in_rollup_refresh or self._snap_ts or self._sql_txn is not None:
            return None
        if stmt.table is None or stmt.joins or stmt.ctes or stmt.union:
            return None
        db = stmt.table.database or self.current_db
        try:
            info = self.db.catalog.get_table(db, stmt.table.name)
        except ValueError:
            return None
        for ix in info.indexes:
            if ix.kind != "rollup":
                continue
            rw = rollup.try_rewrite(stmt, stmt.table.name, ix.name, list(ix.columns),
                                    list(ix.params.get("measures", ())), db)
            if rw is None:
                continue
            if refresh:
                self._refresh_rollup(db, info, ix)
            return rw
        return None

    def _refresh_rollup(self, db: str, info, ix) -> None:
        """Re-materialize the rollup iff the base version moved: one GROUP BY
        over the base table (``rollup.refresh_sql``), its rows into the
        hidden table."""
        base = self._store(TableRef(db, info.name))
        if ix.params.get("fresh_at") == base.version:
            return
        rt = rollup.rollup_table_name(info.name, ix.name)
        sql = rollup.refresh_sql(f"{db}.{info.name}", rt, list(ix.columns),
                                 list(ix.params.get("measures", ())))
        self._in_rollup_refresh = True
        try:
            table = self._execute(sql).arrow
        finally:
            self._in_rollup_refresh = False
        store = self.db.stores[f"{db}.{rt}"]
        store.truncate()
        if table is not None and table.num_rows:
            sch = store.arrow_schema
            store.insert_arrow(pa.table({f.name: table.column(f.name).cast(f.type)
                                         for f in sch}), self._tctx(store))
        ix.params["fresh_at"] = base.version

    # -- EXPLAIN ANALYZE ---------------------------------------------------
    def _explain_analyze(self, stmt: SelectStmt) -> Result:
        """Run the query once, always traced (a forced root: the span store
        is the timing source), and render every line from the trace's span
        records (``_render_analyze``), as the JAX session does; there is no
        second timing path."""
        with trace.root("explain_analyze", force=True):
            m = trace.mark()
            with self._snapshot_pinned(stmt):
                self._explain_analyze_measure(stmt)
            spans = trace.since(m)
        lines = _render_analyze(spans)
        return Result(columns=["plan"], plan_text="\n".join(lines),
                      arrow=pa.table({"plan": lines}))

    def _explain_analyze_measure(self, stmt: SelectStmt) -> None:
        """Plan, stage, run (counting each operator's live output rows) and
        record the telemetry events the renderer reads.  A materialized view
        answers here as in a SELECT (its ``view`` span is the ``-- view:``
        line)."""
        stmt = self._try_matview(stmt) or stmt
        cand = self._pushdown_candidate(stmt)
        if cand is not None and self._try_pushdown(stmt) is not None:
            # a pushed fragment: the dispatcher's `fragments` event is the
            # measurement; the image path's instrumentation would measure a
            # plan that does not run (a fallback measures it below)
            for line in self._render_pushdown(*cand).splitlines():
                trace.event("op", label=line)
            return
        plan = self._plan_select(stmt)
        batches, shape_key, full_scan = self._collect_batches(plan)
        by_node: dict = {}
        if streaming.stream_source(batches) is not None:
            # a chunk fold has no single run to count: the operators render
            # uncounted, the fold's telemetry lands in its `stream` event
            self._run_plan(plan, batches)
        else:
            run = executor.compile_plan(plan, self.device, self.mesh if batches else None,
                                        count_rows=True)
            # the first run builds whatever kernels it launches; the counts'
            # host read ends each span after the device work
            with trace.span("exec.first"):
                run(batches)
            with trace.span("exec.steady"):
                run(batches)
            by_node = run.counts

        def render(node: PlanNode, indent: int):
            rows = by_node.get(id(node))
            attrs = {} if rows is None else {"rows": rows}
            trace.event("op", label="  " * indent + node._label(), **attrs)
            for c in node.children:
                render(c, indent + 1)

        render(plan, 0)
        scans = [(p[0], batches[p[0]]) for p in shape_key
                 if isinstance(batches.get(p[0]), ColumnBatch)]
        lives = torch.stack([b.live_count().to(torch.int64).cpu() for _, b in scans]).tolist() \
            if scans else []
        for (tk, b), live in zip(scans, lives):
            # only a full scan reads the table's whole image; an access-path
            # batch holds the rows its path gathered
            trace.event("batch", table=tk, kind="capacity" if tk in full_scan else "gathered",
                        capacity=len(b), live=int(live))
        try:
            nz = paramize.normalize(stmt, self._param_resolver(stmt)) \
                if bool(FLAGS.param_queries) else None
        except Exception:   # noqa: BLE001 — the display is best-effort
            metrics.count_swallowed("session.explain_paramize")
            nz = None
        trace.event("params", hoisted=nz.hoisted if nz is not None else 0,
                    pinned=nz.pinned if nz is not None else paramize._count_lits(stmt),
                    param_hits_total=metrics.plan_cache_param_hits.value)
        # whether the dispatcher serves this shape under concurrency, and its
        # engine-wide tick telemetry (EXPLAIN ANALYZE itself runs inline)
        trace.event("dispatch", enabled=dispatch.enabled(),
                    groups_total=metrics.batched_groups.value,
                    avg_occupancy=metrics.group_occupancy.stats()["avg_ms"],
                    queue_p50_ms=metrics.queue_wait_ms.stats()["p50_ms"])
        mj = [0]
        aggs: list[str] = []
        seen: set = set()

        def walk(n):
            if id(n) in seen:
                return
            seen.add(id(n))
            if isinstance(n, MultiJoinNode):
                mj[0] += 1
            if isinstance(n, AggNode) and getattr(n, "agg_dist", ""):
                aggs.append(n.agg_dist)
            for c in n.children:
                walk(c)

        walk(plan)
        xsum = executor.exchange_summary(plan) if self.mesh is not None else \
            {"rounds": 0, "reused": 0, "collectives": 0, "keys": []}
        # exchanges are sized from K3's counts: no overflow retry exists
        trace.event("exchange", rounds=xsum["rounds"], reused=xsum["reused"],
                    collectives=xsum["collectives"], keys="[" + ",".join(xsum["keys"]) + "]",
                    multiway=mj[0], agg=",".join(aggs) or "-", retries_total=0,
                    saved_total=metrics.shuffle_rounds_saved.value)

    # -- information_schema (the tables the port renders) ------------------
    def _info_schema_table(self, name: str) -> pa.Table:
        from ..meta.catalog import Catalog

        def empty():
            return schema_to_arrow(Catalog.INFORMATION_SCHEMA[name]).empty_table()

        if name == "query_log":
            log = list(self.db.query_log)

            def ph(e, k):
                return round(float(e[5].get(k, 0.0)), 3)
            return pa.table({
                "query": [e[0] for e in log],
                "duration_ms": pa.array([e[1] for e in log], pa.float64()),
                "result_rows": pa.array([e[2] for e in log], pa.int64()),
                "cache": [e[3] for e in log],
                "capacity_bucket": [e[4] for e in log],
                "parse_ms": pa.array([ph(e, "parse") for e in log], pa.float64()),
                "plan_ms": pa.array([ph(e, "plan") for e in log], pa.float64()),
                "exec_ms": pa.array([ph(e, "exec") for e in log], pa.float64()),
                "egress_ms": pa.array([ph(e, "egress") for e in log], pa.float64()),
                "snapshot_ts": pa.array([int(e[6]) for e in log], pa.int64()),
            }) if log else empty()
        if name == "dispatcher":
            # the batched dispatcher's live state: queue depth, in-flight
            # runs, tick latency, the group-occupancy histogram, the qos
            # buckets' token levels
            snap = self.db.dispatcher.snapshot()
            rows = [("queue", "depth", float(snap["queue_depth"]), ""),
                    ("queue", "live_groups", float(snap["live_groups"]), ""),
                    ("queue", "inflight", float(snap["inflight"]), ""),
                    ("executables", "cached", float(snap["compiled"]), "")]
            for size in sorted(snap["occupancy"]):
                rows.append(("occupancy", str(size), float(snap["occupancy"][size]),
                             "groups combined at this size"))
            tick = metrics.dispatch_tick_ms.stats()
            wait = metrics.queue_wait_ms.stats()
            rows += [("tick", k, float(tick[k]), "")
                     for k in ("count", "avg_ms", "p50_ms", "p99_ms", "max_ms")]
            rows += [("queue_wait", k, float(wait[k]), "")
                     for k in ("count", "avg_ms", "p50_ms", "p99_ms")]
            for c in ("batched_groups", "dispatch_inline", "dispatch_fallbacks",
                      "qos_rejections"):
                rows.append(("counter", c, float(metrics.REGISTRY.get(c).value), ""))
            if self.db.qos is not None:
                rows += [(kind, key, float(tokens), detail)
                         for kind, key, tokens, detail in self.db.qos.state()]
            return pa.table({"kind": [r[0] for r in rows], "name": [r[1] for r in rows],
                             "value": pa.array([r[2] for r in rows], pa.float64()),
                             "detail": [r[3] for r in rows]})
        render = getattr(self, f"_info_{name}", None)
        if render is not None:
            rows = render()
            if not rows:
                return empty()
            sch = schema_to_arrow(Catalog.INFORMATION_SCHEMA[name])
            return pa.table({f.name: pa.array([r[i] for r in rows], f.type)
                             for i, f in enumerate(sch)}, schema=sch)
        if name in _INFO_XLA:
            raise NotPortedError(f"information_schema.{name} (the JAX package's XLA "
                                 "executable cache has no counterpart)")
        raise PlanError(f"unknown information_schema table {name!r}")

    # the information_schema tables, one method each: rows in the table's
    # catalog column order, as the JAX session renders them
    def _info_regions(self) -> list:
        """One row per region in the fleet meta's routing table (none
        without a fleet); a region whose tier is gone shows its table id."""
        fleet = self.db.fleet
        if fleet is None:
            return []
        names = {t.table_id: t.table_key for t in fleet.row_tiers.values()}
        return [(r.region_id, names.get(r.table_id, str(r.table_id)), r.start_key,
                 r.end_key, ",".join(r.peers), ",".join(r.learners), r.leader, r.state,
                 r.version, r.num_rows, r.apply_lag, r.proposal_queue, r.write_rate)
                for r in sorted(fleet.meta.regions.values(), key=lambda r: r.region_id)]

    def _info_tables(self) -> list:
        cat = self.db.catalog
        rows = []
        for db in cat.databases():
            for t in cat.tables(db):
                st = self.db.stores.get(f"{db}.{t}")
                rows.append((db, t, st.num_rows if st else 0, cat.get_table(db, t).version))
        return rows

    def _info_columns(self) -> list:
        cat = self.db.catalog
        return [(db, t, f.name, f.ltype.value, "YES" if f.nullable else "NO")
                for db in cat.databases() for t in cat.tables(db)
                for f in cat.get_table(db, t).schema.fields]

    def _info_views(self) -> list:
        return [(*k.split(".", 1), v["sql"])
                for k, v in sorted(self.db.catalog._views.items())]

    def _info_partitions(self) -> list:
        cat = self.db.catalog
        rows = []
        for db in cat.databases():
            if db == "information_schema":
                continue
            for t in cat.tables(db):
                spec = (cat.get_table(db, t).options or {}).get("partition")
                if not spec:
                    continue
                st = self.db.stores.get(f"{db}.{t}")
                counts: dict = {}
                # names, bounds and counts under the store's lock: ADD / DROP
                # PARTITION change them under it
                with st._lock if st is not None else contextlib.nullcontext():
                    names, uppers = list(spec.get("names", ())), list(spec.get("uppers", ()))
                    for r in (st.regions if st is not None else ()):
                        counts[r.part] = counts.get(r.part, 0) + r.num_rows
                if spec["kind"] == "hash":
                    rows += [(db, t, f"p{i}", "HASH", spec["column"], "", counts.get(i, 0))
                             for i in range(int(spec["n"]))]
                else:
                    rows += [(db, t, nm, "RANGE", spec["column"],
                              "MAXVALUE" if up is None else str(up), counts.get(i, 0))
                             for i, (nm, up) in enumerate(zip(names, uppers))]
        return rows

    def _info_subscriptions(self) -> list:
        return [(r["name"], r["table_key"], "YES" if r["internal"] else "NO", r["acked_ts"],
                 r["cursor_lag_ms"], r["events_delivered"]) for r in self.db.cdc.describe()]

    def _info_materialized_views(self) -> list:
        return [(r["database"], r["name"], r["base_table"], r["definition"], r["applied_ts"],
                 r["staleness_ms"], r["cursor_lag_ms"], r["deltas_folded"], r["rescans"],
                 r["answered_queries"], r["groups"]) for r in self.db.matviews.describe()]

    def _info_ddl_work(self) -> list:
        return [(w.work_id, w.table_key, w.index_name, w.kind, w.state, w.regions_done,
                 w.regions_total, w.error) for w in list(self.db.ddl.works.values())]

    def _info_snapshots(self) -> list:
        return [(r["snapshot_ts"], r["age_ms"], r["query"], r["holder"])
                for r in self.db.mvcc.snapshots.describe()]

    def _info_trace_spans(self) -> list:
        return [(rec["query_id"], rec["trace_id"], sp["span_id"], sp["parent_id"], sp["name"],
                 sp.get("node") or "frontend", float(sp["ts_us"]), float(sp["dur_ms"]),
                 json.dumps(sp["attrs"], default=str) if sp["attrs"] else "")
                for rec in trace.TRACER.list() for sp in rec["spans"]]

    def _info_processlist(self) -> list:
        rows = sorted((qp.row() for qp in PROGRESS.live(self.db)), key=lambda r: r["query_id"])
        return [(r["id"], r["user"], r["host"], r["db"], r["command"], r["time_s"], r["state"],
                 r["info"], r["query_id"], r["phase"], r["operator"], r["batches_done"],
                 r["batches_total"], r["rows_done"], r["rows_est"], r["round"],
                 r["rounds_total"], r["chunk_no"], r["chunks_total"], r["queue_wait_ms"],
                 r["elapsed_ms"]) for r in rows]

    def _info_flight_recorder(self) -> list:
        return [(r["rec_id"], r["ts"], r.get("query_id", 0), r.get("conn_id", 0),
                 r.get("user", ""), r.get("db", ""), r.get("text", ""), r.get("dur_ms", 0.0),
                 r.get("status", ""), r.get("error", ""),
                 json.dumps(r.get("phase_ms") or {}, default=str), r.get("rows", 0),
                 bool(r.get("bundle"))) for r in self.db.flightrec.rows()]

    def _info_metrics(self) -> list:
        return [(name, k, float(v)) for name, st in metrics.REGISTRY.expose().items()
                for k, v in st.items() if v is not None]

    def _info_cluster_metrics(self) -> list:
        # this frontend's registry (and, with daemons, theirs merged under
        # daemon='fleet')
        return [(r[0], r[1], r[2], r[3], r[4], int(r[5]), round(float(r[6]), 3))
                for r in self.db.telemetry.cluster_rows()]

    def _info_fragments(self) -> list:
        """The last pushed-fragment dispatches (exec/fragments.RECENT)."""
        return [(r["frag_key"], r["table"], r["mode"], r["dispatched"], r["local"],
                 r["retargeted"], r["partial_rows"], r["scanned"], r["bytes_saved"],
                 r["status"]) for r in _fragments.recent_dispatches()]

    def _info_cold_segments(self) -> list:
        """Every replicated table's cold manifests, region by region; a
        leaderless or unreachable region is skipped, not an error."""
        rows = []
        for key, st in list(self.db.stores.items()):
            tier = st.replicated
            if tier is None:
                continue
            db, _, tname = key.partition(".")
            for i, rid in enumerate(tier.region_ids()):
                try:
                    manifest = tier.cold_manifest(i)
                except Exception:   # noqa: BLE001 — one region must not fail the listing
                    metrics.count_swallowed("session.cold_manifest")
                    continue
                rows += [(db, tname, rid, seq, f, w) for seq, f, w in manifest]
        return rows

    def _info_flags(self) -> list:
        return [(n, str(v), str(d), h) for n, v, d, h in FLAGS.describe()]

    def _info_failpoints(self) -> list:
        from ..chaos import failpoint

        return [(r[0], r[2], r[3], r[4], r[1]) for r in failpoint.describe()]

    def _info_column_stats(self) -> list:
        cat = self.db.catalog
        rows = []
        for db in cat.databases():
            if db == "information_schema":
                continue
            for t in cat.tables(db):
                st = self.db.stores.get(f"{db}.{t}")
                if st is None:
                    continue
                for f in cat.get_table(db, t).schema.fields:
                    try:
                        s = st.column_stats(f.name) or {}
                    except Exception:   # noqa: BLE001 — statistics are advisory
                        metrics.count_swallowed("session.column_stats")
                        continue
                    rows.append((db, t, f.name, int(s.get("ndv") or 0),
                                 s.get("ndv_method") or "", int(s.get("nulls") or 0),
                                 int(s.get("n") or 0), len(s.get("mcv") or ()),
                                 max(0, len(s.get("hist") or ()) - 1)))
        return rows

    def _select_into_outfile(self, stmt: SelectStmt) -> Result:
        """SELECT ... INTO OUTFILE: the rows go to a file, the row count is
        the result.  MySQL conventions, as in the JAX session: an existing
        file is never overwritten (claimed with O_EXCL), \\N for NULL,
        separators escaped with a backslash, booleans as 1/0."""
        path, fsep, lsep = stmt.into_outfile
        try:
            final_fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raise PlanError(f"OUTFILE {path!r} already exists") from None
        inner = copy.copy(stmt)
        inner.into_outfile = None
        try:
            res = self._select(inner)

            def cell(v):
                if v is None:
                    return "\\N"
                if isinstance(v, bool):
                    return "1" if v else "0"
                return (str(v).replace("\\", "\\\\").replace(fsep, "\\" + fsep)
                        .replace(lsep, "\\" + lsep))

            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".",
                                       suffix=".outfile")
            try:
                with os.fdopen(fd, "w", encoding="utf-8", newline="") as f:
                    for r in res.rows:
                        f.write(fsep.join(cell(v) for v in r) + lsep)
                os.replace(tmp, path)
            except BaseException:
                os.unlink(tmp)
                raise
        except BaseException:
            os.close(final_fd)
            os.unlink(path)
            raise
        os.close(final_fd)
        return Result(affected_rows=res.arrow.num_rows if res.arrow is not None else 0)

    def _collect_batches(self, plan: PlanNode):
        """Stage every scanned table -> (batches, shape key, full scans).
        The shape key holds (table, store version, batch length[, "snap"])
        per table (version -1 for information_schema, rendered fresh);
        ``full_scan`` names the tables read as their whole device image."""
        batches: dict = {}
        scans: dict = {}
        key_parts: list = []
        full_scan: set = set()

        def count(n: PlanNode):
            if isinstance(n, ScanNode):
                scans[n.table_key] = scans.get(n.table_key, 0) + 1
            for c in n.children:
                count(c)
        count(plan)

        # a progress beat per scan staged (a host seam between table loads,
        # so also a cancellation point); rows come from shapes, never from
        # a device read
        qp = progress.current()
        staged = [0, 0]                      # batches staged, rows seen
        qp.beat(batches_total=len(scans))

        def scan_beat(table_key: str, b) -> None:
            staged[0] += 1
            staged[1] += _batch_rows(b)
            qp.beat(operator=f"scan {table_key}", batches_done=staged[0],
                    rows_done=staged[1])

        def walk(n: PlanNode):
            if isinstance(n, ScanNode) and n.table_key not in batches:
                db, name = n.table_key.split(".", 1)
                if db == "information_schema":
                    b = ColumnBatch.from_arrow(self._info_schema_table(name), self.device)
                    if self.mesh is not None:
                        from ..parallel.mesh import shard_batch

                        b = shard_batch(b, self.mesh)
                    batches[n.table_key] = b
                    key_parts.append((n.table_key, -1, len(b)))
                    scan_beat(n.table_key, b)
                    for c in n.children:
                        walk(c)
                    return
                store = self._store(TableRef(db, name))
                snapped = False
                if self.mesh is not None:
                    # the mesh reads whole sharded tables: no pinned, access-
                    # path, streamed or ANN batches, as in the JAX session
                    b = store.sharded_batch(self.mesh)
                    full_scan.add(n.table_key)
                else:
                    # a pinned read of a table written past the pin stages
                    # its versioned batch (never a chunk set or an index
                    # gather of the live image); a quiet table declines and
                    # keeps every path below.  A table scanned once may take
                    # its ANN candidates or an access path; a streamed plan
                    # has this one scan (streaming.eligible)
                    b = self._snapshot_batch(n.table_key, store) if self._snap_ts else None
                    snapped = b is not None
                    if b is None and scans[n.table_key] == 1:
                        if n.ann is not None:
                            b = self._ann_batch(n, store)
                        if b is None:
                            b = self._access_path_batch(n, store)
                    if b is None:
                        b = self._maybe_stream_source(plan, n, store)
                    if b is None:
                        b = store.device_table_batch()
                        full_scan.add(n.table_key)
                batches[n.table_key] = b
                part = (n.table_key, store.version,
                        len(b) if isinstance(b, ColumnBatch) else -1)
                key_parts.append(part + ("snap",) if snapped else part)
                scan_beat(n.table_key, b)
            for c in n.children:
                walk(c)

        captured: dict = {}                  # table -> version its image was read at

        def walk_presort(n: PlanNode):
            # a node the planner marked (``presort``: kind, table, key
            # columns) takes the host permutation of its table's keys, under
            # the JAX session's guards: off the mesh, its input the table's
            # whole image (not a pinned, streamed, pruned, zone-map or
            # index-gathered batch) and the store still at the version that
            # image was captured at
            spec = getattr(n, "presort", None)
            if spec is not None and self.mesh is None:
                n.presort_input = None
                kind, table_key, cols = spec
                store = self.db.stores.get(table_key)
                if store is not None and table_key in batches and table_key in full_scan \
                        and store.version == captured.get(table_key):
                    pkey = f"__presort__{kind}|{table_key}|{','.join(cols)}"
                    if pkey not in batches:
                        perm = store.presort_order(kind, tuple(cols), captured[table_key])
                        if perm is not None:
                            batches[pkey] = perm
                    if pkey in batches:
                        n.presort_input = pkey
            for c in n.children:
                walk_presort(c)

        try:
            walk(plan)
            captured.update((p[0], p[1]) for p in key_parts)
            walk_presort(plan)
        finally:
            # the recursive closures hold themselves through their cells,
            # and walk holds the batches: break the cycles, so a query's
            # device inputs (its bound params among them) go with the query
            # and not at the collector's next pass
            walk = walk_presort = count = scan_beat = None
        return batches, tuple(sorted(key_parts)), full_scan

    def _pushed_filter(self, n: ScanNode):
        """The scan's pushed filter with this execution's literal values in
        place of its params: what the access paths and zone maps read."""
        if self._param_subst is None:
            return n.pushed_filter
        return paramize.substitute_params(n.pushed_filter, self._param_subst)

    _ACCESS_CACHE_MAX = 16

    def _forget_access(self, table_key: str) -> None:
        """Free this session's access-path batches of a dropped or emptied
        table now, not when the table next stages one."""
        self._access_batches = {k: v for k, v in self._access_batches.items()
                                if k[0] != table_key}

    def _access_path_batch(self, n: ScanNode, store) -> Optional[ColumnBatch]:
        """The scan's input by its access path (index/selector.choose_access):
        a selective KEY equality gathers its rows on the host, a global
        index's equality reads the backing table and gathers the main
        table's rows by primary key, partition pruning and zone maps drop
        whole regions (the kept ones staged as one batch, cached per table
        version); None is the full scan.  The device filter still runs, so
        each is a conservative superset of the rows."""
        if n.pushed_filter is None:
            return None
        try:
            pred = analyze_conjuncts(self._pushed_filter(n))
        except Exception:       # noqa: BLE001 — a predicate it cannot read: full scan
            return None
        try:
            access = choose_access(store.info, store, pred, db=self.db)
        except Exception:       # noqa: BLE001 — rows stay right, the count shows the fault
            metrics.count_swallowed("session.access_path")
            return None
        if access[0] == "secondary":
            _, ix_name, col, value = access
            n.access_desc = f"index({ix_name}:{col})"
            ck = (n.table_key, store.version, "sec", col, value)
            build = lambda: store.secondary_scan(col, value)     # noqa: E731
        elif access[0] == "global":
            _, ix_name, col, value = access
            n.access_desc = f"global_index({ix_name}:{col})"
            bstore = self.db.stores[
                f"{store.info.database}.{gi.backing_table_name(store.info.name, ix_name)}"]
            ck = (n.table_key, store.version, "gidx", ix_name, col, value)
            build = lambda: store.lookup_by_pks(                  # noqa: E731
                bstore.secondary_scan(col, value))
        elif access[0] == "partition":
            _, parts, ptotal = access
            keep, total = store.prune_parts(parts)
            if len(keep) == total:
                n.access_desc = "full"
                return None     # untagged regions: nothing drops
            n.access_desc = f"partition({ptotal - len(parts)}/{ptotal} partitions pruned)"
            metrics.regions_pruned.add(total - len(keep))
            ck = (n.table_key, store.version, "part", tuple(keep))
            build = lambda: store.regions_table(keep)            # noqa: E731
        elif access[0] == "zonemap":
            keep, total = store.prune_regions(access[1])
            if len(keep) == total:
                n.access_desc = "full"
                return None
            n.access_desc = f"zonemap({total - len(keep)}/{total} regions pruned)"
            metrics.regions_pruned.add(total - len(keep))
            ck = (n.table_key, store.version, "zone", tuple(keep))
            build = lambda: store.regions_table(keep)            # noqa: E731
        else:
            n.access_desc = "full"
            return None
        hit = self._access_batches.get(ck)
        # a store dropped and made again under the same name starts its
        # versions anew: a batch is only its own store's
        b = hit[1] if hit is not None and hit[0]() is store else None
        if b is None:
            b = ColumnBatch.from_arrow(build(), self.device)
            # older versions of this table go, and the cache stays bounded
            self._access_batches = {k: v for k, v in self._access_batches.items()
                                    if not (k[0] == n.table_key and k[1] != store.version)}
            while len(self._access_batches) >= self._ACCESS_CACHE_MAX:
                self._access_batches.pop(next(iter(self._access_batches)))
            self._access_batches[ck] = (weakref.ref(store), b)
        metrics.index_scans.add(1)
        return b

    def _annotate_access(self, plan: PlanNode) -> PlanNode:
        """EXPLAIN display of each scan's access path, chosen as the batch
        builders choose it but without building batches."""
        def walk(n):
            if isinstance(n, ScanNode) and n.ann is not None:
                n.access_desc = f"ann({n.ann[0]} nprobe={int(FLAGS.ann_nprobe)})"
                return
            if isinstance(n, ScanNode) and "." in n.table_key:
                store = self.db.stores.get(n.table_key)
                if store is not None and not n.table_key.startswith("information_schema."):
                    try:
                        access = choose_access(store.info, store,
                                               analyze_conjuncts(n.pushed_filter), db=self.db)
                        if access[0] == "secondary":
                            n.access_desc = f"index({access[1]}:{access[2]})"
                        elif access[0] == "global":
                            n.access_desc = f"global_index({access[1]}:{access[2]})"
                        elif access[0] == "partition":
                            n.access_desc = (f"partition({access[2] - len(access[1])}"
                                             f"/{access[2]} partitions pruned)")
                        elif access[0] == "zonemap":
                            keep, total = store.prune_regions(access[1])
                            n.access_desc = ("full" if len(keep) == total else
                                             f"zonemap({total - len(keep)}/{total} "
                                             "regions pruned)")
                        else:
                            n.access_desc = "full"
                    except Exception:   # noqa: BLE001 — the display is best-effort
                        metrics.count_swallowed("session.annotate_access")
            for c in n.children:
                walk(c)
        walk(plan)
        return plan

    def _mpp_telemetry(self, plan: PlanNode, exchanges: list, summary: dict) -> None:
        """Exchange observability of one mesh execution: the
        ``shuffle_rounds`` / ``shuffle_rounds_saved`` counters, and with
        tracing on one ``mpp.repartition`` span per executed repartition
        (its keys or site, the most rows one shard sent one destination),
        one ``mpp.join`` span per shuffle join (its output rows over all
        shards) and one ``mpp.agg`` span per distributed aggregate."""
        metrics.shuffle_rounds.add(summary["rounds"])
        if summary["reused"]:
            metrics.shuffle_rounds_saved.add(summary["reused"])
        if not trace.active():
            return
        joins: dict = {}
        for what, rows in exchanges:
            if isinstance(what, ExchangeNode):
                with trace.span("mpp.repartition", keys=",".join(what.keys or ()),
                                occupancy=int(rows)):
                    pass
            elif isinstance(what, str):
                with trace.span("mpp.repartition", site=what, occupancy=int(rows)):
                    pass
            else:
                joins[id(what)] = (what, joins.get(id(what), (what, 0))[1] + int(rows))
        for node, rows in joins.values():
            if isinstance(node, MultiJoinNode):
                with trace.span("mpp.join", strategy="multiway",
                                builds=len(node.children) - 1, rows=rows):
                    pass
            elif isinstance(node, JoinNode):
                with trace.span("mpp.join", strategy="chained", rows=rows):
                    pass
        seen: set = set()

        def walk(n: PlanNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            if isinstance(n, AggNode) and getattr(n, "agg_dist", ""):
                with trace.span("mpp.agg", strategy=n.agg_dist, agg_kind=n.strategy):
                    pass
            for c in n.children:
                walk(c)

        walk(plan)

    def _ann_batch(self, n: ScanNode, store) -> Optional[ColumnBatch]:
        """IVF candidate batch for an ANN-annotated scan: positions from
        the trained index, sliced out of the store snapshot (same row
        source the full scan would read); None runs the exact scan.  Every
        query reduces anew: the JAX session's batch cache never keeps an
        entry (ROADMAP.md §3), so neither does this one."""
        ix_name, col, metric, qvec, k, has_where = n.ann
        filtered = has_where or n.pushed_filter is not None
        dim = (store.info.options or {}).get("vector_cols", {}).get(col)
        if dim is None:
            return None
        res = annindex.manager(self.db).candidates(
            n.table_key, store, col, int(dim), qvec, metric, k,
            filtered=filtered)
        if res is None:
            n.access_desc = "full"
            return None
        positions, nprobe = res
        b = ColumnBatch.from_arrow(store.snapshot().take(pa.array(positions)),
                                   self.device)
        n.access_desc = (f"ann({ix_name} nprobe={nprobe}, "
                         f"cand={len(positions)})")
        metrics.index_scans.add(1)
        return b

    def _maybe_stream_source(self, plan: PlanNode, n: ScanNode, store):
        """A ChunkSource for this scan when the plan is chunk-foldable
        (exec/streaming.py) and the table clears the size gate; None keeps
        the resident path.  The chunk zone maps see this execution's
        literals.  A failure of the host encode falls back to the resident
        path, counted in ``swallowed.session.stream_stage``; nothing past
        the encode is caught."""
        if not bool(FLAGS.streaming_scan) or self._sql_txn is not None:
            return None
        if store.num_rows < int(FLAGS.streaming_min_rows):
            return None
        if streaming.eligible(plan, n) is None:
            return None
        try:
            cs = chunk_set(store, n.table_key, self.db.cold_fs())
        except Exception:       # noqa: BLE001 — staging is best-effort
            metrics.count_swallowed("session.stream_stage")
            return None
        keep = cs.pruned(analyze_conjuncts(self._pushed_filter(n)).ranges)
        n.access_desc = (f"stream({len(keep)}/{cs.n_chunks} chunks, "
                         f"{cs.capacity} rows each)")
        return ChunkSource(cs, keep)


def _batch_rows(b) -> int:
    """A staged input's row count from its shapes (no device read): a
    batch, a sharded batch, or a streamed scan's chunk set."""
    if isinstance(b, ChunkSource):
        return b.chunks.total_rows
    shards = getattr(b, "shards", None)
    if shards is not None:
        return sum(len(sh) for sh in shards)
    return len(b)


def _scan_tables(plan: PlanNode) -> set:
    """The table keys the plan's scans read."""
    out: set = set()
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, ScanNode):
            out.add(n.table_key)
        stack.extend(n.children)
    return out


def _render_analyze(spans: list[dict]) -> list[str]:
    """EXPLAIN ANALYZE display, rendered only from the span records: the
    JAX session's lines, without its XLA-specific ones (``-- xla``, ``--
    aot``, ``-- device``, ``-- guards``) and that of the plane the port
    lacks (``-- fragments``)."""
    def find(name):
        return [s for s in spans if s["name"] == name]

    lines: list[str] = []
    for s in find("op"):
        a = s["attrs"]
        lines.append(a["label"] + (f"  rows={a['rows']}" if "rows" in a else ""))
    first, steady = find("exec.first"), find("exec.steady")
    if first and steady:
        lines.append(f"-- run: {steady[-1]['dur_ms']:.2f} ms "
                     f"(first incl. compile: {first[-1]['dur_ms']:.2f} ms)")
    for s in find("batch"):
        a = s["attrs"]
        lines.append(f"-- batch: {a['table']} {a['kind']}={a['capacity']} live={a['live']}")
    for s in find("view"):
        a = s["attrs"]
        lines.append(f"-- view: {a['view']} applied_ts={a['applied_ts']} "
                     f"staleness_ms={a['staleness_ms']} deltas_folded={a['deltas_folded']} "
                     f"groups={a['groups']}")
    snaps = find("snapshot")
    if snaps:
        # one line a query: the pinned ts is shared; versions sum
        a0 = snaps[0]["attrs"]
        vs = sum(s["attrs"].get("versions_scanned", 0) for s in snaps)
        lines.append(f"-- snapshot: ts={a0['ts']} versions_scanned={vs} "
                     f"gc_watermark={a0['gc_watermark']}")
    for s in find("params"):
        a = s["attrs"]
        lines.append(f"-- params: hoisted={a['hoisted']} pinned={a['pinned']} "
                     f"param_hits_total={a['param_hits_total']}")
    for s in find("dispatch"):
        a = s["attrs"]
        lines.append(f"-- dispatch: enabled={int(a['enabled'])} "
                     f"groups_total={a['groups_total']} avg_occupancy={a['avg_occupancy']} "
                     f"queue_p50_ms={a['queue_p50_ms']}")
    for s in find("exchange"):
        a = s["attrs"]
        lines.append(f"-- exchange: rounds={a['rounds']} reused={a['reused']} "
                     f"collectives={a['collectives']} keys={a['keys']} "
                     f"multiway={a['multiway']} agg={a['agg']} "
                     f"shuffle_retries_total={a['retries_total']}")
    for s in find("stream"):
        a = s["attrs"]
        lines.append(f"-- stream: chunks={a['chunks']}/{a['chunks_total']} "
                     f"skipped={a['skipped']} bytes_h2d={a['bytes_h2d']} "
                     f"prefetch_wait_ms={a['prefetch_wait_ms']} stage_ms={a['stage_ms']} "
                     f"restarts={a['restarts']}")
    for s in find("fragments"):
        a = s["attrs"]
        lines.append(f"-- fragments: dispatched={a['dispatched']} local={a['local']} "
                     f"retargeted={a['retargeted']} partial_rows={a['partial_rows']} "
                     f"bytes_saved={a['bytes_saved']}")
    lines.append(f"-- trace: spans={len(spans)} (every line above renders from these "
                 "span records)")
    return lines


def _region_batch(region_table: pa.Table, exprs: list, device) -> ColumnBatch:
    """A region's rows on ``device``, with only the columns ``exprs`` read
    (one at least, so the batch keeps the region's length)."""
    names = set()
    stack = list(exprs)
    while stack:
        x = stack.pop()
        if isinstance(x, ColRef):
            names.add(x.name.split(".")[-1])
        stack.extend(getattr(x, "args", ()) or ())
    cols = [c for c in region_table.column_names if c in names] or region_table.column_names[:1]
    return ColumnBatch.from_arrow(region_table.select(cols), device)


def _stmt_image(kind: str, s) -> str:
    """The statement image of an UPDATE / DELETE / upsert event (the JAX
    session's text)."""
    where = f" WHERE {s.where!r}" if getattr(s, "where", None) is not None else ""
    if kind == "update":
        sets = ", ".join(f"{n}={e!r}" for n, e in s.assignments)
        return f"UPDATE {s.table.name} SET {sets}{where}"
    if kind == "replace":
        return f"REPLACE INTO {s.table.name} ({len(s.rows)} rows)"
    if kind == "upsert":
        sets = ", ".join(f"{c}={v!r}" for c, v in s.on_dup)
        return (f"INSERT INTO {s.table.name} ({len(s.rows)} rows) "
                f"ON DUPLICATE KEY UPDATE {sets}")
    return f"DELETE FROM {s.table.name}{where}"


def _qualify_free(e):
    """Strip table qualifiers: region batches carry plain column names."""
    if isinstance(e, ColRef):
        return ColRef(e.name)
    if isinstance(e, AggCall):
        raise PlanError("aggregates not allowed in UPDATE/DELETE")
    if isinstance(e, Call):
        return Call(e.op, tuple(_qualify_free(a) for a in e.args))
    return e


def _host_rows_result(names: list, rows: list) -> Result:
    """Host-computed row tuples -> Result (the egress finish).  Duplicate
    output names stay as the client asked for them."""
    arrays = []
    for i in range(len(names)):
        vals = [r[i] for r in rows]
        try:
            arrays.append(pa.array(vals))
        except (pa.ArrowInvalid, pa.ArrowTypeError):
            arrays.append(pa.array([None if v is None else str(v) for v in vals]))
    return Result(columns=list(names), arrow=pa.Table.from_arrays(arrays, names=list(names)))


def _temporal_value(v: str, lt: LType):
    from ..expr.compile import parse_temporal

    n = parse_temporal(v, lt)
    epoch = datetime.datetime(1970, 1, 1)
    if lt is LType.DATE:
        return epoch.date() + datetime.timedelta(days=n)
    return epoch + datetime.timedelta(microseconds=n)


def _egress_compact(batch):
    """Densify the finished result on the device: only live rows go to the
    host."""
    if batch.num_rows is not None:
        idx = torch.arange(int(batch.num_rows), device=batch.device)
    elif batch.sel is not None:
        idx = torch.nonzero(batch.sel).reshape(-1)
    else:
        return batch
    return batch.gather(idx)
