"""SQL session: parse -> plan -> stage tables on the device -> execute -> rows.

The port of the query path of ``baikaldb_tpu/exec/session.py``: CREATE
TABLE, INSERT ... VALUES, ``load_arrow`` bulk ingest, SET GLOBAL flags,
EXPLAIN, and SELECT with joins, IN / EXISTS / scalar subqueries, derived
tables and WITH, UNION, WHERE / GROUP BY / HAVING / ORDER BY / LIMIT /
OFFSET (all 22 TPC-H queries), window functions.  The copied planner plans
it; the executor runs the plan eagerly, and a scalar subquery with more than
one row raises "Subquery returns more than 1 row" as in the JAX session.
Results are densified on the device and returned as Arrow.  CONNECTION_ID()
and VERSION() in a SELECT become literals before planning, as in the JAX
session (``_resolve_session_exprs``).

A session runs on one device, named when it is made.  ``Session()`` with no
device runs on CUDA and raises when CUDA is unavailable; only an explicit
``Session(device="cpu")`` runs on the CPU.

A single-scan scan -> filter -> aggregate over a table of at least
``streaming_min_rows`` rows streams, as in the JAX session: the scan stages
a ChunkSource (the chunks its zone maps keep) instead of the device image,
and exec/streaming.py folds it chunk by chunk.  The chunks are Parquet
segments in the cold tier (``Database(cold_dir=...)`` or the
``cold_fs_dir`` flag) or in host memory.

Not ported yet: transactions, UPDATE/DELETE, the plan cache and
auto-parameterization, the host presort permutations, the egress fast path,
pushdown, matviews and rollups, point lookups and snapshot pinning.
"""

from __future__ import annotations

import datetime
import itertools
from dataclasses import dataclass, field, replace
from typing import Optional

import pyarrow as pa
import torch

from ..errors import NotPortedError
from ..exec import executor, streaming
from ..expr.ast import AggCall, Call, Lit, Subquery, WindowCall
from ..index.selector import analyze_conjuncts
from ..meta.catalog import Catalog, IndexInfo, parse_type
from ..obs import trace
from ..plan.nodes import PlanNode, ScanNode
from ..plan.planner import Planner
from ..sql.lexer import SqlError
from ..sql.parser import parse_sql
from ..sql.stmt import (CreateTableStmt, ExplainStmt, InsertStmt, OrderItem,
                        SelectItem, SelectStmt, SetStmt, TableRef)
from ..storage.coldfs import ExternalFS
from ..storage.column_store import TableStore
from ..storage.streamchunks import ChunkSource, chunk_set
from ..types import Field, LType, Schema
from ..utils import metrics
from ..utils.flags import FLAGS, FlagError

# the JAX session's server version string (its _SERVER_VARS["version"])
SERVER_VERSION = "8.0.0-baikaldb-tpu"

# connection ids, one counter per process as in the JAX session
_CONN_IDS = itertools.count(1)


def resolve_device(device=None) -> torch.device:
    """The device a session runs on: ``None`` means CUDA, and raises when no
    CUDA device is available (the port never falls back to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("baikaldb_tpu_torch runs on a CUDA device and none "
                               "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


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


class Database:
    """Catalog + table stores, all on one device.  ``cold_dir`` (or the
    ``cold_fs_dir`` flag) roots the cold tier the streamed scans keep their
    chunk segments in."""

    def __init__(self, device=None, cold_dir: Optional[str] = None):
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.stores: dict[str, TableStore] = {}
        self.cold_dir = cold_dir
        self._cold_fs = None

    def cold_fs(self):
        """The external cold-storage FS, or None when unconfigured."""
        if self._cold_fs is None:
            root = self.cold_dir or str(FLAGS.cold_fs_dir)
            if root:
                self._cold_fs = ExternalFS(root)
        return self._cold_fs


class Session:
    def __init__(self, db: Optional[Database] = None, database: str = "default",
                 device=None):
        if db is None:
            db = Database(device)
        elif device is not None and resolve_device(device) != db.device:
            raise ValueError(f"session device {device} differs from the "
                             f"database's {db.device}")
        self.db = db
        self.device = db.device
        self.current_db = database
        self._conn_id = next(_CONN_IDS)

    def connection_id(self) -> int:
        """This session's id, answered by CONNECTION_ID()."""
        return self._conn_id

    # -- entry points ---------------------------------------------------
    def execute(self, sql: str) -> Result:
        metrics.queries_total.add(1)
        try:
            with trace.root("query", sql):
                with trace.span("parse"):
                    stmts = parse_sql(sql)
                res = Result()
                for s in stmts:
                    res = self._execute_stmt(s)
        except Exception:
            metrics.queries_failed.add(1)
            raise
        if res.arrow is not None:
            metrics.rows_returned.add(res.arrow.num_rows)
        return res

    def query(self, sql: str) -> list[dict]:
        return self.execute(sql).to_pylist()

    def load_arrow(self, table_name: str, table: pa.Table,
                   database: str | None = None) -> int:
        """Bulk ingest: append an Arrow table straight into the store."""
        self._store(TableRef(database, table_name)).insert_arrow(table)
        return table.num_rows

    # -- statements -----------------------------------------------------
    def _execute_stmt(self, s) -> Result:
        if isinstance(s, SelectStmt):
            return self._select(_resolve_session_exprs(s, self.connection_id()))
        if isinstance(s, CreateTableStmt):
            return self._create_table(s)
        if isinstance(s, InsertStmt):
            return self._insert(s)
        if isinstance(s, SetStmt):
            return self._set_stmt(s)
        if isinstance(s, ExplainStmt) and s.fmt != "analyze":
            text = self._plan_select(s.stmt).tree_repr()
            return Result(columns=["plan"], plan_text=text,
                          arrow=pa.table({"plan": text.split("\n")}))
        raise NotPortedError(f"statement {type(s).__name__}")

    def _set_stmt(self, s: SetStmt) -> Result:
        """SET GLOBAL name = value updates the flag registry; session names
        are accepted and ignored."""
        for name, value in [(s.name, s.value)] + list(s.more):
            if s.scope == "global":
                try:
                    FLAGS.set_flag(name, value)
                except FlagError as e:
                    raise SqlError(str(e)) from None
        return Result()

    def _store(self, tref) -> TableStore:
        db = tref.database or self.current_db
        key = f"{db}.{tref.name}"
        if key not in self.db.stores:
            info = self.db.catalog.get_table(db, tref.name)
            self.db.stores[key] = TableStore(info, self.device)
        return self.db.stores[key]

    def _create_table(self, s: CreateTableStmt) -> Result:
        db = s.table.database or self.current_db
        if s.options or any(c.auto_increment for c in s.columns) \
                or any(kind != "primary" for kind, _, _ in s.indexes):
            raise NotPortedError("table options, AUTO_INCREMENT and secondary indexes")
        fields = []
        for c in s.columns:
            if c.type_name.strip().lower().startswith("vector"):
                raise NotPortedError("VECTOR columns")
            fields.append(Field(c.name, parse_type(c.type_name),
                                c.nullable and c.name not in s.primary_key))
        indexes = [IndexInfo("PRIMARY", "primary", list(s.primary_key))] \
            if s.primary_key else []
        info = self.db.catalog.create_table(db, s.table.name, Schema(tuple(fields)),
                                            indexes, if_not_exists=s.if_not_exists)
        key = f"{db}.{s.table.name}"
        if key not in self.db.stores:
            self.db.stores[key] = TableStore(info, self.device)
        return Result()

    def _insert(self, s: InsertStmt) -> Result:
        if s.select is not None or s.replace or s.on_dup:
            raise NotPortedError("INSERT ... SELECT, REPLACE and ON DUPLICATE KEY")
        store = self._store(s.table)
        schema = store.info.schema
        cols = s.columns or schema.names()
        if any(len(r) != len(cols) for r in s.rows):
            raise SqlError("VALUES row length does not match column list")
        rows = [dict(zip(cols, r)) for r in s.rows]
        for r in rows:
            for f in schema.fields:
                v = r.get(f.name)
                if f.ltype.is_temporal and isinstance(v, str):
                    r[f.name] = _temporal_value(v, f.ltype)
        store.insert_rows(rows)
        return Result(affected_rows=len(rows))

    # -- SELECT -----------------------------------------------------------
    def _stats_fn(self, table_key: str, col: str):
        st = self.db.stores.get(table_key)
        return None if st is None else st.column_stats(col)

    def _plan_select(self, stmt: SelectStmt) -> PlanNode:
        with trace.span("plan.build"):
            return Planner(self.db.catalog, self.db.stores, self.current_db,
                           self._stats_fn).plan_select(stmt)

    def _select(self, stmt: SelectStmt) -> Result:
        if stmt.into_outfile is not None:
            raise NotPortedError("SELECT ... INTO OUTFILE")
        plan = self._plan_select(stmt)
        with trace.span("exec.batches"):
            batches = self._collect_batches(plan)
        with trace.span("exec.run"):
            if streaming.stream_source(batches) is not None:
                # out-of-core path: the scan staged a ChunkSource, so this
                # execution is a chunk fold driven from the host
                out = streaming.run_streamed(plan, batches, self.device)
            else:
                out = executor.compile_plan(plan, self.device)(batches)
        with trace.span("egress.arrow"):
            table = _egress_compact(out).to_arrow()
        return Result(columns=list(table.column_names), arrow=table)

    def _collect_batches(self, plan: PlanNode) -> dict:
        batches: dict = {}

        def walk(n: PlanNode):
            if isinstance(n, ScanNode) and n.table_key not in batches:
                db, name = n.table_key.split(".", 1)
                store = self._store(TableRef(db, name))
                # a streamed plan has this one scan (streaming.eligible)
                b = self._maybe_stream_source(plan, n, store)
                batches[n.table_key] = b if b is not None else store.device_table_batch()
            for c in n.children:
                walk(c)

        walk(plan)
        return batches

    def _maybe_stream_source(self, plan: PlanNode, n: ScanNode, store):
        """A ChunkSource for this scan when the plan is chunk-foldable
        (exec/streaming.py) and the table clears the size gate; None keeps
        the resident path.  The chunk zone maps see this execution's
        literals.  A failure of the host encode falls back to the resident
        path, counted in ``swallowed.session.stream_stage``; nothing past
        the encode is caught."""
        if not bool(FLAGS.streaming_scan):
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
        keep = cs.pruned(analyze_conjuncts(n.pushed_filter).ranges)
        n.access_desc = (f"stream({len(keep)}/{cs.n_chunks} chunks, "
                         f"{cs.capacity} rows each)")
        return ChunkSource(cs, keep)


def _resolve_session_exprs(stmt: SelectStmt, conn_id: int) -> SelectStmt:
    """CONNECTION_ID() and VERSION() -> literals before planning, and their
    MySQL column captions where the item has no alias (the part of the JAX
    session's ``_resolve_session_exprs`` the port serves).  A statement that
    names neither comes back as it was."""
    env = {"connection_id": conn_id, "version": SERVER_VERSION}
    changed = [False]

    def walk_e(e):
        if isinstance(e, Call):
            if e.op in env and not e.args:
                changed[0] = True
                return Lit(env[e.op])
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

    def alias(e):
        if isinstance(e, Call) and e.op in env and not e.args:
            return f"{e.op.upper()}()"
        return None

    def walk_t(t):
        if t is not None and t.subquery is not None:
            return replace(t, subquery=walk_s(t.subquery))
        return t

    def walk_s(st: SelectStmt) -> SelectStmt:
        return replace(
            st,
            items=[SelectItem(opt(it.expr), it.alias or alias(it.expr), it.star_table)
                   for it in st.items],
            table=walk_t(st.table),
            where=opt(st.where),
            group_by=[walk_e(g) for g in st.group_by],
            having=opt(st.having),
            order_by=[OrderItem(walk_e(o.expr), o.asc) for o in st.order_by],
            joins=[replace(j, table=walk_t(j.table), on=opt(j.on)) for j in st.joins],
            ctes=[(n, walk_s(c)) for n, c in st.ctes],
            union=None if st.union is None else (st.union[0], walk_s(st.union[1])))

    out = walk_s(stmt)
    return out if changed[0] else stmt


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
