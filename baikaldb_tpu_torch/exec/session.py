"""SQL session: parse -> plan -> stage tables on the device -> execute -> rows.

The port of the query path of ``baikaldb_tpu/exec/session.py``: CREATE
TABLE, INSERT ... VALUES, ``load_arrow`` bulk ingest, SET GLOBAL flags,
EXPLAIN, and SELECT with joins, IN / EXISTS / scalar subqueries, derived
tables and WITH, UNION, WHERE / GROUP BY / HAVING / ORDER BY / LIMIT /
OFFSET (all 22 TPC-H queries).  The copied planner plans it; the executor
runs the plan eagerly, and a scalar subquery with more than one row raises
"Subquery returns more than 1 row" as in the JAX session.  Results are
densified on the device and returned as Arrow.

A session runs on one device, named when it is made.  ``Session()`` with no
device runs on CUDA and raises when CUDA is unavailable; only an explicit
``Session(device="cpu")`` runs on the CPU.

Not ported yet: transactions, UPDATE/DELETE, the plan cache and
auto-parameterization, the host presort permutations, the egress fast path,
pushdown, matviews and rollups, point lookups and snapshot pinning.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Optional

import pyarrow as pa
import torch

from ..errors import NotPortedError
from ..exec import executor
from ..meta.catalog import Catalog, IndexInfo, parse_type
from ..obs import trace
from ..plan.nodes import PlanNode, ScanNode
from ..plan.planner import Planner
from ..sql.lexer import SqlError
from ..sql.parser import parse_sql
from ..sql.stmt import (CreateTableStmt, ExplainStmt, InsertStmt, SelectStmt,
                        SetStmt, TableRef)
from ..storage.column_store import TableStore
from ..types import Field, LType, Schema
from ..utils import metrics
from ..utils.flags import FLAGS, FlagError


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
    """Catalog + table stores, all on one device."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.stores: dict[str, TableStore] = {}


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
            return self._select(s)
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
            out = executor.compile_plan(plan, self.device)(batches)
        with trace.span("egress.arrow"):
            table = _egress_compact(out).to_arrow()
        return Result(columns=list(table.column_names), arrow=table)

    def _collect_batches(self, plan: PlanNode) -> dict:
        batches: dict = {}

        def walk(n: PlanNode):
            if isinstance(n, ScanNode) and n.table_key not in batches:
                db, name = n.table_key.split(".", 1)
                batches[n.table_key] = self._store(TableRef(db, name)).device_table_batch()
            for c in n.children:
                walk(c)

        walk(plan)
        return batches


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
