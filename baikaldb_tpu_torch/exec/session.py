"""SQL session: parse -> plan -> stage tables on the device -> execute -> rows.

The port of the query path of ``baikaldb_tpu/exec/session.py``: CREATE
TABLE, INSERT ... VALUES, ``load_arrow`` bulk ingest, SET, EXPLAIN, and
SELECT with joins, IN / EXISTS / scalar subqueries, derived tables and WITH,
UNION, WHERE / GROUP BY / HAVING / ORDER BY / LIMIT / OFFSET (all 22 TPC-H
queries), window functions.  The copied planner plans it; the executor runs
the plan eagerly, and a scalar subquery with more than one row raises
"Subquery returns more than 1 row" as in the JAX session.  Results are
densified on the device and returned as Arrow.  CONNECTION_ID() and
VERSION() in a SELECT become literals before planning, as in the JAX
session (``_resolve_session_exprs``).  FORMAT, DATE_FORMAT, HEX, BIN and
OCT of numbers are evaluated at egress (exec/egress.py), and SELECT ...
INTO OUTFILE writes the rows to a file.

The statements that need only the catalog are the JAX session's: CREATE /
DROP DATABASE, USE, DROP TABLE (its store and device image go with it),
TRUNCATE, CREATE / DROP VIEW, DESCRIBE, and SHOW DATABASES, [FULL] TABLES,
CREATE TABLE, [FULL] COLUMNS, INDEX and VARIABLES.  The SHOW forms that read
a plane the port lacks (regions, processlist, status, grants, profiles, ...)
raise ``NotPortedError``.

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

Not ported yet: transactions, UPDATE/DELETE, the other ALTER TABLE forms
and index kinds, the plan cache and
auto-parameterization, EXPLAIN ANALYZE, the host presort permutations,
pushdown, matviews and rollups, point lookups and snapshot pinning.
"""

from __future__ import annotations

import copy
import datetime
import functools
import itertools
import os
import re
import tempfile
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import pyarrow as pa
import torch

from ..column.batch import ColumnBatch
from ..errors import NotPortedError
from ..exec import egress, executor, streaming
from ..expr.ast import AggCall, Call, Lit, Subquery, WindowCall
from ..index import annindex
from ..index.selector import analyze_conjuncts
from ..meta.catalog import Catalog, IndexInfo, parse_type
from ..obs import trace
from ..parallel.mesh import Mesh
from ..plan.distribute import distribute
from ..plan.nodes import (AggNode, ExchangeNode, JoinNode, MultiJoinNode,
                          PlanNode, ScanNode)
from ..plan.planner import PlanError, Planner, parse_vector
from ..sql.lexer import SqlError
from ..sql.parser import parse_sql
from ..sql.stmt import (AlterTableStmt, CreateDatabaseStmt, CreateTableStmt,
                        CreateViewStmt, DescribeStmt, DropDatabaseStmt, DropTableStmt,
                        DropViewStmt, ExplainStmt, InsertStmt, OrderItem,
                        SelectItem, SelectStmt, SetStmt, ShowStmt, TableRef,
                        TruncateStmt, UseStmt)
from ..storage.coldfs import ExternalFS
from ..storage.column_store import TableStore
from ..storage.streamchunks import ChunkSource, chunk_set
from ..types import Field, LType, Schema
from ..utils import metrics
from ..utils.device import resolve_device
from ..utils.flags import FLAGS, FlagError

# the JAX session's server version string (its _SERVER_VARS["version"])
SERVER_VERSION = "8.0.0-baikaldb-tpu"

# connection ids, one counter per process as in the JAX session
_CONN_IDS = itertools.count(1)

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
                 device=None, mesh: Optional[Mesh] = None):
        """``mesh``: when set, every SELECT is distributed over its shards
        (the MPP mode); the database, unless given, lives on the mesh's
        first device."""
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
        """Bulk ingest: append an Arrow table straight into the store; a
        vector column arrives as a list or fixed-size list column."""
        store = self._store(TableRef(database, table_name))
        vcols = (store.info.options or {}).get("vector_cols") or {}
        if vcols:
            table = _expand_vector_arrow(table, vcols)
        store.insert_arrow(table)
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
            text = _annotate_access(self._plan_select(s.stmt)).tree_repr()
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
            return Result()
        if isinstance(s, DropTableStmt):
            db = s.table.database or self.current_db
            self.db.catalog.drop_table(db, s.table.name, s.if_exists)
            st = self.db.stores.pop(f"{db}.{s.table.name}", None)
            if st is not None:
                st.release()
            annindex.manager(self.db).forget(f"{db}.{s.table.name}")
            return Result()
        if isinstance(s, TruncateStmt):
            self._store(s.table).truncate()
            return Result()
        if isinstance(s, CreateDatabaseStmt):
            self.db.catalog.create_database(s.name, if_not_exists=s.if_not_exists)
            return Result()
        if isinstance(s, DropDatabaseStmt):
            self.db.catalog.drop_database(s.name, s.if_exists)
            for k in [k for k in self.db.stores if k.startswith(s.name + ".")]:
                self.db.stores.pop(k).release()
                annindex.manager(self.db).forget(k)
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
        raise NotPortedError(f"statement {type(s).__name__}")

    def _set_stmt(self, s: SetStmt) -> Result:
        """SET GLOBAL name = value updates the flag registry; other names
        are kept per session (SHOW VARIABLES reports them), as MySQL
        clients set them on connect and expect silent success."""
        for name, value in [(s.name, s.value)] + list(s.more):
            if s.scope == "global":
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
        """The SHOW forms that read only the catalog and the flags."""
        cat = self.db.catalog

        def like(name: str) -> bool:
            return s.pattern is None or _show_like_rx(s.pattern).match(name) is not None

        if s.what == "databases":
            return Result(columns=["Database"],
                          arrow=pa.table({"Database": cat.databases()}))
        if s.what in ("tables", "full_tables"):
            db = s.database or self.current_db
            views = list(cat.views(db))
            names = [n for n in sorted(cat.tables(db) + views) if like(n)]
            cols = {f"Tables_in_{db}": names}
            if s.what == "full_tables":
                cols["Table_type"] = ["VIEW" if n in views else "BASE TABLE" for n in names]
            return Result(columns=list(cols), arrow=pa.table(cols))
        if s.what == "create_table":
            return self._show_create(s)
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
        raise NotPortedError(f"SHOW {s.what.upper()} (its plane is not ported)")

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
        for f in info.schema.fields:
            lines.append(f"  `{f.name}` {f.ltype.value.upper()}"
                         + ("" if f.nullable else " NOT NULL"))
        if pk:
            lines.append("  PRIMARY KEY (" + ", ".join(f"`{c}`" for c in pk.columns) + ")")
        for ix in info.indexes:
            if ix.kind != "primary":
                # the JAX session's keyword for an ANN index
                lines.append(f"  KEY `{ix.name}` (" + ", ".join(f"`{c}`" for c in ix.columns)
                             + ")")
        ddl = f"CREATE TABLE `{s.table.name}` (\n" + ",\n".join(lines) + "\n)"
        return Result(columns=["Table", "Create Table"],
                      arrow=pa.table({"Table": [s.table.name], "Create Table": [ddl]}))

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
                or any(kind != "ann" for kind, _, _ in s.indexes):
            raise NotPortedError("table options, AUTO_INCREMENT and secondary indexes")
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
        indexes = [IndexInfo("PRIMARY", "primary", list(s.primary_key))] \
            if s.primary_key else []
        for kind, name, cols in s.indexes:
            if len(cols) != 1 or cols[0] not in vector_cols:
                raise PlanError("ANN INDEX needs exactly one VECTOR column")
            indexes.append(IndexInfo(name or f"ann_{cols[0]}", kind, cols))
        info = self.db.catalog.create_table(
            db, s.table.name, Schema(tuple(fields)), indexes,
            options={"vector_cols": vector_cols} if vector_cols else None,
            if_not_exists=s.if_not_exists)
        key = f"{db}.{s.table.name}"
        if key not in self.db.stores:
            self.db.stores[key] = TableStore(info, self.device)
        return Result()

    def _insert(self, s: InsertStmt) -> Result:
        if s.select is not None or s.replace or s.on_dup:
            raise NotPortedError("INSERT ... SELECT, REPLACE and ON DUPLICATE KEY")
        store = self._store(s.table)
        schema = store.info.schema
        vcols = (store.info.options or {}).get("vector_cols") or {}
        # positional VALUES address user-visible columns (vector columns by
        # their own names, components hidden)
        cols = s.columns or self._user_columns(store)
        if any(len(r) != len(cols) for r in s.rows):
            raise SqlError("VALUES row length does not match column list")
        rows = [dict(zip(cols, r)) for r in s.rows]
        if vcols:
            rows = [_expand_vector_row(r, vcols) for r in rows]
        for r in rows:
            for f in schema.fields:
                v = r.get(f.name)
                if f.ltype.is_temporal and isinstance(v, str):
                    r[f.name] = _temporal_value(v, f.ltype)
        store.insert_rows(rows)
        return Result(affected_rows=len(rows))

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
        """ALTER TABLE ... ADD ANN INDEX and DROP INDEX of an ANN index, as
        the JAX session's ``_alter_index`` does them: the index is trained
        lazily on its first ANN query (index/annindex), so there is no
        backfill.  Every other form raises ``NotPortedError``."""
        db = s.table.database or self.current_db
        info = self.db.catalog.get_table(db, s.table.name)
        if s.action == "drop_index":
            kept = [ix for ix in info.indexes
                    if not (ix.name == s.index_name and ix.kind == "ann")]
            if len(kept) == len(info.indexes):
                raise PlanError(f"unknown index {s.index_name!r}")
            info.indexes = kept
            info.version += 1
            return Result()
        if s.action != "add_index" or s.index_kind != "ann":
            raise NotPortedError(f"ALTER TABLE {s.action} (only ADD ANN INDEX and DROP "
                                 "INDEX of an ANN index are ported)")
        vcols = (info.options or {}).get("vector_cols") or {}
        if len(s.index_cols) != 1 or s.index_cols[0] not in vcols:
            raise PlanError("ANN INDEX needs exactly one VECTOR column")
        name = s.index_name or f"ann_{s.index_cols[0]}"
        if any(ix.name == name for ix in info.indexes):
            raise PlanError(f"index {name!r} exists")
        info.indexes.append(IndexInfo(name, "ann", list(s.index_cols)))
        info.version += 1
        return Result()

    # -- SELECT -----------------------------------------------------------
    def _stats_fn(self, table_key: str, col: str):
        st = self.db.stores.get(table_key)
        return None if st is None else st.column_stats(col)

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

        return distribute(plan, self.mesh.size, rows_fn, ndv_fn=ndv_fn,
                          stats_fn=self._stats_fn,
                          where_selectivity=self._where_selectivity(stmt))

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

    def _select(self, stmt: SelectStmt) -> Result:
        if stmt.into_outfile is not None:
            return self._select_into_outfile(stmt)
        eg = egress.extract(stmt, self)
        if eg is not None:
            # the rewritten statement runs on the device; the string
            # skeletons evaluate on the host over its rows
            inner = self._select(eg[0])
            return _host_rows_result(*egress.finish(eg[1], inner))
        plan = self._plan_select(stmt)
        with trace.span("exec.batches"):
            batches = self._collect_batches(plan)
        with trace.span("exec.run"):
            if streaming.stream_source(batches) is not None:
                # out-of-core path: the scan staged a ChunkSource, so this
                # execution is a chunk fold driven from the host
                out = streaming.run_streamed(plan, batches, self.device)
            else:
                run = executor.compile_plan(plan, self.device, self.mesh)
                out = run(batches)
                if self.mesh is not None:
                    self._mpp_telemetry(plan, run.exchanges)
        with trace.span("egress.arrow"):
            table = _egress_compact(out).to_arrow()
        return Result(columns=list(table.column_names), arrow=table)

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

    def _collect_batches(self, plan: PlanNode) -> dict:
        batches: dict = {}

        def walk(n: PlanNode):
            if isinstance(n, ScanNode) and n.table_key not in batches:
                db, name = n.table_key.split(".", 1)
                store = self._store(TableRef(db, name))
                if self.mesh is not None:
                    # the mesh reads whole sharded tables: no streamed or
                    # ANN batches, as in the JAX session
                    batches[n.table_key] = store.sharded_batch(self.mesh)
                else:
                    # an ANN-marked scan reads its IVF candidates; a
                    # streamed plan has this one scan (streaming.eligible)
                    b = self._ann_batch(n, store) if n.ann is not None else None
                    if b is None:
                        b = self._maybe_stream_source(plan, n, store)
                    batches[n.table_key] = b if b is not None \
                        else store.device_table_batch()
            for c in n.children:
                walk(c)

        walk(plan)
        return batches

    def _mpp_telemetry(self, plan: PlanNode, exchanges: list) -> None:
        """Exchange observability of one mesh execution: the
        ``shuffle_rounds`` / ``shuffle_rounds_saved`` counters, and with
        tracing on one ``mpp.repartition`` span per executed repartition
        (its keys or site, the most rows one shard sent one destination),
        one ``mpp.join`` span per shuffle join (its output rows over all
        shards) and one ``mpp.agg`` span per distributed aggregate."""
        summary = executor.exchange_summary(plan)
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


def _annotate_access(plan: PlanNode) -> PlanNode:
    """EXPLAIN display of an ANN-marked scan's access path, without
    building batches (the JAX session's ``_annotate_access`` line)."""
    if isinstance(plan, ScanNode) and plan.ann is not None:
        plan.access_desc = f"ann({plan.ann[0]} nprobe={int(FLAGS.ann_nprobe)})"
    for c in plan.children:
        _annotate_access(c)
    return plan


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
