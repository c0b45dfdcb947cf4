"""Global secondary indexes: index data in its own tables.

The port of ``baikaldb_tpu/index/globalindex.py`` (copied; it imports only
the port's types).  The reference keeps a global index's rows in their own
regions, reaches them from DML through 2PC spanning the main-table and index
regions (LockPrimaryNode / LockSecondaryNode inserted by plan separation,
src/physical_plan/separate.cpp:653, lock_primary_node.cpp), and reads them
through an index-lookup join (src/exec/select_manager_node.cpp:1081).

Here a global index is a hidden BACKING TABLE in the catalog,
``__gidx__<table>__<index>``, whose rows are (index cols..., pk cols...).
DML on the main table computes the index-entry delta and commits both
tables' writes as one transaction (column_store.commit_group).  The
selector routes equality predicates on the index prefix through the backing
table and joins back to the main table by primary key (the lookup join).

Uniqueness (global UNIQUE) is enforced against the backing table BEFORE the
coupled commit; MySQL semantics: rows with NULL in any indexed column never
conflict.  The check runs on the frontend's column cache — the same
consistency level as the main table's PRIMARY KEY check.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import pyarrow as pa

from ..types import Field, Schema

if TYPE_CHECKING:   # pragma: no cover
    from ..meta.catalog import IndexInfo, TableInfo

GLOBAL_KINDS = ("global", "global_unique")
_PREFIX = "__gidx__"


def is_global(ix) -> bool:
    return ix.kind in GLOBAL_KINDS


def is_backing_table(name: str) -> bool:
    return name.startswith(_PREFIX)


def backing_table_name(table: str, index_name: str) -> str:
    return f"{_PREFIX}{table}__{index_name}"


def public_global_indexes(info) -> list:
    return [ix for ix in info.indexes
            if is_global(ix) and ix.params.get("state", "public") == "public"]


def index_columns(info, ix) -> tuple[list[str], list[str]]:
    """-> (indexed cols, pk cols NOT already indexed).  The backing row is
    their concatenation — enough to answer the index predicate and to join
    back to the main table by primary key."""
    pk = info.primary_key()
    pk_cols = [c for c in (pk.columns if pk else []) if c not in ix.columns]
    return list(ix.columns), pk_cols


def backing_schema(info, ix) -> Schema:
    icols, pk_cols = index_columns(info, ix)
    by_name = {f.name: f for f in info.schema.fields}
    fields = []
    for c in icols + pk_cols:
        f = by_name[c]
        fields.append(Field(f.name, f.ltype, f.nullable))
    return Schema(tuple(fields))


def backing_pk(info, ix) -> list[str]:
    """The backing table's logical primary key: index cols + pk cols.
    ALWAYS both — uniqueness is enforced separately with NULL semantics,
    and non-unique indexes need the pk suffix to keep entries distinct."""
    icols, pk_cols = index_columns(info, ix)
    return icols + pk_cols


def entry_rows(info, ix, rows: list[dict]) -> list[dict]:
    """Project main-table rows to backing-table entry rows."""
    cols = [f.name for f in backing_schema(info, ix).fields]
    return [{c: r.get(c) for c in cols} for r in rows]


def entry_table(info, ix, table: pa.Table) -> pa.Table:
    cols = [f.name for f in backing_schema(info, ix).fields]
    return table.select(cols)


def check_unique(info, ix, backing_store, new_rows: list[dict],
                 exclude_pks: set | None = None) -> None:
    """Raise on a global-UNIQUE violation: an existing backing entry (or a
    duplicate within ``new_rows``) shares the indexed values with a
    DIFFERENT primary key.  Rows with NULL in any indexed column never
    conflict (MySQL unique semantics)."""
    from ..storage.rowstore import ConflictError

    if ix.kind != "global_unique":
        return
    icols, pk_cols = index_columns(info, ix)
    pk_all = [c for c in (info.primary_key().columns
                          if info.primary_key() else [])]

    def ival(r):
        v = tuple(r.get(c) for c in icols)
        return None if any(x is None for x in v) else v

    def pkval(r):
        return tuple(r.get(c) for c in pk_all)

    seen: dict[tuple, tuple] = {}
    for r in new_rows:
        v = ival(r)
        if v is None:
            continue
        pk = pkval(r)
        if v in seen and seen[v] != pk:
            raise ConflictError(
                f"Duplicate entry {v!r} for key {ix.name!r}")
        seen[v] = pk
    if not seen:
        return
    # candidate set from the backing store's sorted-order artifact on the
    # first indexed column, then exact-match the rest host-side
    snap = None
    for v, pk in seen.items():
        try:
            pos = backing_store.secondary_positions(icols[0], v[0])
        except Exception:                     # unsortable column: full check
            pos = None
        if pos is None:
            if snap is None:
                snap = backing_store.snapshot()
            cand = snap
        else:
            if len(pos) == 0:
                continue
            if snap is None:
                snap = backing_store.snapshot()
            cand = snap.take(pa.array(np.asarray(pos, dtype=np.int64)))
        for er in cand.to_pylist():
            if tuple(er.get(c) for c in icols) != v:
                continue
            if tuple(er.get(c) for c in pk_all) != pk and \
                    (exclude_pks is None or
                     tuple(er.get(c) for c in pk_all) not in exclude_pks):
                raise ConflictError(
                    f"Duplicate entry {v!r} for key {ix.name!r}")
