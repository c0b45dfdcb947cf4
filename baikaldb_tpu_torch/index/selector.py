"""IndexSelector: each scan's access path from its predicates.

The port of ``baikaldb_tpu/index/selector.py``.  A full device scan is the
baseline, so the choice is about what not to stage on the device:

- **point**: WHERE fixes every primary-key column by equality and the
  statement is a plain row fetch -> the host answers from the primary-key
  index, no device work (``is_point_statement`` + ``point_key``).
- **secondary**: an equality on a declared KEY column -> the host gathers
  the matching rows and only they are staged; chosen when the estimated
  match fraction is small.
- **global**: an equality on a global index's first column -> the backing
  table's rows give the primary keys, and the main table's rows with those
  keys are staged (the lookup join); chosen on the same fraction.
- **partition**: a predicate on a partitioned table's partition column ->
  the regions of the partitions it cannot touch drop before staging; the
  kept regions are staged as one batch, which the kernels read once.
- **zonemap**: range / equality predicates on numeric and temporal columns
  drop whole regions by their min/max before staging.
- **full**: everything else.

``analyze_conjuncts`` collects, per column, the closed ``[lo, hi]`` interval
a scan's col-vs-literal comparisons allow (``BETWEEN`` is not read, as in the
JAX package); region zone maps and the streamed scan's chunk zone maps are
held against it.  The device filter still runs, so every path only needs a
conservative superset of the rows.  EXPLAIN shows the choice
(``access=...``), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..expr.ast import AggCall, Call, ColRef, Expr, Lit, Subquery

# predicates usable for zone-map pruning (each bounds a closed [lo, hi])
_RANGE_OPS = {"eq", "lt", "le", "gt", "ge"}


@dataclass
class ScanPredicates:
    """Per-column conjunctive constraints extracted from a pushed filter."""
    eq: dict = field(default_factory=dict)        # col -> literal value
    ranges: dict = field(default_factory=dict)    # col -> [lo, hi] (closed,
    #                                               None = unbounded)


def _strip(name: str) -> str:
    return name.split(".", 1)[1] if "." in name else name


def analyze_conjuncts(e: Optional[Expr]) -> ScanPredicates:
    """Walk the AND-tree collecting col-vs-literal comparisons; anything
    else is ignored (the device filter still applies it — index choices
    must only be conservative supersets)."""
    sp = ScanPredicates()
    if e is None:
        return sp

    def visit(x):
        if isinstance(x, Call) and x.op == "and":
            for a in x.args:
                visit(a)
            return
        if not isinstance(x, Call) or x.op not in _RANGE_OPS:
            return
        if len(x.args) != 2:
            return
        a, b = x.args
        op = x.op
        if isinstance(a, Lit) and isinstance(b, ColRef):
            a, b = b, a
            op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                  "eq": "eq"}[op]
        if not (isinstance(a, ColRef) and isinstance(b, Lit)):
            return
        col = _strip(a.name)
        v = b.value
        if v is None:
            return
        if op == "eq":
            sp.eq[col] = v
        lo, hi = sp.ranges.get(col, [None, None])
        try:
            if op == "eq":
                lo = v if lo is None else max(lo, v)
                hi = v if hi is None else min(hi, v)
            elif op in ("gt", "ge"):
                lo = v if lo is None else max(lo, v)
            else:                                  # lt / le
                hi = v if hi is None else min(hi, v)
        except TypeError:
            return          # mixed-type literals on one column: no constraint
        sp.ranges[col] = [lo, hi]

    visit(e)
    return sp


def is_point_statement(stmt) -> bool:
    """A statement shape the host row tier can answer directly."""
    if (stmt.joins or stmt.ctes or stmt.union or stmt.distinct
            or stmt.group_by or stmt.having or stmt.table is None):
        return False
    for it in stmt.items:
        if it.expr is not None and _has_special(it.expr):
            return False
    return stmt.where is not None and not _has_special(stmt.where)


def _has_special(e) -> bool:
    """Aggregates, window calls and subqueries block the host fast path."""
    if isinstance(e, (AggCall, Subquery)) or type(e).__name__ == "WindowCall":
        return True
    return any(_has_special(a) for a in getattr(e, "args", ()))


def point_key(stmt, pk_cols: list[str]) -> Optional[dict]:
    """The key values when WHERE is exactly a primary-key equality
    conjunction (every conjunct ``pk_col = literal``, every key column
    fixed, duplicates consistent); None for any residual term."""
    terms: list = []
    if not _collect_eq_terms(stmt.where, terms):
        return None
    key: dict = {}
    for col, v in terms:
        if col not in pk_cols:
            return None
        if col in key and key[col] != v:
            return None          # id = 7 AND id = 8: a contradiction
        key[col] = v
    return key if set(key) == set(pk_cols) else None


def _collect_eq_terms(e, out: list) -> bool:
    """Flatten an AND-tree of col = literal terms; False on any other shape."""
    if isinstance(e, Call) and e.op == "and":
        return all(_collect_eq_terms(a, out) for a in e.args)
    if isinstance(e, Call) and e.op == "eq" and len(e.args) == 2:
        a, b = e.args
        if isinstance(b, ColRef) and isinstance(a, Lit):
            a, b = b, a
        if isinstance(a, ColRef) and isinstance(b, Lit):
            out.append((_strip(a.name), b.value))
            return True
    return False


def choose_access(info, store, pred: ScanPredicates,
                  secondary_max_fraction: float = 0.2, db=None):
    """-> ("secondary", index_name, col, value) | ("global", index_name,
    col, value) | ("partition", kept partition ids, partitions) |
    ("zonemap", ranges) | ("full",), in the JAX selector's order.  Point
    reads are decided per statement, not here.  ``db`` (the Database)
    resolves global indexes' backing stores; without it the global route is
    not considered."""
    for ix in info.indexes:
        if ix.kind not in ("key", "unique"):
            continue
        if ix.params.get("state", "public") != "public":
            continue
        col = ix.columns[0]
        if col in pred.eq:
            n = max(store.num_rows, 1)
            matches = store.secondary_count(col, pred.eq[col])
            if matches is not None and matches / n <= secondary_max_fraction:
                return ("secondary", ix.name, col, pred.eq[col])
    if db is not None:
        from .globalindex import backing_table_name

        for ix in info.indexes:
            if ix.kind not in ("global", "global_unique") \
                    or ix.params.get("state", "public") != "public":
                continue
            col = ix.columns[0]
            if col not in pred.eq:
                continue
            bstore = db.stores.get(f"{info.database}.{backing_table_name(info.name, ix.name)}")
            if bstore is None:
                continue
            matches = bstore.secondary_count(col, pred.eq[col])
            if matches is not None and matches / max(store.num_rows, 1) \
                    <= secondary_max_fraction:
                return ("global", ix.name, col, pred.eq[col])
    # partition pruning (the reference's PartitionAnalyze,
    # physical_planner.cpp:27-120) before the zone maps look
    spec = store.partition_spec()
    if spec is not None:
        pcol = spec["column"]
        parts = None
        if pcol in pred.eq:
            parts = store.partitions_for(eq_value=pred.eq[pcol])
        elif pcol in pred.ranges:
            parts = store.partitions_for(range_=tuple(pred.ranges[pcol]))
        if parts is not None:
            total = len(spec.get("names") or []) or int(spec.get("n", 0))
            if len(parts) < total:
                return ("partition", parts, total)
    prunable = {c: r for c, r in pred.ranges.items()
                if store.zone_map_column(c) is not None}
    if prunable:
        return ("zonemap", prunable)
    return ("full",)
