"""Rollup index: materialized pre-aggregation the planner can answer
GROUP BY queries from.

The port of ``baikaldb_tpu/index/rollup.py`` (copied; it imports the port's
AST, statements and planner).  A refresh is the GROUP BY of
``refresh_sql`` run through the session: on the card it launches the
ported group kernels like any other dense GROUP BY.

Reference: I_ROLLUP indexes (meta.interface.proto:293) maintained inside
cold-data conversion (src/store/region_olap.cpp:530-651) — per-region
pre-aggregated Parquet the OLAP path scans instead of raw rows.

The design: a rollup is a **hidden aggregate table**
(``__rollup_{table}_{name}``) holding mergeable partials per key combination
— COUNT(*) plus per-measure COUNT/SUM/MIN/MAX — refreshed lazily when the
base table's version moves (the version check is the region add_version
analog; recompute reuses the engine's own GROUP BY pipeline).  At
planning time ``try_rewrite`` answers a SELECT from the rollup when:

- it reads the base table alone (no joins/subqueries/CTEs/DISTINCT),
- its GROUP BY keys are a subset of the rollup keys (plain columns),
- its WHERE touches rollup keys only (pre-aggregation filters on keys are
  exact),
- every aggregate is COUNT(*)/COUNT/SUM/AVG/MIN/MAX over a rollup measure
  (rewritten to re-aggregations of the partials: SUM(sum_v), SUM(cnt_v),
  MIN(min_v), ... — AVG becomes SUM(sum_v)/SUM(cnt_v)).

The rewritten statement is ordinary SQL over the hidden table, so EXPLAIN
shows the rollup scan and the mesh path shards it like any other store.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ..expr.ast import AggCall, Call, ColRef, Expr, Lit, Subquery
from ..sql.stmt import OrderItem, SelectItem, SelectStmt, TableRef
from ..types import Field, LType, Schema

ROLLUP_PREFIX = "__rollup_"


def rollup_table_name(base: str, name: str) -> str:
    return f"{ROLLUP_PREFIX}{base}_{name}"


def is_rollup_table(name: str) -> bool:
    return name.startswith(ROLLUP_PREFIX)


def rollup_schema(base_schema: Schema, keys: list[str],
                  measures: list[str]) -> Schema:
    """Key columns keep their base types; each measure v contributes
    mergeable partial columns cnt_v / sum_v / min_v / max_v; cnt_star counts
    base rows per key combination."""
    by_name = {f.name: f for f in base_schema.fields}
    fields = [Field(k, by_name[k].ltype, by_name[k].nullable) for k in keys]
    fields.append(Field("cnt_star", LType.INT64, False))
    for v in measures:
        f = by_name[v]
        sum_t = LType.INT64 if f.ltype.is_integer else LType.FLOAT64
        fields.append(Field(f"cnt_{v}", LType.INT64, False))
        fields.append(Field(f"sum_{v}", sum_t, True))
        fields.append(Field(f"min_{v}", f.ltype, True))
        fields.append(Field(f"max_{v}", f.ltype, True))
    return Schema(tuple(fields))


def refresh_sql(base_full: str, rt_name: str, keys: list[str],
                measures: list[str]) -> str:
    """The internal GROUP BY that (re)materializes the rollup."""
    parts = list(keys) + ["COUNT(*) cnt_star"]
    for v in measures:
        parts += [f"COUNT({v}) cnt_{v}", f"SUM({v}) sum_{v}",
                  f"MIN({v}) min_{v}", f"MAX({v}) max_{v}"]
    return (f"SELECT {', '.join(parts)} FROM {base_full} "
            f"GROUP BY {', '.join(keys)}")


def _cols_of(e: Optional[Expr]) -> Optional[set]:
    """Plain column names an expression reads; None if it contains anything
    a rollup can't see through (subqueries)."""
    if e is None:
        return set()
    if isinstance(e, Subquery):
        return None
    if isinstance(e, ColRef):
        return {e.name}
    out: set = set()
    for a in getattr(e, "args", ()):  # Call and AggCall both expose args
        sub = _cols_of(a)
        if sub is None:
            return None
        out |= sub
    return out


def _rewrite_expr(e: Expr, keys: set, measures: set):
    """Map base-table expressions onto the rollup's partial columns;
    returns None when not expressible."""
    if isinstance(e, ColRef):
        return ColRef(e.name) if e.name in keys else None
    if isinstance(e, Lit):
        return e
    if isinstance(e, AggCall):
        if e.distinct:
            return None
        if e.op == "count_star" or (e.op == "count" and not e.args):
            # SUM over zero groups is NULL; COUNT must stay 0
            return Call("ifnull", (AggCall("sum", (ColRef("cnt_star"),)),
                                   Lit(0)))
        if len(e.args) != 1 or not isinstance(e.args[0], ColRef):
            return None
        v = e.args[0].name
        if v not in measures:
            return None
        if e.op == "count":
            return Call("ifnull", (AggCall("sum", (ColRef(f"cnt_{v}"),)),
                                   Lit(0)))
        if e.op == "sum":
            return AggCall("sum", (ColRef(f"sum_{v}"),))
        if e.op == "min":
            return AggCall("min", (ColRef(f"min_{v}"),))
        if e.op == "max":
            return AggCall("max", (ColRef(f"max_{v}"),))
        if e.op == "avg":
            return Call("div", (AggCall("sum", (ColRef(f"sum_{v}"),)),
                                AggCall("sum", (ColRef(f"cnt_{v}"),))))
        return None
    if isinstance(e, Call):
        new_args = []
        for a in e.args:
            na = _rewrite_expr(a, keys, measures)
            if na is None:
                return None
            new_args.append(na)
        return Call(e.op, tuple(new_args))
    return None


def try_rewrite(stmt: SelectStmt, base_table: str, rollup_name: str,
                keys: list[str], measures: list[str],
                database: str,
                target_table: Optional[str] = None) -> Optional[SelectStmt]:
    """Rewrite ``stmt`` to read the rollup table, or None if not covered.
    ``target_table`` overrides the hidden-table name — materialized views
    (cdc/views.py) share the partial layout but live under ``__mv_*``."""
    if (stmt.joins or stmt.ctes or stmt.union or stmt.distinct
            or stmt.table is None):
        return None
    if not stmt.group_by and not any(
            isinstance(it.expr, AggCall) or _has_agg(it.expr)
            for it in stmt.items):
        return None                       # plain row scan: rollup can't help
    key_set, measure_set = set(keys), set(measures)
    # WHERE must touch keys only (it filters whole pre-aggregated groups)
    wcols = _cols_of(stmt.where)
    if wcols is None or not wcols <= key_set:
        return None
    # GROUP BY must be plain rollup-key columns
    gb = []
    for g in stmt.group_by:
        if not isinstance(g, ColRef) or g.name not in key_set:
            return None
        gb.append(ColRef(g.name))
    new_items = []
    for it in stmt.items:
        ne = _rewrite_expr(it.expr, key_set, measure_set)
        if ne is None:
            return None
        # un-aliased items must keep the ORIGINAL display name — clients key
        # result dicts by it, and it must not flip when a rollup appears
        alias = it.alias
        if alias is None:
            from ..plan.planner import _display_name
            alias = _display_name(it.expr)
        new_items.append(SelectItem(ne, alias))
    new_having = None
    if stmt.having is not None:
        new_having = _rewrite_expr(stmt.having, key_set, measure_set)
        if new_having is None:
            return None
    new_order = []
    for o in stmt.order_by:
        # ORDER BY may name an output alias (kept) or an expression
        if isinstance(o.expr, ColRef) and o.expr.name in {
                it.alias for it in stmt.items if it.alias}:
            new_order.append(OrderItem(ColRef(o.expr.name), o.asc))
            continue
        ne = _rewrite_expr(o.expr, key_set, measure_set)
        if ne is None:
            return None
        new_order.append(OrderItem(ne, o.asc))
    new_where = (_rewrite_expr(stmt.where, key_set, measure_set)
                 if stmt.where is not None else None)
    if stmt.where is not None and new_where is None:
        return None
    return replace(
        stmt,
        items=new_items,
        table=TableRef(database, target_table if target_table is not None
                       else rollup_table_name(base_table, rollup_name)),
        where=new_where, group_by=gb, having=new_having, order_by=new_order)


def _has_agg(e) -> bool:
    if isinstance(e, AggCall):
        return True
    return any(_has_agg(a) for a in getattr(e, "args", ()))
