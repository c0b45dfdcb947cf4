"""Auto-parameterization: one cached plan serves every literal variant of a
query shape.

A copy of ``baikaldb_tpu/plan/paramize.py`` (host-only Python).  A plan cache
keyed on raw SQL text pays parse -> plan for ``WHERE id = 42`` and again for
``WHERE id = 43``; literal auto-parameterization (BaikalDB's
prepared-statement plan reuse) keys it on the statement's shape instead, and
the hoisted literals become runtime arguments of the plan: the executor
binds them (expr/params.py) and every ``Param`` node reads its slot.  The
batched dispatcher (exec/dispatch.py) stacks the bound values of one group
along a lane axis.

``normalize`` walks a parsed SELECT, extracts parameterizable ``Lit`` nodes
from the WHERE tree into an ordered parameter vector (``Param`` AST nodes in
their place), and produces a canonical cache key: literal positions appear
as typed markers, every pinned literal by value.  ``bind`` turns the current
statement's raw values into the typed scalars the executor binds
(expr/params.py).

Parameterizability analysis — conservative fallback, pinned positions stay
part of the cache key:

- only the WHERE clause is hoisted, and only inside AND/OR/NOT/XOR,
  comparison, BETWEEN, and arithmetic structure.  Everything else — IN-list
  members (host-sorted at plan time), LIKE/MATCH patterns, SUBSTR/CAST
  arguments, GROUP BY / ORDER BY positions, window-frame counts — feeds
  plan-time or plan-shape decisions and stays baked.
- LIMIT/OFFSET are plain statement fields, structural by construction.
- NULL and boolean literals stay baked (they constant-fold through planner
  three-valued-logic decisions).
- string literals hoist only as a direct comparison operand of a resolvable
  column: against a STRING column they bind as (lo, hi) dictionary-code
  bounds per execution — dictionary identity never forks plans;
  against a temporal column as a parsed temporal scalar; against a numeric
  column as the MySQL leading-numeric double.

Host-side access-path choices (secondary index, zonemap, partition pruning)
re-substitute the bound values per execution (``substitute_params``), so the
compiled plan is literal-independent while the scan input selection still
sees real values.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Callable, Optional

from ..expr.ast import (AggCall, Call, ColRef, Expr, Lit, Param, Placeholder,
                        Subquery, WindowCall)
from ..sql.stmt import (DeleteStmt, InsertStmt, JoinClause, OrderItem,
                        SelectItem, SelectStmt, TableRef, UpdateStmt)
from ..types import LType

_BOOL_OPS = frozenset({"and", "or", "not", "xor"})
_CMP_OPS = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})
_ARITH_OPS = frozenset({"add", "sub", "mul", "div", "int_div", "mod", "neg"})


class BindError(ValueError):
    """A param value cannot bind under the current schema/dictionary; the
    session falls back to unparameterized execution of this statement."""


@dataclass
class ParamSlot:
    index: int
    binder: tuple       # ("scalar", LType) | ("strnum",) |
    #                     ("temporal", LType) | ("strcmp", table_key, col)
    value: object       # raw literal value from THIS statement


@dataclass
class Normalized:
    stmt: SelectStmt    # rewritten statement (Param nodes in the WHERE tree)
    key: tuple          # canonical structural cache key
    slots: list
    pinned: int         # Lit nodes remaining in the rewritten statement

    @property
    def hoisted(self) -> int:
        return len(self.slots)


# ---------------------------------------------------------------------------
# normalization

def normalize(stmt: SelectStmt,
              resolve: Callable[[Optional[str], str],
                                Optional[tuple]]) -> Normalized:
    """Hoist parameterizable WHERE literals of ``stmt`` (non-destructively)
    and build the canonical cache key.  ``resolve(table_label, col_name)``
    returns ``(table_key, LType)`` for a resolvable base-table column, else
    None (unresolvable operands pin their comparand)."""
    slots: list[ParamSlot] = []

    def hoist_num(l: Lit) -> Optional[Param]:
        if l.ltype is not None:
            return None     # planner/collation-typed literals stay baked
        v = l.value
        if v is None or isinstance(v, bool):
            return None
        if isinstance(v, int):
            lt = LType.INT64
        elif isinstance(v, float):
            lt = LType.FLOAT64
        else:
            return None
        slots.append(ParamSlot(len(slots), ("scalar", lt), v))
        return Param(slots[-1].index, lt)

    def hoist_str_vs(col: ColRef, l: Lit) -> Optional[Param]:
        if l.ltype is not None or not isinstance(l.value, str):
            return None
        r = resolve(col.table, col.name)
        if r is None:
            return None
        table_key, lt = r
        i = len(slots)
        if lt is LType.STRING:
            slots.append(ParamSlot(
                i, ("strcmp", table_key, col.name.split(".")[-1]), l.value))
            return Param(i, LType.STRING, "strcmp")
        if lt.is_temporal:
            from ..expr.compile import ExprError, parse_temporal
            try:
                parse_temporal(l.value, lt)
            except (ExprError, ValueError):
                return None     # non-temporal-shaped: keep baked semantics
            slots.append(ParamSlot(i, ("temporal", lt), l.value))
            return Param(i, lt)
        if lt.is_numeric:
            slots.append(ParamSlot(i, ("strnum",), l.value))
            return Param(i, LType.FLOAT64)
        return None

    def rw_operand(x: Expr, other: Expr) -> Expr:
        if isinstance(x, Lit):
            p = hoist_num(x)
            if p is not None:
                return p
            if isinstance(other, ColRef):
                p = hoist_str_vs(other, x)
                if p is not None:
                    return p
            return x
        return rw_arith(x)

    def rw_arith(e: Expr) -> Expr:
        if isinstance(e, Lit):
            p = hoist_num(e)
            return p if p is not None else e
        if isinstance(e, Call) and e.op in _ARITH_OPS:
            return Call(e.op, tuple(rw_arith(a) for a in e.args))
        return e

    def rw(e: Expr) -> Expr:
        if not isinstance(e, Call):
            return e
        if e.op in _BOOL_OPS:
            return Call(e.op, tuple(rw(a) for a in e.args))
        if e.op in _CMP_OPS and len(e.args) == 2:
            a, b = e.args
            return Call(e.op, (rw_operand(a, b), rw_operand(b, a)))
        if e.op == "between" and len(e.args) == 3:
            x, lo, hi = e.args
            return Call("between",
                        (rw_arith(x), rw_operand(lo, x), rw_operand(hi, x)))
        if e.op in _ARITH_OPS:
            return rw_arith(e)
        return e    # pinned subtree (IN, LIKE, functions, subqueries, ...)

    new_where = rw(stmt.where) if stmt.where is not None else None
    out = _dc_replace(stmt, where=new_where) if slots else stmt
    return Normalized(out, stmt_key(out), slots, _count_lits(out))


def _iter_exprs(stmt):
    """Yield every expression node reachable from a statement — the ONE
    statement-shape traversal (SELECT clauses, derived tables, CTEs, union
    arms, subquery expressions, and the DML shapes), shared by the literal
    counter and the placeholder collector so a new clause only needs to be
    taught here."""

    def ve(e):
        if e is None:
            return
        yield e
        if isinstance(e, Subquery):
            yield from vs(e.stmt)
            return
        for a in getattr(e, "args", ()):
            yield from ve(a)
        for a in getattr(e, "partition_by", ()):
            yield from ve(a)
        for a, _asc in getattr(e, "order_by", ()) or ():
            yield from ve(a)

    def vs(s):
        if s is None:
            return
        if isinstance(s, SelectStmt):
            for it in s.items:
                yield from ve(it.expr)
            if s.table is not None:
                yield from vs(s.table.subquery)
            for j in s.joins:
                yield from vs(j.table.subquery)
                yield from ve(j.on)
            yield from ve(s.where)
            for g in s.group_by:
                yield from ve(g)
            yield from ve(s.having)
            for o in s.order_by:
                yield from ve(o.expr)
            for _nm, sub in s.ctes:
                yield from vs(sub)
            if s.union is not None:
                yield from vs(s.union[1])
        elif isinstance(s, InsertStmt):
            for row in s.rows:
                for cell in row:
                    if isinstance(cell, Expr):      # ? placeholders
                        yield cell
            for _c, spec in s.on_dup:
                # ("lit", value) cells may hold a ? via literal_value()
                if spec[0] == "lit" and isinstance(spec[1], Expr):
                    yield spec[1]
            yield from vs(s.select)
        elif isinstance(s, UpdateStmt):
            for _c, e in s.assignments:
                yield from ve(e)
            yield from ve(s.where)
        elif isinstance(s, DeleteStmt):
            yield from ve(s.where)

    if isinstance(stmt, Expr):
        yield from ve(stmt)
    else:
        yield from vs(stmt)


def _count_lits(stmt) -> int:
    """Literal positions still baked into the (possibly rewritten) statement
    — the EXPLAIN ANALYZE ``-- params:`` pinned count."""
    return sum(1 for e in _iter_exprs(stmt) if isinstance(e, Lit))


# ---------------------------------------------------------------------------
# canonical keys

def expr_key(e: Optional[Expr]):
    """Hashable structural key.  Unlike Expr.key(), recurses through
    Subquery *statements* (Subquery.key is id-based, which would make every
    re-parse of the same text a cache miss)."""
    if e is None:
        return None
    if isinstance(e, Lit):
        v = e.value
        return ("lit", type(v).__name__, str(v) if isinstance(v, LType)
                else v, e.ltype)
    if isinstance(e, Param):
        return ("param", e.index, e.ltype, e.kind)
    if isinstance(e, Placeholder):
        return ("?", e.index)
    if isinstance(e, ColRef):
        return ("col", e.table, e.name)
    if isinstance(e, Subquery):
        return ("subq", stmt_key(e.stmt))
    if isinstance(e, AggCall):
        return ("agg", e.op, e.distinct) + tuple(expr_key(a) for a in e.args)
    if isinstance(e, WindowCall):
        return (("win", e.op, e.running, e.frame)
                + tuple(expr_key(a) for a in e.args)
                + tuple(expr_key(p) for p in e.partition_by)
                + tuple((expr_key(x), asc) for x, asc in e.order_by))
    if isinstance(e, Call):
        return ("call", e.op) + tuple(expr_key(a) for a in e.args)
    return ("other", repr(e))


def _tref_key(t: Optional[TableRef]):
    if t is None:
        return None
    return (t.database, t.name, t.alias,
            stmt_key(t.subquery) if t.subquery is not None else None)


def stmt_key(s: SelectStmt) -> tuple:
    """Canonical structural key of a SELECT: every plan-relevant field,
    Param positions as typed markers, pinned literals by value."""
    return (
        "select",
        tuple((expr_key(it.expr), it.alias, it.star_table) for it in s.items),
        _tref_key(s.table),
        tuple((j.kind, _tref_key(j.table), expr_key(j.on), tuple(j.using))
              for j in s.joins),
        expr_key(s.where),
        tuple(expr_key(g) for g in s.group_by),
        expr_key(s.having),
        tuple((expr_key(o.expr), o.asc) for o in s.order_by),
        s.limit, s.offset, s.distinct,
        (s.union[0], stmt_key(s.union[1])) if s.union is not None else None,
        tuple((nm, stmt_key(sub)) for nm, sub in s.ctes),
        s.into_outfile,
    )


# ---------------------------------------------------------------------------
# binding (per execution)

def bind(slots: list, batches: dict) -> tuple:
    """Raw literal values -> the typed params tuple.  strcmp slots search
    the compared column's dictionary in the CURRENT scan batch, so
    dictionary rebuilds change two i32 values, never the plan.

    The leaves are HOST (numpy) scalars on purpose: the executor moves
    them to the device when it runs the plan, and the batched dispatcher
    stacks a whole group's feeds on the host and moves each slot in one
    transfer."""
    import numpy as np

    out = []
    for s in slots:
        kind = s.binder[0]
        if kind == "scalar":
            lt = s.binder[1]
            out.append(np.asarray(s.value, lt.np_dtype))
        elif kind == "strnum":
            from ..expr.compile import _mysql_str_to_num
            out.append(np.asarray(_mysql_str_to_num(str(s.value)),
                                  np.float64))
        elif kind == "temporal":
            from ..expr.compile import ExprError, parse_temporal
            lt = s.binder[1]
            try:
                v = parse_temporal(str(s.value), lt)
            except (ExprError, ValueError) as exc:
                raise BindError(str(exc)) from exc
            out.append(np.asarray(v, lt.np_dtype))
        elif kind == "strcmp":
            _, table_key, col = s.binder
            b = batches.get(table_key)
            if b is None or col not in b.names:
                raise BindError(f"strcmp param column {table_key}.{col} "
                                "not in scan batch")
            d = _dictionary(b, col)
            if d is None:
                raise BindError(f"{table_key}.{col} has no dictionary")
            sv = str(s.value)
            out.append(np.asarray([d.lower_bound(sv), d.upper_bound(sv)],
                                  np.int32))
        else:
            raise BindError(f"unknown binder {s.binder!r}")
    return tuple(out)


def _dictionary(b, col: str):
    """The string dictionary of ``col`` in a scan input: a batch, the
    shards of a mesh value (one dictionary for all of them), or a streamed
    chunk set (one table-wide dictionary a column)."""
    if hasattr(b, "shards"):
        b = b.shards[0]
    if hasattr(b, "chunks"):
        return b.chunks._dicts.get(col)
    return b.column(col).dictionary


def substitute_params(e: Optional[Expr], values: dict) -> Optional[Expr]:
    """Param slots -> Lit(value) (host-side only): lets per-execution
    access-path analysis (index selection, zonemap/partition pruning) see
    the real literal values of a parameterized filter."""
    if e is None:
        return None
    if isinstance(e, Param):
        v = values.get(e.index)
        return e if v is None else Lit(v.value)
    if isinstance(e, Call):
        return Call(e.op, tuple(substitute_params(a, values) for a in e.args))
    return e


# ---------------------------------------------------------------------------
# PREPARE/EXECUTE placeholder substitution

def count_placeholders(stmt) -> int:
    return sum(1 for e in _iter_exprs(stmt) if isinstance(e, Placeholder))


def substitute_placeholders(stmt, values: list):
    """Rebuild ``stmt`` with every ``?`` slot replaced by Lit(values[i])
    (or the raw value, inside INSERT VALUES rows).  Positional, in parse
    order — the indexes assigned by the parser."""

    def ve(e):
        if e is None:
            return None
        if isinstance(e, Placeholder):
            if e.index >= len(values):
                raise ValueError(
                    f"EXECUTE needs {e.index + 1} parameters, got "
                    f"{len(values)}")
            return Lit(values[e.index])
        if isinstance(e, Subquery):
            return Subquery(vs(e.stmt))
        if isinstance(e, Call):
            return Call(e.op, tuple(ve(a) for a in e.args))
        if isinstance(e, AggCall):
            return AggCall(e.op, tuple(ve(a) for a in e.args),
                           distinct=e.distinct)
        if isinstance(e, WindowCall):
            return WindowCall(e.op, tuple(ve(a) for a in e.args),
                              tuple(ve(p) for p in e.partition_by),
                              tuple((ve(x), asc) for x, asc in e.order_by),
                              e.running, e.frame)
        return e

    def vtref(t):
        if t is None:
            return None
        if t.subquery is None:
            return t
        return TableRef(t.database, t.name, t.alias, vs(t.subquery))

    def vs(s):
        if s is None:
            return None
        if isinstance(s, SelectStmt):
            return _dc_replace(
                s,
                items=[SelectItem(ve(it.expr), it.alias, it.star_table)
                       for it in s.items],
                table=vtref(s.table),
                joins=[JoinClause(j.kind, vtref(j.table), ve(j.on),
                                  list(j.using)) for j in s.joins],
                where=ve(s.where),
                group_by=[ve(g) for g in s.group_by],
                having=ve(s.having),
                order_by=[OrderItem(ve(o.expr), o.asc) for o in s.order_by],
                ctes=[(nm, vs(sub)) for nm, sub in s.ctes],
                union=(s.union[0], vs(s.union[1]))
                if s.union is not None else None)
        if isinstance(s, InsertStmt):
            def cell(c):
                if isinstance(c, Placeholder):
                    if c.index >= len(values):
                        raise ValueError(
                            f"EXECUTE needs {c.index + 1} parameters, got "
                            f"{len(values)}")
                    return values[c.index]
                return c
            return _dc_replace(
                s, rows=[[cell(c) for c in row] for row in s.rows],
                on_dup=[(col, ("lit", cell(spec[1])) if spec[0] == "lit"
                         else spec) for col, spec in s.on_dup],
                select=vs(s.select))
        if isinstance(s, UpdateStmt):
            return _dc_replace(s, assignments=[(c, ve(e))
                                               for c, e in s.assignments],
                               where=ve(s.where))
        if isinstance(s, DeleteStmt):
            return _dc_replace(s, where=ve(s.where))
        return s

    return vs(stmt)
