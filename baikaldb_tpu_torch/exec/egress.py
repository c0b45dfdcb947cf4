"""Egress-stage evaluation of data-dependent string builtins.

The port of ``baikaldb_tpu/exec/egress.py`` (``extract`` and ``finish``).
DATE_FORMAT / FORMAT / HEX / BIN / OCT over numeric inputs produce strings
that have no dictionary on the device.  The reference evaluates them
row-wise wherever they appear (src/expr/internal_functions.cpp); here each
position gets the host-stage treatment the JAX package gives it, so the
device plan stays what it is for any other query:

- SELECT list: the statement is rewritten so the device computes every
  numeric/temporal subexpression as hidden outputs, and the string skeleton
  is evaluated host-side over the (final-sized) result via expr/roweval.
- WHERE: comparisons are INVERTED into native predicates — monotone
  DATE_FORMAT outputs ('%Y', '%Y-%m', '%Y-%m-%d', ...) become range
  predicates on the underlying temporal value, HEX/BIN/OCT over integers
  become integer equalities — so filtering stays on the device at full
  selectivity.
- GROUP BY: monotone DATE_FORMAT keys become numeric bucket keys
  (year(d), year*100+month, to_days(d), unix_timestamp(d)) with a MIN()
  representative for display, so aggregation stays a device GROUP BY.
- ORDER BY touching an egress output falls back to a host sort over the
  final result (LIMIT/OFFSET applied after it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..expr.ast import AggCall, Call, ColRef, Expr, Lit, WindowCall
from ..expr.roweval import eval_row
from ..expr.strfmt import (boundary_bucket_start, bucket_range,
                           monotone_granularity, parse_radix_literal)
from ..plan.planner import PlanError
from ..sql.stmt import OrderItem, SelectItem, SelectStmt
from ..types import LType

EGRESS_OPS = frozenset({"date_format", "format", "hex_str", "bin", "oct"})
_RADIX = {"hex_str": 16, "bin": 2, "oct": 8}


def has_egress(e: Optional[Expr]) -> bool:
    if e is None:
        return False
    if isinstance(e, Call) and e.op in EGRESS_OPS:
        return True
    return any(has_egress(a) for a in getattr(e, "args", ())) or \
        any(has_egress(a) for a in getattr(e, "partition_by", ())) or \
        any(has_egress(a) for a, _ in getattr(e, "order_by", ()))


@dataclass
class EgressSpec:
    names: list = field(default_factory=list)        # display names
    # per original item: ("col", inner_alias) | ("expr", skeleton)
    out: list = field(default_factory=list)
    # [] = inner ORDER BY kept; else host sort over the final env
    order: list = field(default_factory=list)        # (skeleton|alias ref, asc)
    limit: Optional[int] = None
    offset: int = 0


class _Rewriter:
    def __init__(self, stmt: SelectStmt, session):
        self.stmt = stmt
        self.session = session
        self.hidden: list[Expr] = []       # inner select item exprs
        self.hidden_keys: dict = {}
        self.col_types = self._collect_types()

    def _collect_types(self) -> dict:
        """(table_label_or_None, col) -> LType over the FROM tables; used
        only to type HEX/BIN/OCT inversion targets.  Ambiguous bare names
        map to None."""
        out: dict = {}
        refs = []
        if self.stmt.table is not None and self.stmt.table.subquery is None:
            refs.append(self.stmt.table)
        for j in self.stmt.joins:
            if j.table.subquery is None:
                refs.append(j.table)
        for r in refs:
            db = r.database or self.session.current_db
            try:
                info = self.session.db.catalog.get_table(db, r.name)
            except ValueError:      # unknown table — planner reports it
                continue
            for f in info.schema.fields:
                out[(r.label, f.name)] = f.ltype
                bare = (None, f.name)
                out[bare] = None if bare in out else f.ltype
        return out

    def _type_of(self, e: Expr) -> Optional[LType]:
        if isinstance(e, ColRef):
            return self.col_types.get((e.table, e.name))
        return None

    def _hide(self, e: Expr) -> ColRef:
        k = e.key()
        idx = self.hidden_keys.get(k)
        if idx is None:
            idx = len(self.hidden)
            self.hidden.append(e)
            self.hidden_keys[k] = idx
        return ColRef(f"__c{idx}")

    def skeletonize(self, e: Expr) -> Expr:
        """Kernel-computable subtrees become hidden inner outputs; the
        remaining skeleton (egress calls + their ancestors) evaluates
        host-side via expr/roweval over the inner result."""
        if not has_egress(e):
            return self._hide(e)
        if isinstance(e, Call):
            return Call(e.op, tuple(self.skeletonize(a) for a in e.args))
        if isinstance(e, (AggCall, WindowCall)):
            raise PlanError(
                f"{e.op} over a formatted string is not supported; "
                f"aggregate the underlying value instead")
        raise PlanError(f"cannot evaluate {e!r} at result egress")

    # -- WHERE inversion --------------------------------------------------
    def invert_conjunct(self, c: Expr) -> Expr:
        """Rewrite one WHERE conjunct containing an egress call into a
        native predicate, or raise PlanError."""
        if isinstance(c, Call) and c.op == "between" and \
                has_egress(c.args[0]) and not has_egress(c.args[1]) and \
                not has_egress(c.args[2]):
            return Call("and",
                        (self.invert_conjunct(Call("ge", (c.args[0],
                                                          c.args[1]))),
                         self.invert_conjunct(Call("le", (c.args[0],
                                                          c.args[2])))))
        if isinstance(c, Call) and c.op in ("in", "not_in") and \
                has_egress(c.args[0]) and \
                not any(has_egress(a) for a in c.args[1:]):
            parts = [self.invert_conjunct(Call("eq", (c.args[0], a)))
                     for a in c.args[1:]]
            pred = parts[0]
            for p in parts[1:]:
                pred = Call("or", (pred, p))
            return Call("not", (pred,)) if c.op == "not_in" else pred
        if not (isinstance(c, Call)
                and c.op in ("eq", "ne", "lt", "le", "gt", "ge")):
            raise PlanError(
                f"{self._fn_name(c)} in WHERE is only supported as a "
                f"direct comparison with a literal")
        a, b = c.args
        op = c.op
        if has_egress(b) and not has_egress(a):
            a, b = b, a
            op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
        if has_egress(b) or not isinstance(b, Lit) or \
                not isinstance(a, Call) or a.op not in EGRESS_OPS or \
                any(has_egress(x) for x in a.args):
            raise PlanError(
                f"{self._fn_name(c)} in WHERE is only supported as a "
                f"direct comparison with a literal")
        if a.op == "date_format":
            return self._invert_date_format(a, op, b)
        if a.op in _RADIX:
            return self._invert_radix(a, op, b)
        raise PlanError(f"{a.op.upper()} results cannot be filtered in "
                        f"WHERE; compare the underlying value")

    @staticmethod
    def _fn_name(c: Expr) -> str:
        for x in _walk(c):
            if isinstance(x, Call) and x.op in EGRESS_OPS:
                return {"hex_str": "HEX"}.get(x.op, x.op.upper())
        return "formatted output"

    @staticmethod
    def _never() -> Expr:
        return Call("eq", (Lit(0), Lit(1)))

    @staticmethod
    def _always() -> Expr:
        return Call("eq", (Lit(0), Lit(0)))

    def _invert_date_format(self, a: Call, op: str, lit: Lit) -> Expr:
        if len(a.args) != 2 or not isinstance(a.args[1], Lit):
            raise PlanError("DATE_FORMAT in WHERE needs a literal format")
        fmt = str(a.args[1].value)
        if monotone_granularity(fmt) is None:
            raise PlanError(
                f"DATE_FORMAT({fmt!r}) is not monotone in the date — "
                f"filter on the underlying value or use %Y / %Y-%m / "
                f"%Y-%m-%d style formats")
        d = a.args[0]
        s = str(lit.value)
        if op in ("eq", "ne"):
            rng = bucket_range(fmt, s)
            if rng is None:
                # not a canonical output: the binary-collation equality
                # can never hold; <> holds for every non-NULL value
                if op == "ne":
                    return Call("is_not_null", (d,))
                return self._never()
            lo, hi = rng
            if op == "eq":
                return Call("and", (Call("ge", (d, Lit(lo))),
                                    Call("lt", (d, Lit(hi)))))
            return Call("or", (Call("lt", (d, Lit(lo))),
                               Call("ge", (d, Lit(hi)))))
        # ordering against an ARBITRARY literal: find the first bucket
        # whose formatted output sorts above it (lexicographic order ==
        # chronological order for monotone formats), host-side
        strict = op in ("le", "gt")      # boundary: first output > lit
        b = boundary_bucket_start(fmt, s, strict)
        want_ge = op in ("gt", "ge")     # fmt(d) > / >= lit <=> d >= b
        if b is None:                    # every output sorts above lit
            return Call("is_not_null", (d,)) if want_ge else self._never()
        if b == "":                      # no output sorts above lit
            return self._never() if want_ge else \
                Call("is_not_null", (d,))
        return Call("ge" if want_ge else "lt", (d, Lit(b)))

    def _invert_radix(self, a: Call, op: str, lit: Lit) -> Expr:
        x = a.args[0]
        t = self._type_of(x)
        if a.op == "hex_str" and t is not None and t.is_string:
            # HEX over a string column hexes bytes — the kernel's
            # dictionary transform handles that comparison natively
            return Call(op, (a, lit))
        if t is None or not t.is_integer:
            raise PlanError(
                f"{self._fn_name(a)} in WHERE needs an integer column")
        if op not in ("eq", "ne"):
            raise PlanError(
                f"{self._fn_name(a)} output is not ordered numerically; "
                f"only = and <> comparisons are supported in WHERE")
        from ..expr.strfmt import mysql_bin, mysql_hex, mysql_oct

        s = str(lit.value)
        v = parse_radix_literal(s, _RADIX[a.op])
        canon = {"hex_str": mysql_hex, "bin": mysql_bin,
                 "oct": mysql_oct}[a.op]
        if v is None or canon(v) != s:
            # not the formatter's canonical output ('0xFF', '+ff', 'ff'):
            # binary-collation equality can never hold
            return Call("is_not_null", (x,)) if op == "ne" \
                else self._never()
        return Call(op, (x, Lit(v)))


def _walk(e: Expr):
    yield e
    for a in getattr(e, "args", ()):
        yield from _walk(a)


from ..plan.eqclasses import conjuncts as _conjuncts  # noqa: E402


def _and_all(parts: list[Expr]) -> Optional[Expr]:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = Call("and", (out, p))
    return out


def _display_name(e: Expr) -> str:
    if isinstance(e, ColRef):
        return e.name.split(".")[-1] if e.table is None else e.name
    return repr(e)


_BUCKETS = {
    "year": lambda d: Call("year", (d,)),
    "month": lambda d: Call("add", (Call("mul", (Call("year", (d,)),
                                                 Lit(100))),
                                    Call("month", (d,)))),
    "day": lambda d: Call("to_days", (d,)),
    "second": lambda d: Call("unix_timestamp", (d,)),
}


def extract(stmt: SelectStmt, session):
    """None when the statement uses no egress builtins; otherwise
    (inner_stmt, EgressSpec) — or PlanError when a position cannot be
    given exact semantics host-side."""
    if getattr(stmt, "_egress_done", False):
        # already rewritten: any egress call still present is one the
        # kernel lowers natively (HEX over a string column)
        return None
    exprs = ([it.expr for it in stmt.items if it.expr is not None]
             + [stmt.where, stmt.having] + list(stmt.group_by)
             + [o.expr for o in stmt.order_by])
    if not any(has_egress(e) for e in exprs):
        return None
    if stmt.distinct or stmt.union is not None:
        raise PlanError("formatted-string outputs are not supported with "
                        "DISTINCT/UNION; format in an outer query")
    rw = _Rewriter(stmt, session)

    # resolve ordinals and item-alias references so every position holds
    # the real expression (the planner does the same substitution)
    alias_expr = {}
    for it in stmt.items:
        if it.expr is not None and it.alias:
            alias_expr.setdefault(it.alias, it.expr)

    def resolve(e: Expr) -> Expr:
        if isinstance(e, Lit) and isinstance(e.value, int) \
                and not isinstance(e.value, bool) \
                and 1 <= e.value <= len(stmt.items):
            it = stmt.items[e.value - 1]
            if it.expr is not None:
                return it.expr
        if isinstance(e, ColRef) and e.table is None \
                and e.name in alias_expr:
            return alias_expr[e.name]
        return e

    group_by = [resolve(g) for g in stmt.group_by]
    order_by = [OrderItem(resolve(o.expr), o.asc) for o in stmt.order_by]

    # GROUP BY on monotone DATE_FORMAT: numeric bucket key + a MIN()
    # representative so the formatted key is printable per group
    subst: dict = {}
    new_group = []
    for g in group_by:
        if not has_egress(g):
            new_group.append(g)
            continue
        if not (isinstance(g, Call) and g.op == "date_format"
                and len(g.args) == 2 and isinstance(g.args[1], Lit)):
            raise PlanError(
                "only DATE_FORMAT group keys are supported for formatted "
                "strings; group on the underlying value instead")
        fmt = str(g.args[1].value)
        gran = monotone_granularity(fmt)
        if gran is None:
            raise PlanError(
                f"GROUP BY DATE_FORMAT({fmt!r}) is not monotone; use "
                f"%Y / %Y-%m / %Y-%m-%d style formats")
        d = g.args[0]
        if has_egress(d):
            raise PlanError("nested formatted strings in GROUP BY")
        new_group.append(_BUCKETS[gran](d))
        subst[g.key()] = Call("date_format",
                              (AggCall("min", (d,)), g.args[1]))

    def apply_subst(e: Expr) -> Expr:
        r = subst.get(e.key())
        if r is not None:
            return r
        if isinstance(e, Call):
            return Call(e.op, tuple(apply_subst(a) for a in e.args))
        if isinstance(e, AggCall):
            return AggCall(e.op, tuple(apply_subst(a) for a in e.args),
                           e.distinct)
        return e

    # WHERE: keep egress-free conjuncts, invert the rest
    parts = []
    for cj in _conjuncts(stmt.where):
        parts.append(rw.invert_conjunct(cj) if has_egress(cj) else cj)
    where = _and_all(parts)

    having = stmt.having
    if having is not None:
        having = apply_subst(having)
        if has_egress(having):
            raise PlanError("formatted strings in HAVING are not "
                            "supported; compare the underlying value")

    # SELECT list -> inner hidden items + skeletons
    spec = EgressSpec(limit=stmt.limit, offset=stmt.offset)
    for it in stmt.items:
        if it.expr is None or it.star_table is not None:
            raise PlanError("SELECT * cannot combine with formatted-"
                            "string outputs in this position")
        e = apply_subst(it.expr)
        spec.names.append(it.alias or _display_name(it.expr))
        if has_egress(e):
            spec.out.append(("expr", rw.skeletonize(e)))
        else:
            spec.out.append(("col", rw._hide(e).name))

    # ORDER BY: host sort when any key needs egress output
    host_sort = any(has_egress(apply_subst(o.expr)) for o in order_by)
    inner_order = []
    if host_sort:
        for o in order_by:
            e = apply_subst(o.expr)
            spec.order.append((rw.skeletonize(e) if has_egress(e)
                               else rw._hide(e), o.asc))
    else:
        for o in order_by:
            e = apply_subst(o.expr)
            if has_egress(e):       # unreachable, kept for clarity
                raise PlanError("formatted strings in ORDER BY")
            inner_order.append(OrderItem(rw._hide(e), o.asc))

    inner_items = [SelectItem(e, f"__c{i}")
                   for i, e in enumerate(rw.hidden)]
    inner = SelectStmt(
        items=inner_items, table=stmt.table, joins=stmt.joins,
        where=where, group_by=new_group, having=having,
        order_by=inner_order,
        limit=None if host_sort else stmt.limit,
        offset=0 if host_sort else stmt.offset,
        distinct=False, union=None, ctes=stmt.ctes)
    if not host_sort:
        spec.limit = None
        spec.offset = 0
    inner._egress_done = True
    return inner, spec


def finish(spec: EgressSpec, inner_result):
    """Evaluate the skeletons over the inner result and produce the final
    (names, row tuples)."""
    from ..obs import trace

    with trace.span("egress.host_eval",
                    rows=0 if inner_result.arrow is None
                    else inner_result.arrow.num_rows):
        return _finish(spec, inner_result)


def _finish(spec: EgressSpec, inner_result):
    table = inner_result.arrow
    envs = table.to_pylist() if table is not None else []
    rows = []
    for env in envs:
        vals = []
        for kind, ref in spec.out:
            vals.append(env[ref] if kind == "col" else eval_row(ref, env))
        rows.append((tuple(vals), env))
    if spec.order:
        rows = host_sort_rows(rows, spec.order)
    out = [v for v, _ in rows]
    if spec.offset:
        out = out[spec.offset:]
    if spec.limit is not None:
        out = out[:spec.limit]
    return spec.names, out


def host_sort_rows(rows: list, order: list) -> list:
    """MySQL ORDER BY over host rows ``[(vals, env), ...]``: stable
    per-key passes from the last key to the first, each key evaluated
    once per row (decorate-sort).  NULLs sort first ascending / last
    descending, like the device sort.  (``baikaldb_tpu/plan/fragment.py``'s
    ``host_sort_rows``.)"""
    for e, asc in reversed(order):
        keys = [eval_row(e, env) for _, env in rows]
        dec = sorted(zip(keys, rows),
                     key=lambda kv: ((0, 0) if kv[0] is None
                                     else (1, kv[0])),
                     reverse=not asc)
        rows = [r for _, r in dec]
    return rows
