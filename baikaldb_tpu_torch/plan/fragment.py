"""Pushed-down plan fragments for the daemon plane.

The reference's core read architecture ships serialized plan fragments to the
store processes and executes them there, so only qualifying rows (or partial
aggregates) cross the wire: Region::query dispatches a pb::Plan at
src/store/region.cpp:1680, select execution runs the fragment
against region data at region.cpp:2671/2925, and the contract lives in
proto/store.interface.proto:418.  Without it a frontend pulls ENTIRE
regions raw (rpc_scan_raw) and evaluates everything locally.

This module is the fragment contract shared by both sides:

- ``build_push_query(stmt, info)``: frontend-side extraction.  If a SELECT is
  a single-table scan+filter+projection(+aggregation) whose expressions all
  evaluate row-wise (expr/roweval), produce a ``PushQuery``: the JSON-safe
  fragment shipped to every region leader plus the merge recipe the frontend
  finishes with (final expressions over partials, HAVING, ORDER BY, LIMIT).
- ``run_fragment(rows, frag)``: store-side execution over decoded region rows
  (server/store_server.rpc_exec_fragment calls this).
- ``merge_push_results(push, payloads)``: frontend-side merge of per-region
  payloads into the final (columns, rows) result.

Anything not expressible falls back to the raw-scan + columnar-image path —
pushdown is an optimization with a full-fidelity fallback, exactly like the
reference keeps select_normal beside its vectorized path.

A copy of ``baikaldb_tpu/plan/fragment.py`` (host-only Python):
``frag_canonical`` / ``frag_wire_key`` give the JAX package's bytes and key
for the same SELECT, so a fragment body published by a frontend of either
package warm-starts on a daemon of the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..expr.ast import AggCall, Call, ColRef, Expr, Lit, Subquery, WindowCall
from ..expr.roweval import (RowEvalError, _num, eval_row, expr_from_wire,
                            expr_supported, expr_to_wire, truthy,
                            val_from_wire, val_to_wire)
from ..sql.stmt import SelectStmt

# store-side group cap: a pushed aggregation whose group count exceeds this
# answers with an error and the frontend falls back to the image path (the
# reference's store returns its agg rows unconditionally; we bound the JSON
# response instead)
GROUP_CAP = 1 << 16
# rows-mode cap when the statement itself has no LIMIT: a pushed filter that
# matches this many rows stops being a bandwidth win — fall back
ROW_CAP = 1 << 20

_PUSH_AGGS = frozenset({"count", "count_star", "sum", "min", "max", "avg"})


@dataclass
class PushQuery:
    """One pushable SELECT: the store fragment + the frontend finish."""

    frag: dict                       # JSON-safe fragment for the stores
    mode: str                        # "rows" | "agg"
    # final output: (display_name, expr over the fragment's output columns)
    items: list = field(default_factory=list)
    having: Optional[Expr] = None    # agg mode, over the same env
    order: list = field(default_factory=list)   # (expr-over-env, asc)
    limit: Optional[int] = None
    offset: int = 0
    key_names: list = field(default_factory=list)   # agg mode group keys
    agg_specs: list = field(default_factory=list)   # (kind, out_name)


class _NotPushable(Exception):
    pass


def _norm_colrefs(e: Expr, label: str, columns: set) -> Expr:
    """Strip table qualifiers that match this table's label; reject
    references to anything else."""
    if isinstance(e, ColRef):
        if e.table is not None and e.table != label:
            raise _NotPushable(f"foreign column {e!r}")
        name = e.name
        if name not in columns:
            raise _NotPushable(f"unknown column {name!r}")
        return ColRef(name)
    if isinstance(e, Lit):
        return e
    if isinstance(e, AggCall):
        return AggCall(e.op, tuple(_norm_colrefs(a, label, columns)
                                   for a in e.args), e.distinct)
    if isinstance(e, Call):
        return Call(e.op, tuple(_norm_colrefs(a, label, columns)
                                for a in e.args))
    raise _NotPushable(f"not pushable: {type(e).__name__}")


def _subst(e: Expr, mapping: dict) -> Expr:
    """Replace whole subexpressions by key() lookup (group keys, aggregates
    become synthetic column refs over the fragment's output env)."""
    r = mapping.get(e.key())
    if r is not None:
        return r
    if isinstance(e, (ColRef, Lit)):
        return e
    if isinstance(e, AggCall):
        raise _NotPushable(f"aggregate {e!r} not extracted")
    if isinstance(e, Call):
        return Call(e.op, tuple(_subst(a, mapping) for a in e.args))
    raise _NotPushable(f"not pushable: {type(e).__name__}")


def _has_bad_nodes(e: Optional[Expr]) -> bool:
    if e is None:
        return False
    if isinstance(e, (Subquery, WindowCall)):
        return True
    return any(_has_bad_nodes(a) for a in getattr(e, "args", ())
               ) or any(_has_bad_nodes(a)
                        for a in getattr(e, "partition_by", ()))


def _display_name(e: Expr) -> str:
    if isinstance(e, ColRef):
        return e.name.split(".")[-1] if e.table is None else e.name
    return repr(e)


def build_push_query(stmt: SelectStmt, info) -> Optional[PushQuery]:
    """Extract a pushable fragment from ``stmt`` over table ``info``;
    None when the statement needs the full planner."""
    try:
        return _build(stmt, info)
    except (_NotPushable, RowEvalError):
        return None


def _build(stmt: SelectStmt, info) -> Optional[PushQuery]:
    if (stmt.joins or stmt.ctes or stmt.union is not None or stmt.distinct
            or stmt.into_outfile is not None or stmt.having is not None
            and not stmt.group_by and not _stmt_has_aggs(stmt)):
        return None
    t = stmt.table
    if t is None or t.subquery is not None:
        return None
    label = t.label
    columns = {f.name for f in info.schema.fields}
    all_exprs = ([it.expr for it in stmt.items if it.expr is not None]
                 + [stmt.where, stmt.having]
                 + list(stmt.group_by)
                 + [o.expr for o in stmt.order_by])
    if any(_has_bad_nodes(e) for e in all_exprs):
        return None

    # expand stars
    items: list[tuple[str, Expr]] = []
    for it in stmt.items:
        if it.expr is None or it.star_table is not None:
            if it.star_table is not None and it.star_table != label:
                return None
            for f in info.schema.fields:
                if f.name.startswith("__"):
                    continue          # hidden (vector component) columns
                items.append((f.name, ColRef(f.name)))
            continue
        e = _norm_colrefs(it.expr, label, columns)
        items.append((it.alias or _display_name(it.expr), e))

    where = _norm_colrefs(stmt.where, label, columns) \
        if stmt.where is not None else None
    if where is not None and not expr_supported(where):
        return None

    has_aggs = bool(stmt.group_by) or any(
        _contains_agg(e) for _, e in items) or (
        stmt.having is not None and _contains_agg(
            _norm_colrefs(stmt.having, label, columns)))
    if not has_aggs and stmt.having is not None:
        return None

    if not has_aggs:
        return _build_rows(stmt, label, columns, items, where)
    return _build_agg(stmt, label, columns, items, where)


def _contains_agg(e: Expr) -> bool:
    if isinstance(e, AggCall):
        return True
    return any(_contains_agg(a) for a in getattr(e, "args", ()))


def _build_rows(stmt, label, columns, items, where) -> Optional[PushQuery]:
    # fragment outputs carry GENERATED internal names ("o<i>"): duplicate
    # user aliases (SELECT id, v AS id) and aliases that collide with the
    # hidden sort outputs can never corrupt the merge env
    outputs: list[tuple[str, Expr]] = []
    for i, (name, e) in enumerate(items):
        if not expr_supported(e):
            raise _NotPushable(f"item {e!r}")
        outputs.append((f"o{i}", e))
    alias_internal: dict[str, str] = {}
    for i, (name, _) in enumerate(items):
        alias_internal.setdefault(name, f"o{i}")
    order: list[tuple[Expr, bool]] = []
    hidden = 0
    for o in stmt.order_by:
        oe = o.expr
        # ORDER BY <int literal> is a 1-based output ordinal (the image
        # planner resolves it the same way, plan/planner.py ordinal rule)
        if isinstance(oe, Lit) and isinstance(oe.value, int) \
                and not isinstance(oe.value, bool):
            if not 1 <= oe.value <= len(items):
                raise _NotPushable(f"ORDER BY ordinal {oe.value}")
            order.append((ColRef(f"o{oe.value - 1}"), o.asc))
            continue
        # ORDER BY alias / bare output column -> sort on that output
        if isinstance(oe, ColRef) and oe.table is None \
                and oe.name in alias_internal:
            order.append((ColRef(alias_internal[oe.name]), o.asc))
            continue
        oe = _norm_colrefs(oe, label, columns)
        if not expr_supported(oe):
            raise _NotPushable(f"order {oe!r}")
        hn = f"oh{hidden}"
        hidden += 1
        outputs.append((hn, oe))
        order.append((ColRef(hn), o.asc))
    push_limit = None
    if stmt.limit is not None and not order:
        push_limit = stmt.limit + stmt.offset
    frag = {"v": 1, "mode": "rows",
            "filter": expr_to_wire(where) if where is not None else None,
            "outputs": [[n, expr_to_wire(e)] for n, e in outputs],
            "limit": push_limit}
    return PushQuery(frag=frag, mode="rows",
                     items=[(name, ColRef(f"o{i}"))
                            for i, (name, _) in enumerate(items)],
                     order=order, limit=stmt.limit, offset=stmt.offset)


def _build_agg(stmt, label, columns, items, where) -> Optional[PushQuery]:
    mapping: dict = {}
    keys: list[tuple[str, Expr]] = []
    for j, g in enumerate(stmt.group_by):
        ge = _norm_colrefs(g, label, columns)
        if not expr_supported(ge):
            raise _NotPushable(f"group key {ge!r}")
        kn = f"__k{j}"
        keys.append((kn, ge))
        mapping[ge.key()] = ColRef(kn)
        # unqualified references to the same column also hit the key
        if isinstance(ge, ColRef):
            mapping[ColRef(ge.name, label).key()] = ColRef(kn)

    aggs: list[tuple[str, Optional[Expr], str]] = []   # kind, arg, out

    def _extract_aggs(e: Expr) -> Expr:
        if e.key() in mapping:
            return mapping[e.key()]
        if isinstance(e, AggCall):
            if e.distinct or e.op not in _PUSH_AGGS:
                raise _NotPushable(f"aggregate {e!r}")
            if e.op == "count_star" or not e.args:
                kind, arg = "count_star", None
            else:
                if len(e.args) != 1:
                    raise _NotPushable(f"aggregate {e!r}")
                kind = e.op
                arg = _norm_colrefs(e.args[0], label, columns)
                if not expr_supported(arg):
                    raise _NotPushable(f"agg arg {arg!r}")
            if kind == "avg":
                s = _add_agg("sum", arg, aggs, mapping, e)
                c = _add_agg("count", arg, aggs, mapping, None)
                out = Call("div", (s, c))
                mapping[e.key()] = out
                return out
            ref = _add_agg(kind, arg, aggs, mapping, e)
            return ref
        if isinstance(e, (ColRef, Lit)):
            if isinstance(e, ColRef):
                # a bare column that is not a group key: MySQL-permissive
                # semantics (any value) — the image path handles it; we
                # refuse rather than guess
                raise _NotPushable(f"non-grouped column {e!r}")
            return e
        if isinstance(e, Call):
            return Call(e.op, tuple(_extract_aggs(a) for a in e.args))
        raise _NotPushable(f"not pushable: {type(e).__name__}")

    final_items: list[tuple[str, Expr]] = []
    for name, e in items:
        final_items.append((name, _extract_aggs(e)))
    having = None
    if stmt.having is not None:
        having = _extract_aggs(_norm_colrefs(stmt.having, label, columns))
        if not expr_supported(having):
            raise _NotPushable(f"having {having!r}")
    alias_expr: dict[str, Expr] = {}
    for name, fe in final_items:
        alias_expr.setdefault(name, fe)
    order: list[tuple[Expr, bool]] = []
    for o in stmt.order_by:
        oe = o.expr
        if isinstance(oe, Lit) and isinstance(oe.value, int) \
                and not isinstance(oe.value, bool):
            if not 1 <= oe.value <= len(final_items):
                raise _NotPushable(f"ORDER BY ordinal {oe.value}")
            order.append((final_items[oe.value - 1][1], o.asc))
            continue
        # ORDER BY alias -> the aliased item's expression over the env
        if isinstance(oe, ColRef) and oe.table is None \
                and oe.name in alias_expr:
            order.append((alias_expr[oe.name], o.asc))
            continue
        oe = _extract_aggs(_norm_colrefs(oe, label, columns))
        if not expr_supported(oe):
            raise _NotPushable(f"order {oe!r}")
        order.append((oe, o.asc))
    for _, e in final_items:
        if not expr_supported(e):
            raise _NotPushable(f"final item {e!r}")
    frag = {"v": 1, "mode": "agg",
            "filter": expr_to_wire(where) if where is not None else None,
            "keys": [[n, expr_to_wire(e)] for n, e in keys],
            "aggs": [[kind,
                      expr_to_wire(arg) if arg is not None else None,
                      out]
                     for kind, arg, out in aggs],
            "group_cap": GROUP_CAP}
    return PushQuery(frag=frag, mode="agg", items=final_items,
                     having=having, order=order,
                     limit=stmt.limit, offset=stmt.offset,
                     key_names=[n for n, _ in keys],
                     agg_specs=[(kind, out) for kind, _a, out in aggs])


def _add_agg(kind, arg, aggs, mapping, orig) -> ColRef:
    """Register a partial aggregate (deduplicated) and return its env ref."""
    akey = (kind, arg.key() if arg is not None else None)
    for k2, a2, out in aggs:
        if (k2, a2.key() if a2 is not None else None) == akey:
            ref = ColRef(out)
            if orig is not None:
                mapping[orig.key()] = ref
            return ref
    out = f"__a{len(aggs)}"
    aggs.append((kind, arg, out))
    ref = ColRef(out)
    if orig is not None:
        mapping[orig.key()] = ref
    return ref


def _stmt_has_aggs(stmt: SelectStmt) -> bool:
    return any(it.expr is not None and _contains_agg(it.expr)
               for it in stmt.items)


# -- store side -------------------------------------------------------------

class FragmentProgram:
    """One fragment parsed ONCE into evaluator closures — the daemon-side
    executable.  Store daemons cache these by content hash (the AOT key
    riding each FragmentSpec), so a re-dispatch of a published fragment
    skips the wire -> AST build entirely and ``fragment_warm_compiles``
    stays pinned at 0.  ``run`` is reentrant: no state survives a call."""

    __slots__ = ("mode", "filter", "outputs", "limit", "keys", "aggs",
                 "cap")

    def __init__(self, frag: dict):
        self.mode = frag.get("mode")
        self.filter = expr_from_wire(frag["filter"]) \
            if frag.get("filter") is not None else None
        if self.mode == "rows":
            self.outputs = [(n, expr_from_wire(w))
                            for n, w in frag["outputs"]]
            self.limit = frag.get("limit")
            self.keys, self.aggs, self.cap = [], [], 0
            return
        if self.mode != "agg":
            raise RowEvalError(f"bad fragment mode {self.mode!r}")
        self.outputs, self.limit = [], None
        self.keys = [(n, expr_from_wire(w)) for n, w in frag["keys"]]
        self.aggs = [(kind, expr_from_wire(w) if w is not None else None,
                      out)
                     for kind, w, out in frag["aggs"]]
        self.cap = int(frag.get("group_cap") or GROUP_CAP)

    def run(self, rows) -> dict:
        """Execute over decoded region rows (deleted rows already
        excluded).  Returns a JSON-safe payload: rows mode ->
        {"mode": "rows", "rows": [[v, ...], ...], "scanned": n}; agg mode
        -> {"mode": "agg", "groups": [[[kv, ...], [partial, ...]], ...],
        "scanned": n}.  Raises RowEvalError on unsupported expressions or
        cap overflow (the RPC layer turns that into an error response;
        the frontend falls back)."""
        filt = self.filter
        scanned = 0
        if self.mode == "rows":
            out = []
            for row in rows:
                scanned += 1
                if filt is not None and not truthy(eval_row(filt, row)):
                    continue
                if len(out) >= ROW_CAP:
                    # abort BEFORE materializing an unbounded result: past
                    # this size the raw-pull fallback is the better
                    # transfer anyway
                    raise RowEvalError("pushed fragment row cap exceeded")
                out.append([val_to_wire(eval_row(e, row))
                            for _, e in self.outputs])
                if self.limit is not None and len(out) >= self.limit:
                    break
            return {"mode": "rows", "rows": out, "scanned": scanned}
        groups: dict = {}
        for row in rows:
            scanned += 1
            if filt is not None and not truthy(eval_row(filt, row)):
                continue
            kv = tuple(eval_row(e, row) for _, e in self.keys)
            g = groups.get(kv)
            if g is None:
                if len(groups) >= self.cap:
                    raise RowEvalError(
                        "pushed fragment group cap exceeded")
                g = groups[kv] = [_init_partial(kind)
                                  for kind, _, _ in self.aggs]
            for i, (kind, arg, _) in enumerate(self.aggs):
                g[i] = _step_partial(kind, g[i],
                                     eval_row(arg, row)
                                     if arg is not None else None)
        return {"mode": "agg",
                "groups": [[[val_to_wire(v) for v in kv],
                            [val_to_wire(p) for p in g]]
                           for kv, g in groups.items()],
                "scanned": scanned}


def frag_canonical(frag: dict) -> bytes:
    """The ONE canonical wire encoding of a fragment body (sorted-key
    JSON): publisher, content hash, and daemon blob store must all agree
    byte-for-byte or the artifact ladder silently misses."""
    import json as _json

    return _json.dumps(frag, sort_keys=True).encode()


def frag_wire_key(frag: dict) -> str:
    """Content hash of a fragment body — the AOT-style artifact key a
    FragmentSpec ships INSTEAD of the body.  Daemons resolve it down the
    warm ladder (program cache -> frag blob tier -> peer store); equal
    fragments from any frontend share one key, so a re-dispatch never
    re-ships or re-parses the plan."""
    import hashlib

    return hashlib.sha256(frag_canonical(frag)).hexdigest()[:24]


def compile_fragment(frag: dict) -> FragmentProgram:
    """Build the daemon-side executable for one wire fragment."""
    return FragmentProgram(frag)


def run_fragment(rows, frag: dict) -> dict:
    """One-shot compile + execute (the pre-fragment_execute RPC path and
    any caller without a program cache)."""
    return FragmentProgram(frag).run(rows)


def _init_partial(kind: str):
    if kind in ("count", "count_star"):
        return 0
    return None            # sum/min/max start undefined (all-NULL -> NULL)


def _step_partial(kind: str, acc, v):
    if kind == "count_star":
        return acc + 1
    if kind == "count":
        return acc + (0 if v is None else 1)
    if v is None:
        return acc
    if kind == "sum":
        # SUM coerces numerically (the device lowering casts string columns
        # to float64) — Python's str + str would concatenate instead
        v = _num(v)
        return v if acc is None else acc + v
    if acc is None:
        return v
    if kind == "min":
        return min(acc, v)
    if kind == "max":
        return max(acc, v)
    raise RowEvalError(f"bad agg kind {kind!r}")


def merge_partial(kind: str, a, b):
    """Combine two region partials (frontend side) under the SAME
    sum-of-sums / min / max discipline the device merge applies to
    partial columns (parallel/agg.py merge_partial_agg_specs) — one merge
    truth for wire partials and mesh partials.  Imported lazily: this
    module also runs inside store daemons, which need no device stack."""
    from ..parallel.agg import merge_host_partial

    try:
        return merge_host_partial(kind, a, b)
    except KeyError:
        raise RowEvalError(f"bad agg kind {kind!r}") from None


def host_sort_rows(rows: list, order: list) -> list:
    """MySQL ORDER BY over host rows ``[(vals, env), ...]``: stable
    per-key passes from the last key to the first, each key evaluated
    ONCE per row (decorate-sort) — never O(n log n) interpreter calls.
    NULLs sort first ascending / last descending, like the device sort."""
    for e, asc in reversed(order):
        keys = [eval_row(e, env) for _, env in rows]
        dec = sorted(zip(keys, rows),
                     key=lambda kv: ((0, 0) if kv[0] is None
                                     else (1, kv[0])),
                     reverse=not asc)
        rows = [r for _, r in dec]
    return rows


# -- frontend merge ---------------------------------------------------------

def merge_push_results(push: PushQuery,
                       payloads: list[dict]) -> tuple[list, list]:
    """Merge per-region payloads into the final (column_names, row_tuples).
    Applies final expressions, HAVING, ORDER BY, OFFSET/LIMIT."""
    names = [n for n, _ in push.items]
    if push.mode == "rows":
        out_names = [n for n, _ in push.frag["outputs"]]
        envs = []
        for p in payloads:
            if p.get("mode") != "rows":
                raise RowEvalError("mode mismatch across regions")
            for r in p["rows"]:
                envs.append({n: val_from_wire(v)
                             for n, v in zip(out_names, r)})
    else:
        merged: dict = {}
        kinds = {out: kind for kind, out in push.agg_specs}
        for p in payloads:
            if p.get("mode") != "agg":
                raise RowEvalError("mode mismatch across regions")
            for kv, partials in p["groups"]:
                kt = tuple(val_from_wire(v) for v in kv)
                cur = merged.get(kt)
                dec = [val_from_wire(v) for v in partials]
                if cur is None:
                    merged[kt] = dec
                else:
                    merged[kt] = [
                        merge_partial(kinds[out], a, b)
                        for (a, b, out)
                        in zip(cur, dec,
                               [out for _k, out in push.agg_specs])]
        if not push.key_names and not merged:
            # scalar aggregation over zero rows still yields one row
            merged[()] = [_init_partial(kind)
                          for kind, _ in push.agg_specs]
        envs = []
        for kt, partials in merged.items():
            env = dict(zip(push.key_names, kt))
            env.update({out: v for (_k, out), v in
                        zip(push.agg_specs, partials)})
            envs.append(env)
        if push.having is not None:
            envs = [env for env in envs
                    if truthy(eval_row(push.having, env))]
    # final projection
    out_rows = []
    for env in envs:
        vals = tuple(eval_row(e, env) for _, e in push.items)
        out_rows.append((vals, env))
    if push.order:
        # order expressions are resolved to env columns at build time
        # (internal output names / group keys / agg partials), so the
        # env alone is the sort input — display names never enter it
        out_rows = host_sort_rows(out_rows, push.order)
    rows = [v for v, _ in out_rows]
    if push.offset:
        rows = rows[push.offset:]
    if push.limit is not None:
        rows = rows[:push.limit]
    return names, rows
