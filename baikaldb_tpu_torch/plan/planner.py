"""Query planner: bind SELECT AST -> plan IR -> optimization passes.

Mirrors the reference's two stages, collapsed: logical planning
(src/logical_plan/select_planner.cpp — Packet->Sort->Agg->Filter->Join/Scan
tree) and the physical pass pipeline
(src/physical_plan/physical_planner.cpp:27-120 — ColumnsPrune,
PredicatePushDown, ExprOptimize, JoinTypeAnalyzer, ...).  The passes kept
here are the ones that matter on an accelerator:

- **predicate pushdown** into scans (filters fuse into the scan kernel),
- **column pruning** (HBM traffic is the bottleneck; never move dead columns),
- **aggregate extraction** with the dense-vs-sorted group-by strategy choice
  (dictionary/small-int keys -> segment_sum over a dense domain),
- **join key extraction** (equi conjuncts -> sort-join keys, rest residual),
- **sort+limit fusion** into top-k.
"""

from __future__ import annotations

import itertools
from dataclasses import replace as dreplace
from typing import Optional

import numpy as np

from ..expr.ast import AggCall, Call, ColRef, Expr, Lit, Subquery, WindowCall, walk
from ..errors import NotPortedError
from ..expr.compile import infer_type
from ..meta.catalog import Catalog
from ..ops.hashagg import AggSpec, agg_result_type
from ..sql.lexer import SqlError
from ..sql.stmt import JoinClause, SelectStmt, TableRef
from ..types import Field, LType, Schema
from ..utils import metrics
from ..utils.flags import FLAGS, define

define("eqclass_pushdown", True,
       "equality-class constant propagation in predicate pushdown: "
       "a.k = b.k AND b.k = 5 pushes a.k = 5 into a's scan too, so "
       "zonemap/index pruning fires on both join sides (off: constants "
       "reach only their own table)")

define("dense_join_span_max", 1 << 24,
       "dense PK-FK join: max key-domain span for the position-table "
       "strategy (memory: 4 bytes/slot); larger domains use the sort join")
from .nodes import (AggNode, DistinctNode, FilterNode, JoinNode, LimitNode,
                    MembershipNode, PlanNode, ProjectNode, ScalarSourceNode,
                    ScanNode, SortNode, UnionNode, ValuesNode, WindowNode)

define("dense_group_domain_max", 1 << 23,
       "dense group-by: max product of key domains for segment-sum "
       "aggregation (accumulators are domain-sized: 8 bytes/slot/agg); "
       "larger domains use the sorted strategy")


class PlanError(SqlError):
    pass


class Scope:
    """Name resolution for one SELECT level: label -> (table schema, columns)."""

    def __init__(self):
        self.tables: dict[str, Schema] = {}   # label -> schema (plain col names)
        self.order: list[str] = []
        self.extras: dict[str, LType] = {}    # injected columns (subqueries)
        # vector columns: "label.name" -> (dim, ["label.__name_0", ...]);
        # distance functions expand over the components (plan/planner.py
        # _Resolver) so ANN fuses into the query program
        self.vector_cols: dict[str, tuple[int, list[str]]] = {}

    def add(self, label: str, schema: Schema):
        if label in self.tables:
            raise PlanError(f"duplicate table alias {label!r}")
        self.tables[label] = schema
        self.order.append(label)

    def resolve(self, name: str, table: Optional[str]) -> tuple[str, LType]:
        """-> (qualified unique column name, type)."""
        if table is not None:
            if table not in self.tables:
                raise PlanError(f"unknown table {table!r}")
            sch = self.tables[table]
            if name not in sch:
                raise PlanError(f"unknown column {table}.{name}")
            return f"{table}.{name}", sch.field(name).ltype
        if name in self.extras:
            return name, self.extras[name]
        hits = [(lbl, self.tables[lbl]) for lbl in self.order if name in self.tables[lbl]]
        if not hits:
            raise PlanError(f"unknown column {name!r}")
        if len(hits) > 1:
            raise PlanError(f"ambiguous column {name!r}")
        lbl, sch = hits[0]
        return f"{lbl}.{name}", sch.field(name).ltype

    def flat_schema(self) -> Schema:
        fields = []
        for lbl in self.order:
            for f in self.tables[lbl].fields:
                fields.append(Field(f"{lbl}.{f.name}", f.ltype, f.nullable))
        return Schema(tuple(fields))


class Planner:
    def __init__(self, catalog: Catalog, stores: dict, default_db: str,
                 stats_fn=None):
        self.catalog = catalog
        self.stores = stores          # "db.table" -> TableStore
        self.default_db = default_db
        self.stats_fn = stats_fn      # (table_key, col) -> dict | None
        self._ids = itertools.count()
        self._generated: list[str] = []   # every _tmp name, in order
        self._ctes: dict[str, SelectStmt] = {}

    def _tmp(self, prefix: str) -> str:
        name = f"__{prefix}{next(self._ids)}"
        self._generated.append(name)
        return name

    # ------------------------------------------------------------------
    def plan_select(self, stmt: SelectStmt) -> PlanNode:
        from ..obs import trace

        with trace.span("plan.logical"):
            plan = self._plan_query(stmt)
            self._prune_columns(plan)
            plan = self._insert_shrinks(plan)
            self._mark_sorted_builds(plan)
            return plan

    def _mark_sorted_builds(self, plan: PlanNode) -> None:
        """Sort-join build sides that are the output of a SORTED group-by on
        exactly the join keys arrive already key-sorted (interesting-order
        reuse): the join kernel's lexsort degrades to an O(n) deadness
        partition.  Conditions: every right key traces through rename-only
        Projects to the agg's key_names IN ORDER; integer keys only (string
        codes remap at dictionary merge); for composite keys, non-negative
        domains (32-bit packing must preserve the lexicographic order)."""
        def trace(node: PlanNode, names: list[str]):
            """Follow rename-only projections down; -> (node, names)."""
            while isinstance(node, ProjectNode):
                mapped = []
                for n in names:
                    try:
                        i = node.names.index(n)
                    except ValueError:
                        return None
                    e = node.exprs[i]
                    if not isinstance(e, ColRef):
                        return None
                    mapped.append(e.name)
                names = mapped
                node = node.children[0]
            return node, names

        def walk(n: PlanNode) -> None:
            for c in n.children:
                walk(c)
            if not (isinstance(n, JoinNode) and n.strategy != "dense"
                    and n.how in ("inner", "left", "semi", "anti")
                    and n.right_keys and not n.build_sorted):
                return
            hit = trace(n.children[1], list(n.right_keys))
            if hit is None:
                return
            node, names = hit
            if len(names) == 1 and n.presort is None and n.neq is None \
                    and self._position_preserving(n.children[1]):
                # single-key build over a position-preserving base-table
                # chain: the executor can feed the host-precomputed
                # per-version sort permutation (q13's orders build —
                # lexsort of 300k keys per execution becomes an O(n)
                # deadness partition).  Integer keys only: string codes
                # remap at dictionary merges.
                f0 = n.children[1].schema.field(n.right_keys[0])
                hk = self._key_scan(n.children[1], n.right_keys[0])
                # no UINT64: the host permutation casts to int64, so values
                # past 2^63 would wrap and disagree with the device's
                # unsigned key order
                if hk is not None and len(hk) == 2 and \
                        f0.ltype is not LType.UINT64 and \
                        (f0.ltype.is_integer or f0.ltype is LType.DATE):
                    n.presort = ("join", hk[0], (hk[1],))
            # BOTH group-by strategies emit key-ordered outputs: sorted by
            # the key sort itself, dense by domain-order slot layout
            if not (isinstance(node, AggNode) and
                    node.strategy in ("sorted", "dense")
                    and list(node.key_names) == names):
                return
            for kn in names:
                f = node.schema.field(kn)
                if not (f.ltype.is_integer or f.ltype is LType.DATE):
                    return
            if len(names) > 1:
                # packed order == lex order only when later keys never go
                # negative; prove it from statistics
                for kn in names[1:]:
                    st = self._key_stats(node, kn)
                    if not st or st.get("min") is None or int(st["min"]) < 0:
                        return
            n.build_sorted = True

        walk(plan)

    def _insert_shrinks(self, plan: PlanNode) -> PlanNode:
        """Adaptive capacity cuts (ops/compact.shrink): a selective probe
        subtree otherwise drags the base table's full capacity through every
        operator above it — each a capacity-proportional gather/searchsorted
        (the q21 profile: 10k live rows riding 1.2M-lane kernels).  Insert a
        Shrink (a) under the probe side of semi/anti and sort joins when
        that side has already been filtered by a join, and (b) above the
        topmost semi/anti join feeding non-join operators.  Never on a
        build side — that would break the host-presort position contract
        (_position_preserving)."""
        from .nodes import ShrinkNode

        def selective(n: PlanNode) -> bool:
            if isinstance(n, JoinNode):
                return True
            return any(selective(c) for c in n.children)

        def walk(n: PlanNode, parent) -> None:
            if isinstance(n, JoinNode) and n.how in ("semi", "anti") or \
                    (isinstance(n, JoinNode) and n.strategy != "dense"
                     and n.how in ("inner", "left")):
                probe = n.children[0]
                if not isinstance(probe, ShrinkNode) and selective(probe):
                    n.children[0] = ShrinkNode(children=[probe],
                                               schema=probe.schema)
            if isinstance(parent, (FilterNode, ProjectNode, AggNode,
                                   SortNode)) and isinstance(n, JoinNode) \
                    and n.how in ("semi", "anti") and selective(n):
                i = parent.children.index(n)
                parent.children[i] = ShrinkNode(children=[n],
                                                schema=n.schema)
            # (c) group-by / sort / distinct over a join-filtered chain:
            # the multi-key device sort otherwise runs at the base table's
            # capacity (q16: 160k lanes for 23k live rows).  Joins in the
            # chain already rule out the host-presort position contract.
            # Skip when the chain bottoms out at a semi/anti join — rule
            # (b) shrinks that one, and a second cut would just re-compact.
            def chain_end(x: PlanNode) -> PlanNode:
                while isinstance(x, (FilterNode, ProjectNode,
                                     MembershipNode)) and x.children:
                    x = x.children[0]
                return x

            if isinstance(n, (AggNode, SortNode, DistinctNode)) and \
                    n.children:
                child = n.children[0]
                end = chain_end(child)
                covered = isinstance(end, ShrinkNode) or \
                    (isinstance(end, JoinNode) and
                     end.how in ("semi", "anti"))
                if not isinstance(child, (ShrinkNode, JoinNode)) and \
                        not covered and selective(child):
                    n.children[0] = ShrinkNode(children=[child],
                                               schema=child.schema)
            for c in list(n.children):
                walk(c, n)

        root = PlanNode(children=[plan])
        walk(plan, root)
        return root.children[0]

    def _plan_query(self, stmt: SelectStmt) -> PlanNode:
        # WITH scopes over the WHOLE statement including every union arm
        if stmt.ctes:
            saved = self._ctes
            self._ctes = dict(saved)
            for name, sub in stmt.ctes:
                self._ctes[name] = sub
            try:
                inner = copy_stmt_without_ctes(stmt)
                return self._plan_query(inner)
            finally:
                self._ctes = saved
        if stmt.union is None:
            return self._plan_single(stmt)
        # union chain: plan every arm bare, then ORDER BY/LIMIT of the head
        # stmt apply to the WHOLE union (MySQL semantics)
        mode, rhs = stmt.union
        left = self._plan_single(dreplace_union(stmt))
        right = self._plan_union_arm(rhs)
        plan = self._merge_union(left, right, mode)
        if rhs.union is not None:
            # chain continues: fold remaining arms left-associatively
            node = rhs.union
            while node is not None:
                m, arm = node
                plan = self._merge_union(plan, self._plan_single(
                    dreplace_union(arm)), m)
                node = arm.union
        return self._apply_union_tail(plan, stmt)

    def _plan_union_arm(self, stmt: SelectStmt) -> PlanNode:
        return self._plan_single(dreplace_union(stmt))

    def _merge_union(self, left: PlanNode, right: PlanNode, mode: str) -> PlanNode:
        if len(left.schema.fields) != len(right.schema.fields):
            raise PlanError("UNION arms have different column counts")
        right = ProjectNode(children=[right],
                            exprs=[ColRef(f.name) for f in right.schema.fields],
                            names=[f.name for f in left.schema.fields],
                            schema=left.schema)
        u = UnionNode(children=[left, right], all=(mode == "all"),
                      schema=left.schema)
        if mode != "all":
            return DistinctNode(children=[u], schema=left.schema)
        return u

    def _apply_union_tail(self, plan: PlanNode, stmt: SelectStmt) -> PlanNode:
        """ORDER BY (output names/ordinals only) + LIMIT over a union result."""
        names = [f.name for f in plan.schema.fields]
        keys: list[tuple[str, bool]] = []
        for o in stmt.order_by:
            e = o.expr
            if isinstance(e, Lit) and isinstance(e.value, int):
                idx = e.value - 1
                if not 0 <= idx < len(names):
                    raise PlanError(f"ORDER BY position {e.value} out of range")
                keys.append((names[idx], o.asc))
            elif isinstance(e, ColRef) and e.table is None and e.name in names:
                keys.append((e.name, o.asc))
            else:
                raise PlanError("ORDER BY over a UNION must use output column "
                                "names or ordinals")
        if keys:
            plan = SortNode(children=[plan], keys=keys, limit=stmt.limit,
                            offset=stmt.offset if stmt.limit is not None else 0,
                            schema=plan.schema)
        elif stmt.limit is not None:
            plan = LimitNode(children=[plan], limit=stmt.limit,
                             offset=stmt.offset, schema=plan.schema)
        return plan

    # ------------------------------------------------------------------
    def _plan_single(self, stmt: SelectStmt) -> PlanNode:
        scope = Scope()
        plan: Optional[PlanNode] = None

        # FROM clause
        if stmt.table is not None:
            self._reorder_comma_joins(stmt)
            plan = self._plan_table_ref(stmt.table, scope)
            for j in stmt.joins:
                plan = self._plan_join(plan, j, scope, stmt)
        flat = scope.flat_schema() if plan is not None else Schema(())

        if plan is None:
            # SELECT without FROM: single-row values
            names, exprs = [], []
            for i, item in enumerate(stmt.items):
                if item.expr is None:
                    raise PlanError("SELECT * without FROM")
                names.append(item.alias or f"_c{i}")
                exprs.append(item.expr)
            sch = Schema(tuple(Field(n, infer_type(e, Schema(())))
                               for n, e in zip(names, exprs)))
            return ValuesNode(rows=[[None]], names=names, exprs=[exprs], schema=sch)

        resolve = _Resolver(scope)

        # subqueries (reference: ApplyNode + DeCorrelate pass): IN/EXISTS
        # conjuncts become semi/anti joins; scalar subqueries become broadcast
        # columns injected by a ScalarSourceNode
        holder = [plan]
        where_ast: Optional[Expr] = None
        if stmt.where is not None:
            for c in _conjuncts(stmt.where):
                if self._try_subquery_conjunct(c, holder, scope, resolve):
                    continue
                c = self._subst_scalar(c, holder, scope)
                where_ast = c if where_ast is None else Call("and", (where_ast, c))
        sub_items = [self._subst_scalar(item.expr, holder, scope)
                     if item.expr is not None else None for item in stmt.items]
        # HAVING subqueries substitute AFTER aggregation (_plan_aggregate):
        # a pre-agg broadcast column could not survive the group-by
        sub_having = stmt.having
        plan = holder[0]

        # WHERE
        where = resolve(where_ast) if where_ast is not None else None
        if where is not None:
            plan = self._push_predicates(plan, where, stmt)

        # expand select items
        items: list[tuple[str, Expr]] = []
        for i, item in enumerate(stmt.items):
            if item.expr is None:
                # SELECT * follows the WRITTEN from-order, not the
                # cost-reordered plan order (positional clients depend on
                # stable columns; the reorder must be invisible)
                written = getattr(stmt, "from_written", None)
                labels = [item.star_table] if item.star_table else \
                    (written or scope.order)
                for lbl in labels:
                    if lbl not in scope.tables:
                        raise PlanError(f"unknown table {lbl!r} in {lbl}.*")
                    for f in scope.tables[lbl].fields:
                        if f.name.startswith("__"):
                            continue   # hidden columns (vector components)
                        # multi-table *: qualify clashing display names
                        items.append((f.name if len(labels) == 1 else f"{lbl}.{f.name}",
                                      ColRef(f"{lbl}.{f.name}")))
            else:
                e = resolve(sub_items[i])
                items.append((item.alias or _display_name(item.expr), e))
        # de-duplicate display names
        seen: dict[str, int] = {}
        named_items = []
        for n, e in items:
            if n in seen:
                seen[n] += 1
                n = f"{n}_{seen[n]}"
            else:
                seen[n] = 0
            named_items.append((n, e))

        # MySQL scoping: GROUP BY / HAVING / ORDER BY may reference select
        # aliases (reference: logical_planner name resolution); aliases map to
        # the scalar-substituted exprs so Subquery nodes never resurface
        alias_map = {item.alias: se for item, se in zip(stmt.items, sub_items)
                     if item.alias and se is not None}

        def subst_alias(e: Optional[Expr]) -> Optional[Expr]:
            if e is None:
                return None
            if isinstance(e, ColRef) and e.table is None and e.name in alias_map:
                # real columns shadow aliases (MySQL resolution order)
                try:
                    scope.resolve(e.name, None)
                    return e
                except PlanError:
                    return alias_map[e.name]
            if isinstance(e, AggCall):
                return AggCall(e.op, tuple(subst_alias(a) for a in e.args), e.distinct)
            if isinstance(e, WindowCall):
                return WindowCall(e.op, tuple(subst_alias(a) for a in e.args),
                                  tuple(subst_alias(a) for a in e.partition_by),
                                  tuple((subst_alias(x), asc) for x, asc in e.order_by),
                                  e.running, e.frame)
            if isinstance(e, Call):
                return Call(e.op, tuple(subst_alias(a) for a in e.args))
            return e

        group_exprs = [resolve(subst_alias(g)) for g in stmt.group_by]
        # GROUP BY ordinal / alias support
        for gi, g in enumerate(group_exprs):
            if isinstance(g, Lit) and isinstance(g.value, int):
                idx = g.value - 1
                if not 0 <= idx < len(named_items):
                    raise PlanError(f"GROUP BY position {g.value} out of range")
                group_exprs[gi] = named_items[idx][1]
        having = resolve(subst_alias(sub_having)) if sub_having is not None else None
        for o in stmt.order_by:
            if any(isinstance(x, Subquery) for x in walk(o.expr)):
                raise PlanError("subqueries in ORDER BY are not supported")
        order_items = [(resolve(subst_alias(o.expr)), o.asc) for o in stmt.order_by]

        has_agg = (any(_contains_agg(e) for _, e in named_items)
                   or group_exprs or (having is not None and _contains_agg(having))
                   or any(_contains_agg(e) for e, _ in order_items))

        if has_agg:
            plan, named_items, having, order_items = self._plan_aggregate(
                plan, flat, named_items, group_exprs, having, order_items,
                stmt, scope)
        else:
            if having is not None:
                raise PlanError("HAVING without aggregation")

        # window functions (computed after WHERE/GROUP/HAVING, before
        # DISTINCT/ORDER BY — SQL evaluation order)
        if any(any(isinstance(x, WindowCall) for x in walk(e))
               for e in [e for _, e in named_items] + [e for e, _ in order_items]):
            plan, named_items, order_items = self._plan_windows(
                plan, named_items, order_items)

        # final projection (+ hidden sort columns)
        sch = plan.schema
        proj_names = [n for n, _ in named_items]
        proj_exprs = [e for _, e in named_items]
        sort_keys: list[tuple[str, bool]] = []
        for oe, asc in order_items:
            # ORDER BY ordinal
            if isinstance(oe, Lit) and isinstance(oe.value, int):
                idx = oe.value - 1
                if not 0 <= idx < len(proj_names):
                    raise PlanError(f"ORDER BY position {oe.value} out of range")
                sort_keys.append((proj_names[idx], asc))
                continue
            # alias / identical expr match
            hit = None
            for n, e in zip(proj_names, proj_exprs):
                if e.equals(oe) or (isinstance(oe, ColRef) and oe.table is None
                                    and oe.name == n):
                    hit = n
                    break
            if hit is None:
                hit = self._tmp("s")
                proj_names.append(hit)
                proj_exprs.append(oe)
            sort_keys.append((hit, asc))

        def _nullable(e) -> bool:
            # bare column references keep base-table nullability (DESCRIBE
            # on views reads this); anything computed is nullable
            if isinstance(e, ColRef):
                try:
                    return sch.field(e.name).nullable
                except Exception:
                    return True
            return True

        out_schema = Schema(tuple(Field(n, infer_type(e, sch), _nullable(e))
                                  for n, e in zip(proj_names, proj_exprs)))
        plan = ProjectNode(children=[plan], exprs=proj_exprs, names=proj_names,
                           schema=out_schema)

        if stmt.distinct:
            plan = DistinctNode(children=[plan], schema=plan.schema)

        n_display = len(named_items)
        if sort_keys:
            plan = SortNode(children=[plan], keys=sort_keys,
                            limit=stmt.limit, offset=stmt.offset if stmt.limit is not None else 0,
                            schema=plan.schema)
        elif stmt.limit is not None:
            plan = LimitNode(children=[plan], limit=stmt.limit, offset=stmt.offset,
                             schema=plan.schema)

        if len(proj_names) != n_display:
            # drop hidden sort columns
            vis = proj_names[:n_display]
            plan = ProjectNode(children=[plan], exprs=[ColRef(n) for n in vis],
                               names=vis,
                               schema=Schema(tuple(out_schema.fields[:n_display])))
        return plan

    # ------------------------------------------------------------------
    def _reorder_comma_joins(self, stmt: SelectStmt):
        """Cost-based left-deep ordering of inner-join chains (the
        JoinReorder + JoinTypeAnalyzer analog,
        src/physical_plan/join_reorder.cpp, join_type_analyzer.cpp).

        Explicit INNER JOIN ... ON chains first flatten into comma form —
        for inner joins, ON conjuncts are semantically WHERE conjuncts —
        so `A JOIN B ON .. JOIN C ON ..` reorders exactly like
        `FROM A, B, C WHERE ..`.  The greedy then places, at each step,
        the EQUALITY-LINKED table with the smallest estimated surviving
        row count (table rows discounted by its single-table conjuncts),
        keeping intermediate results small; an unlinked table is placed
        only when nothing links (the cross-product last resort)."""
        if not stmt.joins or stmt.table is None:
            return
        if stmt.table.subquery is not None or any(
                j.kind not in ("cross", "inner") or
                j.using or j.table.subquery is not None
                for j in stmt.joins):
            return   # USING resolves against the left scope: order matters
        # label -> set of column names (via catalog)
        cols: dict[str, set] = {}
        try:
            for ref in [stmt.table] + [j.table for j in stmt.joins]:
                db = ref.database or self.default_db
                info = self.catalog.get_table(db, ref.name)
                cols[ref.label] = {f.name for f in info.schema.fields}
        except Exception:
            return                    # unknown table: let planning report it
        if len(cols) != len(stmt.joins) + 1:
            return                    # duplicate labels: keep original order

        def qualify(e, prefix: list[str]):
            """Rebind bare ColRefs to their unique owner WITHIN THE WRITTEN
            JOIN PREFIX (the scope the ON originally resolved against) —
            moving an ON into WHERE must not re-bind a name that a
            later-joined table would make ambiguous.  None = cannot
            qualify: leave the statement untouched."""
            if isinstance(e, ColRef):
                if e.table is not None:
                    return e if e.table in prefix else None
                hits = [lbl for lbl in prefix if e.name in cols[lbl]]
                return ColRef(e.name, table=hits[0]) if len(hits) == 1 \
                    else None
            if isinstance(e, Subquery):
                return None          # scope too subtle to relocate
            args = []
            for x in getattr(e, "args", ()) or ():
                qx = qualify(x, prefix)
                if qx is None:
                    return None
                args.append(qx)
            if isinstance(e, Call):
                return Call(e.op, tuple(args))
            return e if not args else None

        qualified: list = []
        for i, j in enumerate(stmt.joins):
            if j.on is None:
                qualified.append(None)
                continue
            prefix = [stmt.table.label] + \
                [jj.table.label for jj in stmt.joins[:i + 1]]
            q = qualify(j.on, prefix)
            if q is None:
                return               # bail BEFORE any mutation
            qualified.append(q)
        # SELECT * must keep the WRITTEN from-order even after reorder
        stmt.from_written = [stmt.table.label] + \
            [j.table.label for j in stmt.joins]
        for j, q in zip(stmt.joins, qualified):
            if q is not None:
                stmt.where = q if stmt.where is None else \
                    Call("and", (stmt.where, q))
                j.on = None
                j.kind = "cross"
        if stmt.where is None:
            return

        def owner(name, table):
            if table is not None:
                return table if table in cols else None
            hits = [lbl for lbl, cs in cols.items() if name in cs]
            return hits[0] if len(hits) == 1 else None

        refs = {stmt.table.label: stmt.table}
        for j in stmt.joins:
            refs[j.table.label] = j.table
        # links keep the column on EACH side: fanout estimation needs the
        # incoming table's key distinctness
        links: list[tuple[str, str, str, str]] = []   # (la, cola, lb, colb)
        single: dict[str, list] = {}   # label -> its single-table conjuncts
        for c in _conjuncts(stmt.where):
            if isinstance(c, Call) and c.op == "eq" and len(c.args) == 2 and \
                    all(isinstance(a, ColRef) for a in c.args):
                a, b = c.args
                la, lb = owner(a.name, a.table), owner(b.name, b.table)
                if la and lb and la != lb:
                    links.append((la, a.name.split(".")[-1],
                                  lb, b.name.split(".")[-1]))
                    continue
            owners = {owner(r.name, r.table) for r in walk(c)
                      if isinstance(r, ColRef)}
            if len(owners) == 1 and None not in owners:
                single.setdefault(next(iter(owners)), []).append(c)

        def raw_rows(ref) -> float:
            db = ref.database or self.default_db
            st = self.stores.get(f"{db}.{ref.name}")
            return float(st.num_rows) if st is not None else 1.0

        def col_stats(ref, col: str):
            db = ref.database or self.default_db
            return self.stats_fn(f"{db}.{ref.name}", col) \
                if self.stats_fn is not None else None

        def conj_sel(ref, c) -> float:
            """Per-conjunct selectivity: histogram/MCV-estimated when the
            conjunct is ``col CMP literal`` and stats exist
            (index/stats), else the fixed defaults."""
            from ..index.stats import (DEFAULT_EQ_SEL, DEFAULT_RANGE_SEL,
                                       conjunct_selectivity)

            is_eq = isinstance(c, Call) and c.op == "eq"
            default = DEFAULT_EQ_SEL if is_eq else DEFAULT_RANGE_SEL
            if not (isinstance(c, Call) and len(c.args) == 2
                    and c.op in ("eq", "ne", "lt", "le", "gt", "ge")):
                return default
            a, b = c.args
            op = c.op
            if isinstance(b, ColRef) and isinstance(a, Lit):
                a, b = b, a
                op = {"lt": "gt", "le": "ge",
                      "gt": "lt", "ge": "le"}.get(op, op)
            if not (isinstance(a, ColRef) and isinstance(b, Lit)):
                return default
            s = conjunct_selectivity(
                col_stats(ref, a.name.split(".")[-1]), op, b.value)
            return default if s is None else s

        def est(ref) -> float:
            """Surviving rows: table size discounted per conjunct (the
            reference's statistics-adjusted sizing, mpp_analyzer.cpp:723)."""
            n = raw_rows(ref)
            for c in single.get(ref.label, []):
                n *= conj_sel(ref, c)
            return max(n, 1.0)

        def distinct(ref, col) -> float:
            """Distinct-value proxy for a join column: histogram ndv when
            collected, else stats span or dictionary size; sqrt(rows)
            when unknown."""
            st = col_stats(ref, col)
            if st:
                if st.get("ndv"):
                    return float(max(st["ndv"], 1))
                if st.get("min") is not None:
                    # span caps at the row count: a sparse key space does
                    # not mean more distinct values than rows
                    return max(1.0, min(
                        float(int(st["max"]) - int(st["min"]) + 1),
                        raw_rows(ref)))
                if st.get("dict_size"):
                    return float(st["dict_size"])
            return max(1.0, raw_rows(ref) ** 0.5)

        def fanout(t_label: str) -> float:
            """Result growth of joining t to the placed set: est(t) over
            its best link column's distinct count (a unique key gives
            fanout <= 1: the index-join shape; an m:n low-cardinality link
            like nationkey=nationkey reports its true blowup)."""
            best = float("inf")
            ref = refs[t_label]
            for la, ca, lb, cb in links:
                tcol = None
                if la == t_label and lb in placed:
                    tcol = ca
                elif lb == t_label and la in placed:
                    tcol = cb
                if tcol is not None:
                    best = min(best, est(ref) / distinct(ref, tcol))
            return best

        placed = {stmt.table.label}
        remaining = list(stmt.joins)
        ordered = []
        while remaining:
            scored = [(fanout(j.table.label), j) for j in remaining]
            linked = [(f, j) for f, j in scored if f != float("inf")]
            if linked:
                pick = min(linked, key=lambda fj: fj[0])[1]
            else:
                pick = min(remaining, key=lambda j: est(j.table))
            remaining.remove(pick)
            ordered.append(pick)
            placed.add(pick.table.label)
        stmt.joins = ordered

    def _plan_table_ref(self, ref: TableRef, scope: Scope) -> PlanNode:
        if ref.subquery is None and ref.database is None and \
                ref.name in self._ctes:
            # CTE reference: plan as a derived table under its label.  The
            # CTE's own name is hidden while planning its body (non-recursive
            # CTEs: an inner reference resolves to the real table, and a
            # self-referencing shadow cannot recurse forever)
            import copy
            ref2 = copy.copy(ref)
            ref2.subquery = self._ctes[ref.name]
            ref2.alias = ref.alias or ref.name
            saved = self._ctes
            self._ctes = {k: v for k, v in saved.items() if k != ref.name}
            try:
                return self._plan_table_ref(ref2, scope)
            finally:
                self._ctes = saved
        if ref.subquery is None:
            vdb = ref.database or self.default_db
            view = self.catalog.get_view(vdb, ref.name) \
                if hasattr(self.catalog, "get_view") else None
            if view is not None:
                # view expansion: plan the stored body as a derived table
                # under the reference's label (reference: view DDL,
                # ddl_planner.cpp; MySQL MERGE-less TEMPTABLE semantics)
                key = f"{vdb}.{ref.name}"
                stack = getattr(self, "_view_stack", set())
                if key in stack:
                    raise PlanError(f"view {key!r} is recursive")
                from ..sql.parser import parse_sql
                sel = parse_sql(view["sql"])[0]
                cols = view.get("columns") or []
                if cols:
                    if len(cols) != len(sel.items):
                        raise PlanError(
                            f"view {key!r} declares {len(cols)} columns "
                            f"but selects {len(sel.items)}")
                    for item, cname in zip(sel.items, cols):
                        item.alias = cname
                import copy
                ref2 = copy.copy(ref)
                ref2.subquery = sel
                ref2.alias = ref.alias or ref.name
                self._view_stack = stack | {key}
                saved_db = self.default_db
                saved_ctes = self._ctes
                # unqualified names in the body resolve against the VIEW's
                # database, not the querying session's (MySQL semantics) —
                # and the CALLER's CTEs must not shadow tables the body
                # names (a view is a sealed scope)
                self.default_db = vdb
                self._ctes = {}
                try:
                    return self._plan_table_ref(ref2, scope)
                finally:
                    self._view_stack = stack
                    self.default_db = saved_db
                    self._ctes = saved_ctes
        if ref.subquery is not None:
            first = len(self._generated)
            sub = self._plan_query(ref.subquery)
            label = ref.label
            scope.add(label, Schema(tuple(Field(f.name, f.ltype, f.nullable)
                                          for f in sub.schema.fields)))
            # re-qualify subquery outputs under the derived-table label
            exprs = [ColRef(f.name) for f in sub.schema.fields]
            names = [f"{label}.{f.name}" for f in sub.schema.fields]
            return ProjectNode(children=[sub], exprs=exprs, names=names,
                               derived=True,
                               generated=frozenset(self._generated[first:]),
                               schema=Schema(tuple(Field(n, f.ltype, f.nullable)
                                                   for n, f in zip(names, sub.schema.fields))))
        db = ref.database or self.default_db
        info = self.catalog.get_table(db, ref.name)
        label = ref.label
        scope.add(label, info.schema)
        for vname, dim in ((info.options or {}).get("vector_cols")
                           or {}).items():
            scope.vector_cols[f"{label}.{vname}"] = (
                int(dim), [f"{label}.__{vname}_{i}" for i in range(int(dim))])
        sch = Schema(tuple(Field(f"{label}.{f.name}", f.ltype, f.nullable)
                           for f in info.schema.fields))
        return ScanNode(table_key=f"{db}.{ref.name}", label=label,
                        columns=[f.name for f in info.schema.fields], schema=sch)

    def _plan_join(self, left: PlanNode, j: JoinClause, scope: Scope,
                   stmt: SelectStmt) -> PlanNode:
        how = j.kind
        right = self._plan_table_ref(j.table, scope)
        rlabel = j.table.label
        if how == "right":
            # RIGHT JOIN -> LEFT JOIN with swapped children
            left, right = right, left
            how = "left"
        resolve = _Resolver(scope)
        on = resolve(j.on) if j.on is not None else None
        if j.using:
            conj = None
            llabels = [n for n in scope.order if n != rlabel]
            for c in j.using:
                lq = None
                for lbl in llabels:
                    if c in scope.tables[lbl]:
                        lq = f"{lbl}.{c}"
                        break
                if lq is None:
                    raise PlanError(f"USING column {c!r} not found on left side")
                eq = Call("eq", (ColRef(lq), ColRef(f"{rlabel}.{c}")))
                conj = eq if conj is None else Call("and", (conj, eq))
            on = conj if on is None else Call("and", (on, conj))
        if how == "cross" or on is None:
            if how in ("semi", "anti"):
                raise PlanError("SEMI/ANTI join requires ON")
            if on is None and stmt is not None and stmt.where is not None:
                # comma-FROM: promote WHERE equality conjuncts linking the
                # incoming table to tables already in scope into join keys —
                # the left-deep tree JoinReorder builds (the WHERE reapplies
                # them later, which is redundant but harmless)
                lc = {f.name for f in left.schema.fields}
                rc_ = {f.name for f in right.schema.fields}
                conj = None
                for c in _conjuncts(stmt.where):
                    try:
                        rcv = resolve(c)
                    except PlanError:
                        continue
                    pair = _equi_pair(rcv, lc, rc_)
                    if pair is not None:
                        eq = Call("eq", (ColRef(pair[0]), ColRef(pair[1])))
                        conj = eq if conj is None else Call("and", (conj, eq))
                if conj is not None:
                    on = conj
                    how = "inner"
            if on is None or how == "cross":
                node = JoinNode(children=[left, right], how="cross",
                                schema=_join_schema(left, right, "cross"))
                if on is not None:
                    node = FilterNode(children=[node], pred=on,
                                      schema=node.schema)
                return node
        lcols = {f.name for f in left.schema.fields}
        rcols = {f.name for f in right.schema.fields}
        lkeys, rkeys, residual = [], [], None
        for c in _conjuncts(on):
            pair = _equi_pair(c, lcols, rcols)
            if pair is not None:
                lkeys.append(pair[0])
                rkeys.append(pair[1])
                continue
            refs = _colrefs(c)
            if refs and refs <= rcols:
                # right-side-only ON conjunct: filter the build side BEFORE
                # the join — for LEFT joins this is the only correct place
                # (post-join it would drop preserved unmatched rows)
                right = FilterNode(children=[right], pred=c,
                                   schema=right.schema)
                continue
            residual = c if residual is None else Call("and", (residual, c))
        if not lkeys:
            node = JoinNode(children=[left, right], how="cross",
                            schema=_join_schema(left, right, "cross"))
            return FilterNode(children=[node], pred=on, schema=node.schema)
        # the sort-join packs at most TWO keys, each into 32 bits: wider/more
        # keys join on the first key exactly and verify the rest as residual
        # equality (superset of matches -> post-filter)
        def pair_is_32bit(i: int) -> bool:
            # 32-bit-safe types (or stats-bounded wider ints), no cross-
            # signedness aliasing
            return self._pair_pack_safe(left, lkeys[i], right, rkeys[i])

        composite_dense = len(lkeys) == 2 and (
            self._dense_key_domain_multi(right, rkeys) is not None or
            (how == "inner" and
             self._dense_key_domain_multi(left, lkeys) is not None))
        if len(lkeys) > 1 and how == "inner" and not composite_dense:
            # if one pair alone is a unique dense domain on either side,
            # join on IT and demote the rest to residual equality — a dense
            # scatter/gather + filter beats a packed 2-key sort join
            for i in range(len(lkeys)):
                if (self._dense_key_domain(right, rkeys[i]) is not None or
                        self._dense_key_domain(left, lkeys[i]) is not None):
                    for j, (l, r) in enumerate(zip(lkeys, rkeys)):
                        if j != i:
                            eq = Call("eq", (ColRef(l), ColRef(r)))
                            residual = eq if residual is None else \
                                Call("and", (residual, eq))
                    lkeys, rkeys = [lkeys[i]], [rkeys[i]]
                    break
        if len(lkeys) > 1 and not (len(lkeys) == 2 and pair_is_32bit(0)
                                   and pair_is_32bit(1)):
            for l, r in zip(lkeys[1:], rkeys[1:]):
                eq = Call("eq", (ColRef(l), ColRef(r)))
                residual = eq if residual is None else Call("and", (residual, eq))
            lkeys, rkeys = lkeys[:1], rkeys[:1]
        if residual is not None and how in ("left", "semi", "anti"):
            raise PlanError(f"non-equi residual not supported for {how} join")
        node = JoinNode(children=[left, right], how=how, left_keys=lkeys,
                        right_keys=rkeys, residual=residual,
                        schema=_join_schema(left, right, how))
        if len(lkeys) == 2:
            # both pairs passed _pair_pack_safe above: the kernel may pack
            # wider integer types (values verified bounded)
            node.pack32_verified = True
        if residual is not None:
            node2 = FilterNode(children=[node], pred=residual, schema=node.schema)
            node.residual = None
            self._maybe_dense_join(node)
            return node2
        self._maybe_dense_join(node)
        return node

    # ------------------------------------------------------------------
    def _push_predicates(self, plan: PlanNode, where: Expr,
                         stmt: SelectStmt) -> PlanNode:
        """Split WHERE conjuncts; push single-table ones into their Scan
        (reference: PredicatePushDown pass, src/physical_plan).  Right sides
        of LEFT joins and either side of SEMI/ANTI are not safe targets."""
        unsafe = set()
        for j in stmt.joins:
            if j.kind in ("left",):
                unsafe.add(j.table.label)
            if j.kind == "right":
                # after swap the *other* tables became the right side; keep
                # it simple: disable pushdown entirely when RIGHT JOIN present
                return FilterNode(children=[plan], pred=where, schema=plan.schema)
        scan_labels = set()

        def scan_label_walk(n: PlanNode):
            if isinstance(n, ScanNode):
                scan_labels.add(n.label)
            for c in _pushable_children(n):
                scan_label_walk(c)

        scan_label_walk(plan)
        remaining = None
        pushed: dict[str, Expr] = {}
        cjs = _conjuncts(where)
        for c in cjs:
            labels = {r.name.split(".", 1)[0] for r in walk(c)
                      if isinstance(r, ColRef)}
            # derived tables have no ScanNode: their conjuncts must stay above
            if len(labels) == 1:
                lbl = next(iter(labels))
                if lbl not in unsafe and lbl in scan_labels:
                    pushed[lbl] = c if lbl not in pushed else Call("and", (pushed[lbl], c))
                    continue
            remaining = c if remaining is None else Call("and", (remaining, c))
        for lbl, c in self._propagate_eq_constants(plan, where, cjs,
                                                   scan_labels, unsafe):
            pushed[lbl] = c if lbl not in pushed else \
                Call("and", (pushed[lbl], c))
        if pushed:
            _push_into_scans(plan, pushed)
        if remaining is not None:
            plan = FilterNode(children=[plan], pred=remaining, schema=plan.schema)
        return plan

    def _propagate_eq_constants(self, plan: PlanNode, where: Expr, cjs,
                                scan_labels: set, unsafe: set):
        """Equality-class constant propagation: ``a.k = b.k AND b.k = 5``
        also pushes ``a.k = 5`` into a's scan, so zonemap/index pruning
        fires on BOTH sides of the join (the reference's predicate
        transitivity).  Classes come from inner-join equi-keys plus WHERE
        ``col = col`` conjuncts (plan/eqclasses.py — LEFT/semi/anti
        equalities hold only for matched rows and never feed a class); the
        derived conjunct is redundant above the scan, so it is pushed ONLY
        (never added to the residual filter).  -> [(label, conjunct)]."""
        if not bool(FLAGS.eqclass_pushdown) or not scan_labels:
            return []
        from ..expr.ast import Param
        from .eqclasses import statement_classes

        cm = statement_classes(plan, where)
        existing = set()
        for c in cjs:
            try:
                existing.add(c.key())
            except Exception:   # noqa: BLE001 — dedupe is best-effort
                metrics.count_swallowed("planner.eqconst_key")
        out = []
        for c in cjs:
            if not (isinstance(c, Call) and c.op == "eq" and len(c.args) == 2):
                continue
            a, b = c.args
            if isinstance(b, ColRef) and isinstance(a, (Lit, Param)):
                a, b = b, a
            if not (isinstance(a, ColRef) and isinstance(b, (Lit, Param))):
                continue
            for member in cm.cls(a.name):
                if member == a.name:
                    continue
                lbl = member.split(".", 1)[0]
                if lbl not in scan_labels or lbl in unsafe:
                    continue
                derived = Call("eq", (ColRef(member), b))
                try:
                    if derived.key() in existing:
                        continue
                    existing.add(derived.key())
                except Exception:   # noqa: BLE001
                    metrics.count_swallowed("planner.eqconst_key")
                out.append((lbl, derived))
                metrics.eqclass_consts_pushed.add(1)
        return out

    # ------------------------------------------------------------------
    def _spine_dense_joins(self, plan: PlanNode):
        """Dense (unique-build) inner/left joins anywhere in the join tree
        below an aggregate: [(probe_key, build_key, build_col_names)].  A
        dense join's build side is unique per key, so equal key values map
        to ONE build row — build columns are functions of the key no matter
        where the join sits (probe spine or inside another build subtree).
        The walk stops at scope boundaries (aggregates, unions, derived
        tables) where column identity ends."""
        out = []
        stack = [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, (FilterNode, ProjectNode)) and node.children:
                if getattr(node, "derived", False):
                    continue   # scope boundary: a derived table's aliases
                    #            may shadow inner names — FDs don't cross
                stack.append(node.children[0])
            elif isinstance(node, JoinNode) and len(node.children) == 2:
                if node.strategy == "dense" and node.how in ("inner", "left"):
                    out.append((list(node.left_keys), list(node.right_keys),
                                [f.name for f in
                                 node.children[1].schema.fields]))
                    stack.extend(node.children)
                elif node.how in ("semi", "anti"):
                    stack.append(node.children[0])
                else:
                    stack.extend(node.children)
        return out

    def _reduce_fd_keys(self, plan: PlanNode, key_names: list[str]):
        """Functional-dependency reduction of GROUP BY keys: a dense join's
        build side is UNIQUE per join key, so once a group key fixes that
        join key, every build-side column is group-uniform — grouping by it
        is redundant (the classic optimizer FD transform; the reference
        leans on MySQL semantics here).  Returns (kept, dropped); dropped
        keys re-emerge as MIN aggregates (any-value over a uniform group).
        """
        joins = self._spine_dense_joins(plan)
        if not joins:
            return key_names, []

        def closure(base: set[str]) -> set[str]:
            det = set(base)
            changed = True
            while changed:
                changed = False
                for lks, rks, build_cols in joins:
                    if all(k in det for k in lks) or \
                            all(k in det for k in rks):
                        new = set(build_cols) - det
                        if new:
                            det |= new
                            changed = True
            return det

        kept = list(key_names)
        dropped: list[str] = []
        for kj in list(key_names):
            trial = [k for k in kept if k != kj]
            if trial and kj in closure(set(trial)):
                kept = trial
                dropped.append(kj)
        return kept, dropped

    def _plan_aggregate(self, plan, flat, named_items, group_exprs, having,
                        order_items, stmt, scope=None):
        sch = plan.schema
        # pre-agg projection: group keys + aggregate inputs
        pre_names: list[str] = []
        pre_exprs: list[Expr] = []
        key_names: list[str] = []
        for g in group_exprs:
            if isinstance(g, ColRef):
                key_names.append(g.name)
                continue
            kn = self._tmp("k")
            key_names.append(kn)
            pre_names.append(kn)
            pre_exprs.append(g)

        aggs: list[AggCall] = []

        def note_aggs(e: Optional[Expr]):
            if e is None:
                return
            for x in walk(e):
                if isinstance(x, AggCall) and not any(x.equals(a) for a in aggs):
                    aggs.append(x)

        for _, e in named_items:
            note_aggs(e)
        note_aggs(having)
        for e, _ in order_items:
            note_aggs(e)

        specs: list[AggSpec] = []
        agg_out: list[tuple[AggCall, str]] = []
        for a in aggs:
            out = self._tmp("a")
            if a.op == "count_star" or not a.args:
                specs.append(AggSpec("count_star", None, out))
            else:
                arg = a.args[0]
                if isinstance(arg, ColRef):
                    inp = arg.name
                else:
                    inp = self._tmp("ai")
                    pre_names.append(inp)
                    pre_exprs.append(arg)
                op = a.op
                if op == "count" and len(a.args) > 1:
                    raise PlanError("multi-arg COUNT not supported")
                param = None
                if op == "median":
                    op, param = "percentile", 0.5
                elif op == "percentile":
                    if len(a.args) < 2 or not isinstance(a.args[1], Lit):
                        raise PlanError("PERCENTILE(col, p) needs a literal p")
                    param = float(a.args[1].value)
                    if not 0.0 <= param <= 1.0:
                        raise PlanError("percentile p must be in [0, 1]")
                specs.append(AggSpec(op, inp, out, distinct=a.distinct,
                                     param=param))
            agg_out.append((a, out))

        # functional-dependency key reduction: group keys pinned by a dense
        # join's unique build key become MIN aggregates (group-uniform) —
        # GROUP BY l_orderkey, o_orderdate, o_shippriority collapses to a
        # single dense l_orderkey domain (the q3/q10/q18 shape)
        orig_key_names = list(key_names)
        fd_specs: list[AggSpec] = []
        if len(key_names) > 1:
            kept, dropped = self._reduce_fd_keys(plan, key_names)
            if dropped:
                key_names = kept
                fd_specs = [AggSpec("min", kj, kj) for kj in dropped]
        # pre-agg projection keeps ONLY referenced columns: group keys,
        # ColRef agg inputs, and anything the select/having/order exprs
        # still name.  Projecting the full child schema here would mark
        # every column as used, defeating ColumnsPrune — joins would
        # gather 30+ columns to feed a 4-column aggregate (the q3 shape)
        used: set[str] = set(key_names)
        for spec in specs + fd_specs:
            if spec.input is not None:
                used.add(spec.input)
        for container in ([e for _, e in named_items] + [having] +
                          [e for e, _ in order_items]):
            if container is None:
                continue
            for x in walk(container):
                if isinstance(x, ColRef):
                    used.add(x.name)
        keep = [f.name for f in sch.fields if f.name in used]
        if not keep and not pre_exprs and sch.fields:
            # bare COUNT(*): a zero-column projection would lose the row
            # count — carry one (any) column through
            keep = [sch.fields[0].name]
        if pre_exprs or len(keep) < len(sch.fields):
            exprs = [ColRef(n) for n in keep] + pre_exprs
            names = keep + pre_names
            psch = Schema(tuple([sch.field(n) for n in keep] +
                                [Field(n, infer_type(e, sch)) for n, e in
                                 zip(pre_names, pre_exprs)]))
            plan = ProjectNode(children=[plan], exprs=exprs, names=names, schema=psch)
            sch = psch

        strategy, domains, max_groups, key_shift = self._group_strategy(plan, sch, key_names)
        out_fields = []
        for kn in key_names:
            f = sch.field(kn)
            out_fields.append(Field(kn, f.ltype, f.nullable))
        for (a, out), s in zip(agg_out, specs):
            at = infer_type(a.args[0], sch) if a.args else LType.INT64
            out_fields.append(Field(out, agg_result_type(s.op if s.op != "count_star"
                                                         else "count", at)))
        for s in fd_specs:
            f = sch.field(s.input)
            out_fields.append(Field(s.out_name, f.ltype, f.nullable))
        agg = AggNode(children=[plan], key_names=key_names,
                      specs=specs + fd_specs,
                      strategy=strategy, domains=domains, max_groups=max_groups,
                      schema=Schema(tuple(out_fields)))
        if strategy == "sorted" and key_names and \
                self._position_preserving(plan):
            # all keys are base columns of the one underlying scan: the
            # executor can feed a host-precomputed per-version sort
            hits = [self._key_scan(plan, k) for k in key_names]
            if all(h is not None and len(h) == 2 for h in hits) and \
                    len({h[0] for h in hits}) == 1:
                agg.presort = ("agg", hits[0][0],
                               tuple(h[1] for h in hits))
        agg.key_shift = key_shift
        plan = agg

        # rewrite post-agg expressions: AggCall -> its out column; group-key
        # exprs -> key column
        mapping: list[tuple[Expr, Expr]] = []
        for a, out in agg_out:
            mapping.append((a, ColRef(out)))
        for g, kn in zip(group_exprs, orig_key_names):
            # FD-dropped keys still exist as agg outputs under their name
            mapping.append((g, ColRef(kn)))

        def rewrite(e: Optional[Expr]) -> Optional[Expr]:
            if e is None:
                return None
            for src, dst in mapping:
                if e.equals(src):
                    return dst
            if isinstance(e, WindowCall):
                return WindowCall(e.op, tuple(rewrite(x) for x in e.args),
                                  tuple(rewrite(x) for x in e.partition_by),
                                  tuple((rewrite(x), asc) for x, asc in e.order_by),
                                  e.running, e.frame)
            if isinstance(e, (Call, AggCall)):
                new_args = tuple(rewrite(x) for x in e.args)
                if isinstance(e, AggCall):
                    raise PlanError(f"nested aggregate {e!r}")
                return Call(e.op, new_args)
            if isinstance(e, ColRef):
                if e.name in orig_key_names:
                    return e
                raise PlanError(f"column {e.name!r} must appear in GROUP BY "
                                "or inside an aggregate")
            return e

        named_items = [(n, rewrite(e)) for n, e in named_items]
        order_items = [(rewrite(e), asc) for e, asc in order_items]
        if having is not None:
            having = rewrite(having)
            # HAVING may compare against scalar subqueries (TPC-H Q11):
            # inject them as broadcast columns ABOVE the aggregation
            hh = [plan]
            having = self._subst_scalar(having, hh, scope or Scope())
            plan = hh[0]
            plan = FilterNode(children=[plan], pred=having, schema=plan.schema)
        return plan, named_items, None, order_items

    # -- subqueries ------------------------------------------------------
    def _try_subquery_conjunct(self, c: Expr, holder, scope, resolve) -> bool:
        """IN/NOT IN (SELECT..) and [NOT] EXISTS(SELECT..) conjuncts become
        semi/anti joins against the subplan (the decorrelation the reference
        does in DeCorrelate + Separate).  Returns True if handled."""
        anti = False
        if isinstance(c, Call) and c.op == "not" and len(c.args) == 1 and \
                isinstance(c.args[0], Call) and c.args[0].op == "exists":
            c = c.args[0]
            anti = True
        if not isinstance(c, Call):
            return False
        if c.op == "in_subquery":
            # IN as a semi join is exact: NULL keys and NULL-list misses both
            # evaluate to NULL -> dropped by WHERE, same as the join drop
            x = resolve(c.args[0])
            sub = c.args[1]
            assert isinstance(sub, Subquery)
            subplan = self._plan_query(sub.stmt)
            if len(subplan.schema.fields) != 1:
                raise PlanError("IN subquery must return exactly one column")
            holder[0], key = self._ensure_col(holder[0], x)
            rkey = subplan.schema.fields[0].name
            jn = JoinNode(children=[holder[0], subplan], how="semi",
                          left_keys=[key], right_keys=[rkey],
                          schema=holder[0].schema)
            jn.subquery_right = True
            self._maybe_dense_join(jn)
            holder[0] = jn
            return True
        # NOT IN must NOT become an anti join: with a NULL in the list the
        # predicate is NULL (row dropped); the MembershipNode value path
        # implements that, so leave it to _subst_scalar
        if c.op == "not_in_subquery":
            return False
        if c.op == "exists":
            sub = c.args[0]
            assert isinstance(sub, Subquery)
            self._plan_exists(sub.stmt, holder, scope, anti)
            return True
        return False

    def _plan_exists(self, substmt, holder, scope, anti: bool):
        """[NOT] EXISTS: equality-correlated -> semi/anti join on the
        correlation keys; uncorrelated -> semi/anti join on a constant key
        (keeps the whole decision inside the jitted program).  Correlated
        conjuncts beyond plain equality (e.g. l2.suppkey <> l1.suppkey)
        decorrelate through a row-identity membership rewrite."""
        if substmt.table is None:
            raise PlanError("EXISTS subquery needs a FROM clause")
        subscope = Scope()
        subplan = self._plan_table_ref(substmt.table, subscope)
        for j in substmt.joins:
            subplan = self._plan_join(subplan, j, subscope, substmt)
        inner_resolve = _Resolver(subscope)
        outer_resolve = _Resolver(scope)
        inner_where = None
        pairs: list[tuple[str, str]] = []   # (outer qualified, inner qualified)
        residuals: list[Expr] = []          # both-scope, non-equality
        for c in _conjuncts(substmt.where) if substmt.where is not None else []:
            try:
                rc = inner_resolve(c)
                inner_where = rc if inner_where is None else \
                    Call("and", (inner_where, rc))
                continue
            except PlanError:
                pass
            # correlated equality: one side inner, one side outer
            if isinstance(c, Call) and c.op == "eq" and len(c.args) == 2 and \
                    all(isinstance(a, ColRef) for a in c.args):
                a, b = c.args
                for inner_e, outer_e in ((a, b), (b, a)):
                    try:
                        iq = inner_resolve(inner_e)
                        oq = outer_resolve(outer_e)
                        pairs.append((oq.name, iq.name))
                        break
                    except PlanError:
                        continue
                else:
                    residuals.append(c)
                continue
            residuals.append(c)
        if inner_where is not None:
            subplan = FilterNode(children=[subplan], pred=inner_where,
                                 schema=subplan.schema)
        if residuals:
            neq = self._try_neq_residual(holder[0], subplan, pairs,
                                         residuals, outer_resolve,
                                         inner_resolve)
            if neq is not None:
                jn = JoinNode(children=[holder[0], subplan],
                              how="anti" if anti else "semi",
                              left_keys=[o for o, _ in pairs],
                              right_keys=[i for _, i in pairs],
                              neq=neq, schema=holder[0].schema)
                jn.subquery_right = True
                # build side over a position-preserving chain to one scan:
                # the executor feeds a host-precomputed per-version sort
                # permutation and the kernel skips its on-device lexsort
                hk = self._key_scan(subplan, pairs[0][1])
                hb = self._key_scan(subplan, neq[1])
                if hk is not None and hb is not None and len(hk) == 2 and \
                        len(hb) == 2 and hk[0] == hb[0] and \
                        self._position_preserving(subplan):
                    jn.presort = ("join", hk[0], (hk[1], hb[1]))
                holder[0] = jn
                return
            self._plan_exists_residual(holder, scope, subscope, subplan,
                                       pairs, residuals, anti)
            return
        how = "anti" if anti else "semi"
        if pairs:
            lkeys = [o for o, _ in pairs]
            rkeys = [i for _, i in pairs]
        else:
            # uncorrelated: join both sides on a constant key
            holder[0], lk = self._ensure_col(holder[0], Lit(1))
            subplan, rk = self._ensure_col(subplan, Lit(1))
            lkeys, rkeys = [lk], [rk]
        jn = JoinNode(children=[holder[0], subplan], how=how,
                      left_keys=lkeys, right_keys=rkeys,
                      schema=holder[0].schema)
        jn.subquery_right = True
        self._maybe_dense_join(jn)
        holder[0] = jn

    _SAFE32 = {LType.BOOL, LType.INT8, LType.INT16, LType.INT32,
               LType.UINT32, LType.DATE, LType.STRING}

    def _fits32(self, side: PlanNode, qualified: str) -> bool:
        """The column's DEVICE values fit 32-bit packing: a 32-bit-safe
        type, or a wider integer whose host statistics bound it inside
        int32 (BIGINT keys holding small ids — the plan cache replans on
        version bump, so the bound stays current)."""
        try:
            f = side.schema.field(qualified)
        except Exception:
            return False
        if f.ltype in self._SAFE32:
            return True
        if not f.ltype.is_integer:
            return False
        st = self._key_stats(side, qualified)
        return bool(st) and st.get("min") is not None and \
            int(st["min"]) >= -(1 << 31) and int(st["max"]) < (1 << 31)

    def _pair_pack_safe(self, lside, lq, rside, rq) -> bool:
        """Both sides of one equality pair pack into 32 bits AND cannot
        alias across signedness: int32 -1 and uint32 4294967295 share a
        bit pattern, so a signed/unsigned mix needs the unsigned side
        stats-bounded inside int32."""
        if not (self._fits32(lside, lq) and self._fits32(rside, rq)):
            return False
        lu = lside.schema.field(lq).ltype is LType.UINT32
        ru = rside.schema.field(rq).ltype is LType.UINT32
        if lu == ru:
            return True
        uns, q = (lside, lq) if lu else (rside, rq)
        st = self._key_stats(uns, q)
        return bool(st) and st.get("max") is not None and \
            int(st["max"]) < (1 << 31)

    def _position_preserving(self, plan: PlanNode) -> bool:
        """True when ``plan`` is a Project/Filter chain over ONE Scan: row
        positions equal the base table's (filters are sel-masks, not
        compaction), so a host permutation of the table applies verbatim."""
        node = plan
        while True:
            if isinstance(node, ScanNode):
                return True
            if isinstance(node, (FilterNode, ProjectNode)) and \
                    len(node.children) == 1:
                node = node.children[0]
                continue
            return False

    def _try_neq_residual(self, outer, subplan, pairs, residuals,
                          outer_resolve, inner_resolve):
        """(probe_col, build_col) when the EXISTS residual is exactly ONE
        correlated ``inner <> outer`` over 32-bit-safe columns with
        single-pair 32-bit-safe equality keys — the no-expansion
        range-count path (q21's shape).  None = use the general rewrite."""
        if len(residuals) != 1 or len(pairs) != 1:
            return None
        r = residuals[0]
        if not (isinstance(r, Call) and r.op in ("neq", "ne") and
                len(r.args) == 2 and
                all(isinstance(x, ColRef) for x in r.args)):
            return None
        for inner_e, outer_e in ((r.args[0], r.args[1]),
                                 (r.args[1], r.args[0])):
            try:
                iq = inner_resolve(inner_e)
                oq = outer_resolve(outer_e)
            except PlanError:
                continue
            try:
                neqs = [outer.schema.field(oq.name),
                        subplan.schema.field(iq.name)]
            except Exception:
                return None
            # neq columns exclude STRING (dictionaries not aligned in this
            # path) and mixed signedness (int32 -1 and uint32 4294967295
            # would alias after 32-bit packing); keys may be wider ints
            # when statistics bound their values inside int32
            neq_ok = all(f.ltype is not LType.STRING and
                         self._fits32(s, q)
                         for f, s, q in zip(neqs, (outer, subplan),
                                            (oq.name, iq.name))) and \
                len({f.ltype is LType.UINT32 for f in neqs}) == 1
            if self._pair_pack_safe(outer, pairs[0][0],
                                    subplan, pairs[0][1]) and neq_ok:
                return (oq.name, iq.name)
            return None
        return None

    def _plan_exists_residual(self, holder, scope, subscope, subplan,
                              pairs, residuals, anti: bool):
        """[NOT] EXISTS whose correlation is not pure equality: join the
        outer stream (tagged with a synthetic row identity) to the subquery
        on the equality pairs, filter the residual over the pair columns,
        and test the row identity's membership in the surviving pairs —
        semi/anti with arbitrary residuals built from existing operators
        (the ApplyNode elimination the reference does in DeCorrelate)."""
        holder[0], rid = self._ensure_col(holder[0], Call("__row_index", ()))
        comb = Scope()
        comb.tables.update(scope.tables)
        comb.tables.update(subscope.tables)
        comb.order = list(scope.order) + [lbl for lbl in subscope.order
                                          if lbl not in scope.tables]
        comb.extras.update(scope.extras)
        resolve = _Resolver(comb)
        pred = None
        for c in residuals:
            rc = resolve(c)
            pred = rc if pred is None else Call("and", (pred, rc))
        if pairs:
            lkeys = [o for o, _ in pairs]
            rkeys = [i for _, i in pairs]
            jn = JoinNode(children=[holder[0], subplan], how="inner",
                          left_keys=lkeys, right_keys=rkeys,
                          schema=_join_schema(holder[0], subplan, "inner"))
            self._maybe_dense_join(jn)
        else:
            jn = JoinNode(children=[holder[0], subplan], how="cross",
                          schema=_join_schema(holder[0], subplan, "cross"))
        jn.subquery_right = True
        filt = FilterNode(children=[jn], pred=pred, schema=jn.schema)
        pname = self._tmp("xr")
        proj = ProjectNode(children=[filt], exprs=[ColRef(rid)], names=[pname],
                           schema=Schema((Field(pname, LType.INT64),)))
        proj.derived = True        # separate scope: outer pushdown stops here
        out = self._tmp("exv")
        holder[0] = MembershipNode(
            children=[holder[0], proj], key_col=rid, out_name=out,
            negate=anti,
            schema=Schema(tuple(list(holder[0].schema.fields) +
                                [Field(out, LType.BOOL)])))
        holder[0] = FilterNode(children=[holder[0]], pred=ColRef(out),
                               schema=holder[0].schema)

    def _subst_scalar(self, e: Optional[Expr], holder, scope) -> Optional[Expr]:
        """Replace uncorrelated scalar Subquery nodes with injected broadcast
        columns (ScalarSourceNode)."""
        if e is None:
            return None
        if isinstance(e, Subquery):
            try:
                subplan = self._plan_query(e.stmt)
            except PlanError as uncorr_err:
                # outer references inside: try equality-correlated aggregate
                # decorrelation (group by the correlation keys + join back),
                # then the general Apply for everything else
                col = self._try_correlated_scalar(e.stmt, holder, scope)
                if col is None:
                    col = self._try_general_apply(e.stmt, holder, scope)
                if col is None:
                    raise uncorr_err
                return col
            if len(subplan.schema.fields) != 1:
                raise PlanError("scalar subquery must return exactly one column")
            f0 = subplan.schema.fields[0]
            name = self._tmp("sq")
            subplan = ProjectNode(children=[subplan], exprs=[ColRef(f0.name)],
                                  names=[name],
                                  schema=Schema((Field(name, f0.ltype),)))
            base = holder[0]
            holder[0] = ScalarSourceNode(
                children=[base, subplan], col_names=[name],
                schema=Schema(tuple(list(base.schema.fields) +
                                    [Field(name, f0.ltype)])))
            scope.extras[name] = f0.ltype
            return ColRef(name)
        if isinstance(e, Call) and e.op in ("in_subquery", "not_in_subquery"):
            # nested (non-conjunct) membership: compute as a value column
            x = self._subst_scalar(e.args[0], holder, scope)
            sub = e.args[1]
            assert isinstance(sub, Subquery)
            subplan = self._plan_query(sub.stmt)
            if len(subplan.schema.fields) != 1:
                raise PlanError("IN subquery must return exactly one column")
            xr = _Resolver(scope)(x)
            holder[0], key = self._ensure_col(holder[0], xr)
            out = self._tmp("inq")
            holder[0] = MembershipNode(
                children=[holder[0], subplan], key_col=key, out_name=out,
                negate=(e.op == "not_in_subquery"),
                schema=Schema(tuple(list(holder[0].schema.fields) +
                                    [Field(out, LType.BOOL)])))
            scope.extras[out] = LType.BOOL
            return ColRef(out)
        if isinstance(e, Call) and e.op == "exists":
            # nested EXISTS: uncorrelated only -> COUNT(*) > 0 scalar subquery
            sub = e.args[0]
            assert isinstance(sub, Subquery)
            import copy
            from ..sql.stmt import SelectItem
            cnt = copy.copy(sub.stmt)
            cnt.items = [SelectItem(AggCall("count_star", ()), "n")]
            cnt.order_by = []
            cnt.limit = None
            return Call("gt", (self._subst_scalar(Subquery(cnt), holder, scope),
                               Lit(0)))
        if isinstance(e, AggCall):
            return AggCall(e.op, tuple(self._subst_scalar(a, holder, scope)
                                       for a in e.args), e.distinct)
        if isinstance(e, WindowCall):
            return WindowCall(e.op,
                              tuple(self._subst_scalar(a, holder, scope)
                                    for a in e.args),
                              tuple(self._subst_scalar(a, holder, scope)
                                    for a in e.partition_by),
                              tuple((self._subst_scalar(x, holder, scope), asc)
                                    for x, asc in e.order_by),
                              e.running, e.frame)
        if isinstance(e, Call):
            return Call(e.op, tuple(self._subst_scalar(a, holder, scope)
                                    for a in e.args))
        return e

    def _try_correlated_scalar(self, stmt, holder, scope):
        """Equality-correlated scalar aggregate subquery -> grouped subquery
        + LEFT JOIN back on the correlation keys (the reference's ApplyNode
        -> DeCorrelate rewrite, src/physical_plan de_correlate).

        SELECT agg(x) FROM inner WHERE inner.k = outer.k AND P(inner)
        becomes
        LEFT JOIN (SELECT k, agg(x) v FROM inner WHERE P GROUP BY k)
               ON outer.k = k
        and the scalar value is the joined ``v`` (NULL when no group —
        exactly the empty-subquery NULL the row-at-a-time form produces).

        Exception: COUNT of an empty correlation group is 0, not NULL — a
        bare COUNT item gets an IFNULL(v, 0); COUNT nested inside a larger
        expression is refused (the join-back NULL would differ from the
        row-at-a-time 0).

        Returns the value expr, or None when the shape doesn't fit."""
        import copy

        from ..sql.stmt import SelectItem

        if stmt.table is None or stmt.group_by or stmt.having or \
                stmt.order_by or stmt.limit is not None:
            return None
        if len(stmt.items) != 1 or not _contains_agg(stmt.items[0].expr):
            return None
        item = stmt.items[0].expr
        is_bare_count = isinstance(item, AggCall) and \
            item.op in ("count", "count_star")
        if not is_bare_count:
            def has_count(x):
                if isinstance(x, AggCall) and x.op in ("count", "count_star"):
                    return True
                return isinstance(x, (Call, AggCall)) and \
                    any(has_count(a) for a in x.args)
            if has_count(item):
                return None
        # trial scope over the subquery's FROM for conjunct classification
        trial = Scope()
        try:
            self._plan_table_ref(stmt.table, trial)
            for j in stmt.joins:
                self._plan_table_ref(j.table, trial)
        except PlanError:
            return None
        inner_res = _Resolver(trial)
        outer_res = _Resolver(scope)
        inner_conj: list[Expr] = []
        pairs: list[tuple[Expr, Expr]] = []   # (outer expr, inner expr) RAW
        for c in _conjuncts(stmt.where) if stmt.where is not None else []:
            try:
                inner_res(c)
                inner_conj.append(c)          # keep unresolved: re-planned
                continue
            except PlanError:
                pass
            matched = False
            if isinstance(c, Call) and c.op == "eq" and len(c.args) == 2:
                a, b = c.args
                for ie, oe in ((a, b), (b, a)):
                    try:
                        inner_res(ie)
                        outer_res(oe)
                    except PlanError:
                        continue
                    pairs.append((oe, ie))
                    matched = True
                    break
            if not matched:
                return None
        if not pairs:
            return None
        sub2 = copy.copy(stmt)
        knames = [self._tmp("ck") for _ in pairs]
        vname = self._tmp("cv")
        sub2.items = [SelectItem(ie, kn)
                      for (_, ie), kn in zip(pairs, knames)] + \
                     [SelectItem(stmt.items[0].expr, vname)]
        w = None
        for c in inner_conj:
            w = c if w is None else Call("and", (w, c))
        sub2.where = w
        sub2.group_by = [ie for _, ie in pairs]
        sub2.order_by = []
        sub2.limit = None
        sub2.offset = 0
        subplan = self._plan_query(sub2)
        okeys = []
        for oe, _ in pairs:
            holder[0], k = self._ensure_col(holder[0], outer_res(oe))
            okeys.append(k)
        jn = JoinNode(children=[holder[0], subplan], how="left",
                      left_keys=okeys, right_keys=knames,
                      schema=_join_schema(holder[0], subplan, "left"))
        jn.subquery_right = True
        self._maybe_dense_join(jn)
        holder[0] = jn
        scope.extras[vname] = subplan.schema.field(vname).ltype
        if is_bare_count:
            return Call("ifnull", (ColRef(vname), Lit(0)))
        return ColRef(vname)

    def _try_general_apply(self, stmt, holder, scope):
        """General correlated scalar AGGREGATE subquery — arbitrary
        correlation predicates, not just equality (the reference's
        ApplyNode, src/exec/apply_node.cpp 726 LoC).  Lowering:

        1. tag the outer stream with a synthetic row identity,
        2. join it to the subquery's FROM (equality correlation conjuncts
           become join keys when present, else a cross join) and filter the
           remaining correlation conjuncts over the combined row,
        3. aggregate per outer row identity,
        4. LEFT JOIN the per-row values back (NULL for outer rows with no
           qualifying inner rows; bare COUNT gets IFNULL 0).

        Returns the value expr, or None when the shape doesn't fit (not a
        single aggregate item, or conjuncts that resolve in neither
        scope)."""
        from ..ops.hashagg import AggSpec, agg_result_type

        if stmt.table is None or stmt.group_by or stmt.having or \
                stmt.order_by or stmt.limit is not None or stmt.ctes or \
                stmt.union is not None or stmt.distinct:
            return None
        if len(stmt.items) != 1 or not _contains_agg(stmt.items[0].expr):
            return None
        item = stmt.items[0].expr
        is_bare_count = isinstance(item, AggCall) and \
            item.op in ("count", "count_star")
        if not (is_bare_count or isinstance(item, AggCall)) or \
                (isinstance(item, AggCall) and len(item.args) > 1):
            return None
        # plan the subquery's FROM under its own scope
        subscope = Scope()
        try:
            subplan = self._plan_table_ref(stmt.table, subscope)
            for j in stmt.joins:
                subplan = self._plan_join(subplan, j, subscope, stmt)
        except PlanError:
            return None
        inner_res = _Resolver(subscope)
        outer_res = _Resolver(scope)

        def comb_res(x):
            """Resolve with MySQL subquery scoping: unqualified names bind
            INNER-first, outer only as a fallback — per ColRef, so one
            conjunct can mix both sides."""
            if isinstance(x, ColRef):
                try:
                    return inner_res(x)
                except PlanError:
                    return outer_res(x)
            if isinstance(x, AggCall):
                return AggCall(x.op, tuple(comb_res(a) for a in x.args),
                               getattr(x, "distinct", False))
            if isinstance(x, Call):
                return Call(x.op, tuple(comb_res(a) for a in x.args))
            if isinstance(x, Lit):
                return x
            raise PlanError(f"unsupported expression in Apply: {x!r}")
        inner_pred = None
        pairs: list[tuple[Expr, Expr]] = []      # (outer RESOLVED, inner)
        residuals: list[Expr] = []               # resolved in comb
        for c in _conjuncts(stmt.where) if stmt.where is not None else []:
            try:
                rc = inner_res(c)
                inner_pred = rc if inner_pred is None \
                    else Call("and", (inner_pred, rc))
                continue
            except PlanError:
                pass
            matched = False
            if isinstance(c, Call) and c.op == "eq" and len(c.args) == 2:
                a, b = c.args
                for ie, oe in ((a, b), (b, a)):
                    try:
                        rie = inner_res(ie)
                        roe = outer_res(oe)
                    except PlanError:
                        continue
                    pairs.append((roe, rie))
                    matched = True
                    break
            if matched:
                continue
            try:
                residuals.append(comb_res(c))
            except PlanError:
                return None         # references neither scope fully
        if not pairs and not residuals:
            return None             # uncorrelated: not this path
        if inner_pred is not None:
            subplan = FilterNode(children=[subplan], pred=inner_pred,
                                 schema=subplan.schema)
        holder[0], rid = self._ensure_col(holder[0],
                                          Call("__row_index", ()))
        lkeys, rkeys = [], []
        for roe, rie in pairs:
            holder[0], k = self._ensure_col(holder[0], roe)
            lkeys.append(k)
            subplan, k2 = self._ensure_col(subplan, rie)
            rkeys.append(k2)
        if lkeys:
            jn = JoinNode(children=[holder[0], subplan], how="inner",
                          left_keys=lkeys, right_keys=rkeys,
                          schema=_join_schema(holder[0], subplan, "inner"))
            self._maybe_dense_join(jn)
        else:
            jn = JoinNode(children=[holder[0], subplan], how="cross",
                          schema=_join_schema(holder[0], subplan, "cross"))
        jn.subquery_right = True
        mid: PlanNode = jn
        if residuals:
            pred = None
            for rc in residuals:
                pred = rc if pred is None else Call("and", (pred, rc))
            mid = FilterNode(children=[mid], pred=pred, schema=mid.schema)
        # per-outer-row aggregation over the row identity
        spec_in = None
        vname = self._tmp("av")
        if item.args:
            try:
                varg = comb_res(item.args[0])
            except PlanError:
                return None
            mid, spec_in = self._ensure_col(mid, varg)
        op = "count_star" if (isinstance(item, AggCall) and
                              item.op == "count_star") else item.op
        distinct = bool(getattr(item, "distinct", False))
        at = mid.schema.field(spec_in).ltype if spec_in else LType.INT64
        ridk = self._tmp("ark")
        keep = ProjectNode(
            children=[mid],
            exprs=[ColRef(rid)] + ([ColRef(spec_in)] if spec_in else []),
            names=[ridk] + ([spec_in] if spec_in else []),
            schema=Schema(tuple([Field(ridk, LType.INT64)] +
                                ([mid.schema.field(spec_in)]
                                 if spec_in else []))))
        keep.derived = True          # outer pushdown stops here
        agg = AggNode(
            children=[keep], key_names=[ridk],
            specs=[AggSpec(op, spec_in, vname, distinct=distinct)],
            strategy="sorted", max_groups=0,
            schema=Schema((Field(ridk, LType.INT64),
                           Field(vname, agg_result_type(
                               "count" if op == "count_star" else op, at)))))
        # join the per-row value back by row identity
        jb = JoinNode(children=[holder[0], agg], how="left",
                      left_keys=[rid], right_keys=[ridk],
                      schema=_join_schema(holder[0], agg, "left"))
        jb.subquery_right = True
        holder[0] = jb
        scope.extras[vname] = agg.schema.field(vname).ltype
        if is_bare_count:
            return Call("ifnull", (ColRef(vname), Lit(0)))
        return ColRef(vname)

    def _ensure_col(self, plan: PlanNode, e: Expr) -> tuple[PlanNode, str]:
        """Make expr available as a named column (hidden projection)."""
        if isinstance(e, ColRef):
            return plan, e.name
        name = self._tmp("jx")
        keep = [f.name for f in plan.schema.fields]
        sch = Schema(tuple(list(plan.schema.fields) +
                           [Field(name, infer_type(e, plan.schema))]))
        plan = ProjectNode(children=[plan],
                           exprs=[ColRef(n) for n in keep] + [e],
                           names=keep + [name], schema=sch)
        return plan, name

    def _plan_windows(self, plan, named_items, order_items):
        """Extract WindowCalls -> WindowNode(s), one per (partition, order)
        signature; window inputs become hidden projected columns."""
        raise NotPortedError("window functions (ops/window)")

        sch = plan.schema
        wins: list[WindowCall] = []

        def note(e):
            for x in walk(e):
                if isinstance(x, WindowCall) and not any(x.equals(w) for w in wins):
                    wins.append(x)

        for _, e in named_items:
            note(e)
        for e, _ in order_items:
            note(e)

        pre_names: list[str] = []
        pre_exprs: list[Expr] = []

        def as_col(e: Expr) -> str:
            if isinstance(e, ColRef):
                return e.name
            for n2, e2 in zip(pre_names, pre_exprs):
                if e2.equals(e):
                    return n2
            n2 = self._tmp("w")
            pre_names.append(n2)
            pre_exprs.append(e)
            return n2

        groups: dict[tuple, list[tuple[WindowCall, WinSpec]]] = {}
        group_meta: dict[tuple, tuple[list[str], list[tuple[str, bool]]]] = {}
        out_map: list[tuple[WindowCall, str]] = []
        for w in wins:
            pnames = [as_col(p) for p in w.partition_by]
            okeys = [(as_col(x), asc) for x, asc in w.order_by]
            sig = (tuple(pnames), tuple(okeys))
            out = self._tmp("wf")
            spec = self._win_spec(w, out, as_col)
            groups.setdefault(sig, []).append((w, spec))
            group_meta[sig] = (pnames, okeys)
            out_map.append((w, out))

        if pre_exprs:
            keep = [f.name for f in sch.fields]
            exprs = [ColRef(n) for n in keep] + pre_exprs
            names = keep + pre_names
            psch = Schema(tuple(list(sch.fields) +
                                [Field(n, infer_type(e, sch))
                                 for n, e in zip(pre_names, pre_exprs)]))
            plan = ProjectNode(children=[plan], exprs=exprs, names=names,
                               schema=psch)
            sch = psch

        for sig, pairs in groups.items():
            pnames, okeys = group_meta[sig]
            specs = [sp for _, sp in pairs]
            new_fields = list(sch.fields)
            for w, sp in pairs:
                lt = self._win_result_type(w, sch)
                new_fields.append(Field(sp.out_name, lt))
            sch = Schema(tuple(new_fields))
            plan = WindowNode(children=[plan], partition_names=pnames,
                              order_keys=okeys, specs=specs, schema=sch)

        def rewrite(e: Expr) -> Expr:
            for w, out in out_map:
                if e.equals(w):
                    return ColRef(out)
            if isinstance(e, Call):
                return Call(e.op, tuple(rewrite(x) for x in e.args))
            if isinstance(e, AggCall):
                return AggCall(e.op, tuple(rewrite(x) for x in e.args), e.distinct)
            return e

        named_items = [(n, rewrite(e)) for n, e in named_items]
        order_items = [(rewrite(e), asc) for e, asc in order_items]
        return plan, named_items, order_items

    def _win_spec(self, w: WindowCall, out: str, as_col):
        raise NotPortedError("window functions (ops/window)")

        op = w.op
        if op in ("row_number", "rank", "dense_rank"):
            return WinSpec(op, None, out)
        if op == "ntile":
            if not (w.args and isinstance(w.args[0], Lit)):
                raise PlanError("NTILE requires a literal bucket count")
            return WinSpec(op, None, out, n=int(w.args[0].value))
        if op in ("lead", "lag"):
            if not 1 <= len(w.args) <= 3:
                raise PlanError(f"{op} takes 1-3 arguments")
            inp = as_col(w.args[0])
            offset = 1
            default = None
            if len(w.args) > 1:
                if not isinstance(w.args[1], Lit):
                    raise PlanError(f"{op} offset must be a literal")
                offset = int(w.args[1].value)
            if len(w.args) > 2:
                if not isinstance(w.args[2], Lit):
                    raise PlanError(f"{op} default must be a literal")
                default = w.args[2].value
            return WinSpec(op, inp, out, offset=offset, default=default)
        frame = w.frame or None     # () = none; MySQL ignores frames on
        #                             ranking functions, so only the
        #                             frame-aware ops below receive it
        if frame is not None and frame[0] == "range" and not w.order_by:
            raise PlanError("RANGE frames require ORDER BY")
        if op in ("first_value", "last_value"):
            if len(w.args) != 1:
                raise PlanError(f"{op} takes exactly one argument")
            return WinSpec(op, as_col(w.args[0]), out, running=w.running,
                           frame=frame)
        if op in ("sum", "avg", "min", "max"):
            if len(w.args) != 1:
                raise PlanError(f"window {op} takes exactly one argument")
            return WinSpec(op, as_col(w.args[0]), out, running=w.running,
                           frame=frame)
        if op == "count":
            inp = as_col(w.args[0]) if w.args else None
            return WinSpec("count", inp, out, running=w.running,
                           frame=frame)
        raise PlanError(f"unsupported window function {op!r}")

    def _win_result_type(self, w: WindowCall, sch: Schema) -> LType:
        if w.op in ("row_number", "rank", "dense_rank", "ntile", "count"):
            return LType.INT64
        if w.op in ("lead", "lag", "first_value", "last_value", "min", "max"):
            return infer_type(w.args[0], sch)
        if w.op == "avg":
            return LType.FLOAT64
        if w.op == "sum":
            at = infer_type(w.args[0], sch)
            return LType.INT64 if at.is_integer else LType.FLOAT64
        return LType.FLOAT64

    def _group_strategy(self, plan, sch: Schema, key_names: list[str]):
        """dense (segment_sum over known domains) vs sorted fallback.

        Dense applies when every key is a dictionary column (dense codes by
        construction) or an integer with host statistics showing a small
        min..max span; mirrors how the reference picks hash-agg layouts from
        statistics (ExecTypeAnalyzer + statistics adjust,
        src/physical_plan/exec_type_analyzer.cpp:42-51)."""
        if not key_names:
            return "scalar", [], 0, {}
        domains: list[int] = []
        key_shift: dict[str, int] = {}
        total = 1
        for kn in key_names:
            f = sch.field(kn)
            st = self._key_stats(plan, kn)
            if f.ltype is LType.STRING and st is not None and "dict_size" in st:
                domains.append(st["dict_size"])
            elif f.ltype.is_integer and st is not None and st.get("min") is not None:
                span = int(st["max"]) - int(st["min"]) + 1
                if span <= 0 or span > int(FLAGS.dense_group_domain_max):
                    return self._sorted_strategy(plan, key_names)
                domains.append(span)
                if int(st["min"]) != 0:
                    key_shift[kn] = int(st["min"])
            else:
                return self._sorted_strategy(plan, key_names)
            total *= domains[-1] + 1
            if total > int(FLAGS.dense_group_domain_max):
                return self._sorted_strategy(plan, key_names)
        return "dense", domains, 0, key_shift

    def _sorted_strategy(self, plan, key_names):
        return "sorted", [], 0, {}   # max_groups resolved at exec from batch size

    def _key_scan(self, plan: PlanNode, qualified: str,
                  for_unique: bool = False):
        """Trace a column through Project/Filter/Join chains to its Scan.
        -> (table_key, col) or None.

        Value BOUNDS (min/max/dict_size) survive any join: a join output
        column's values are a subset of its source scan's.  UNIQUENESS only
        survives chains that preserve probe-row multiplicity — the probe
        side of a dense (unique-build) or semi/anti join (how the
        orders⋈customer⋈lineitem chain keeps o_orderkey unique for the
        next join up); ``for_unique`` selects that stricter walk."""
        node = plan
        while True:
            if isinstance(node, ScanNode):
                if "." not in qualified:
                    return None
                lbl, col = qualified.split(".", 1)
                if lbl != node.label:
                    return None
                return node.table_key, col
            if isinstance(node, (FilterNode,)) and node.children:
                node = node.children[0]
                continue
            if isinstance(node, AggNode) and node.children:
                # a group key in the agg OUTPUT: values are a subset of the
                # input (stats hold); a SINGLE group key is unique per
                # output row by construction (the q18 IN-subquery shape:
                # SELECT l_orderkey ... GROUP BY l_orderkey HAVING ...)
                if qualified not in node.key_names:
                    return None
                if for_unique:
                    # unique by construction, independent of any index
                    return ("", "__agg_unique__") \
                        if len(node.key_names) == 1 else None
                node = node.children[0]
                continue
            if isinstance(node, JoinNode) and len(node.children) == 2:
                if for_unique:
                    probe = node.children[0]
                    if (node.strategy == "dense" or
                            node.how in ("semi", "anti")) and \
                            any(f.name == qualified
                                for f in probe.schema.fields):
                        node = probe
                        continue
                    return None
                side = next((c for c in node.children
                             if any(f.name == qualified
                                    for f in c.schema.fields)), None)
                if side is None:
                    return None
                node = side
                continue
            if isinstance(node, ProjectNode) and node.children:
                # pass through identity projections of the column
                for n, e in zip(node.names, node.exprs):
                    if n == qualified and isinstance(e, ColRef):
                        qualified = e.name
                        break
                    if n == qualified and not for_unique and \
                            isinstance(e, Call) and e.op == "year" and \
                            len(e.args) == 1 and isinstance(e.args[0], ColRef):
                        # YEAR(date) is monotone: bounds derive from the
                        # date column's (uniqueness does not — not injective)
                        hit = self._key_scan(node.children[0], e.args[0].name)
                        if hit is None:
                            return None
                        return hit + ("year",)
                else:
                    if qualified not in node.names:
                        node = node.children[0]
                        continue
                    return None
                node = node.children[0]
                continue
            return None

    def _key_stats(self, plan: PlanNode, qualified: str) -> Optional[dict]:
        """Host-side column stats for group keys, traced back to the scan
        (with YEAR() bounds derived from the underlying date column)."""
        hit = self._key_scan(plan, qualified)
        if hit is None or self.stats_fn is None:
            return None
        st = self.stats_fn(*hit[:2])
        if st and len(hit) > 2 and hit[2] == "year":
            if st.get("min") is None:
                return None
            import datetime
            epoch = datetime.date(1970, 1, 1)
            d = datetime.timedelta
            st = {"min": (epoch + d(days=int(st["min"]))).year,
                  "max": (epoch + d(days=int(st["max"]))).year}
        return st

    def _key_unique(self, plan: PlanNode, qualified: str) -> bool:
        """True when the column is a declared single-column PRIMARY/UNIQUE
        key of its scan's table (reference: JoinTypeAnalyzer consulting
        index metadata, join_type_analyzer.cpp)."""
        hit = self._key_scan(plan, qualified, for_unique=True)
        if hit is None:
            return False
        table_key, col = hit[:2]
        if col == "__agg_unique__":
            return True        # a single group key is unique per agg row
        db, _, name = table_key.partition(".")
        try:
            info = self.catalog.get_table(db, name)
        except Exception:
            return False
        for ix in info.indexes:
            if ix.columns == [col] and ix.kind in ("primary", "unique") and \
                    ix.params.get("state", "public") == "public":
                return True
        return False

    def _dense_key_domain(self, side: PlanNode, key: str):
        """(lo, span) when ``key`` on ``side`` is a unique integer key with
        a stats-bounded dense domain; None otherwise."""
        dom = self._dense_key_domain_multi(side, [key])
        if dom is None:
            return None
        return dom[0][0], dom[1][0]

    def _agg_keyset_unique(self, side: PlanNode, keys: list[str]) -> bool:
        """True when ``side`` is (a Project/Filter chain over) an AggNode
        whose FULL group-key set maps to ``keys`` — group-key combinations
        are unique per output row by construction (the decorrelated
        correlated-aggregate shape: join back on ALL correlation keys)."""
        names = list(keys)
        node = side
        while True:
            if isinstance(node, AggNode):
                return set(names) == set(node.key_names)
            if isinstance(node, FilterNode) and node.children:
                node = node.children[0]
                continue
            if isinstance(node, ProjectNode) and node.children:
                mapped = []
                for want in names:
                    for n, e in zip(node.names, node.exprs):
                        if n == want and isinstance(e, ColRef):
                            mapped.append(e.name)
                            break
                    else:
                        return False
                names = mapped
                node = node.children[0]
                continue
            return False

    def _dense_key_domain_multi(self, side: PlanNode, keys: list[str],
                                need_unique: bool = True):
        """([lo...], [span...]) when ``keys`` on ``side`` are integer
        columns with stats-bounded domains whose PRODUCT is a small dense
        space, and — unless ``need_unique`` is False (semi/anti existence
        probes) — the key SET is unique: single-column primary/unique, the
        exact composite primary/unique index (partsupp's shape), or the
        full group-key set of an aggregate.  None otherwise."""
        los: list[int] = []
        spans: list[int] = []
        total = 1
        for key in keys:
            try:
                f = side.schema.field(key)
            except Exception:
                return None
            if not (f.ltype.is_integer or f.ltype is LType.DATE):
                return None
            st = self._key_stats(side, key)
            if not st or st.get("min") is None:
                return None
            span = int(st["max"]) - int(st["min"]) + 1
            if span <= 0:
                return None
            total *= span
            if total > int(FLAGS.dense_join_span_max):
                return None
            los.append(int(st["min"]))
            spans.append(span)
        if not need_unique or self._agg_keyset_unique(side, keys):
            return los, spans
        if len(keys) == 1:
            if not self._key_unique(side, keys[0]):
                return None
            return los, spans
        # composite: every key must trace (uniqueness-preserving walk) to
        # the SAME scan, and that table must declare the exact column set
        # as a primary/unique index
        hits = [self._key_scan(side, k, for_unique=True) for k in keys]
        if any(h is None for h in hits):
            return None
        tables = {h[0] for h in hits}
        if len(tables) != 1:
            return None
        db, _, name = hits[0][0].partition(".")
        cols = {h[1] for h in hits}
        try:
            info = self.catalog.get_table(db, name)
        except Exception:
            return None
        for ix in info.indexes:
            if ix.kind in ("primary", "unique") and set(ix.columns) == cols \
                    and len(ix.columns) == len(keys) and \
                    ix.params.get("state", "public") == "public":
                return los, spans
        return None

    def _maybe_dense_join(self, node: JoinNode) -> None:
        """Upgrade a sort join to a dense PK-FK join (ops/join.dense_join)
        when the BUILD (right) side's single key is unique with statistics
        bounding it to a small dense span.  An INNER join whose PK side
        landed on the LEFT is swapped first — inner is symmetric, and the
        FK side is the one that must stay probe-shaped (the reference's
        JoinTypeAnalyzer picking which side drives the index join).  Baked
        at plan time; the version-keyed plan cache replans when data (and
        so stats) change."""
        if node.how not in ("inner", "left", "semi", "anti"):
            return
        if len(node.right_keys) not in (1, 2) or node.residual is not None:
            return
        dom = self._dense_key_domain_multi(
            node.children[1], node.right_keys,
            # semi/anti probe EXISTENCE: duplicate build keys are fine
            need_unique=node.how not in ("semi", "anti"))
        if dom is None and node.how == "inner" and \
                not getattr(node, "subquery_right", False):
            dom = self._dense_key_domain_multi(node.children[0],
                                               node.left_keys)
            if dom is not None:
                node.children = [node.children[1], node.children[0]]
                node.left_keys, node.right_keys = (node.right_keys,
                                                   node.left_keys)
                node.schema = _join_schema(node.children[0],
                                           node.children[1], "inner")
        if dom is None:
            return
        # the PROBE side's key types must be integer-exact too: a float FK
        # would truncate into a slot and "match" rows the sort join's typed
        # comparison would reject (5.5 = 5)
        for lk in node.left_keys:
            try:
                lf = node.children[0].schema.field(lk)
            except Exception:
                return
            if not (lf.ltype.is_integer or lf.ltype is LType.DATE):
                return
        node.strategy = "dense"
        node.dense_lo, node.dense_span = dom

    # ------------------------------------------------------------------
    def _prune_columns(self, plan: PlanNode):
        """ColumnsPrune analog: restrict every Scan to columns referenced
        above it."""
        used: set[str] = set()

        def collect(node: PlanNode):
            if isinstance(node, ScanNode):
                if node.pushed_filter is not None:
                    used.update(r.name for r in walk(node.pushed_filter)
                                if isinstance(r, ColRef))
                return
            if isinstance(node, FilterNode) and node.pred is not None:
                used.update(r.name for r in walk(node.pred) if isinstance(r, ColRef))
            elif isinstance(node, ProjectNode):
                for e in node.exprs:
                    used.update(r.name for r in walk(e) if isinstance(r, ColRef))
            elif isinstance(node, JoinNode):
                used.update(node.left_keys)
                used.update(node.right_keys)
                if node.neq is not None:
                    used.update(node.neq)
                if node.residual is not None:
                    used.update(r.name for r in walk(node.residual)
                                if isinstance(r, ColRef))
            elif isinstance(node, AggNode):
                used.update(node.key_names)
                used.update(s.input for s in node.specs if s.input)
            elif isinstance(node, WindowNode):
                used.update(node.partition_names)
                used.update(k for k, _ in node.order_keys)
                used.update(s.input for s in node.specs if s.input)
            elif isinstance(node, MembershipNode):
                used.add(node.key_col)
            elif isinstance(node, SortNode):
                used.update(k for k, _ in node.keys)
            for c in node.children:
                collect(c)

        collect(plan)

        def apply(node: PlanNode, required: set[str]):
            if isinstance(node, ScanNode):
                if node.pushed_filter is not None:
                    required = required | {r.name for r in walk(node.pushed_filter)
                                           if isinstance(r, ColRef)}
                keep = [c for c in node.columns
                        if f"{node.label}.{c}" in required]
                if not keep and node.columns:
                    # COUNT(*)-style scans still need row extent: keep the
                    # narrowest column
                    keep = [min(node.columns,
                                key=lambda c: node.schema.field(f"{node.label}.{c}")
                                .ltype.np_dtype.itemsize)]
                node.columns = keep
                keep_q = {f"{node.label}.{c}" for c in keep}
                node.schema = Schema(tuple(f for f in node.schema.fields
                                           if f.name in keep_q))
                return
            if isinstance(node, ProjectNode):
                for c in node.children:
                    sub = set()
                    for e in node.exprs:
                        sub.update(r.name for r in walk(e) if isinstance(r, ColRef))
                    apply(c, sub)
                return
            for c in node.children:
                apply(c, required | used)

        # required at the top = everything referenced anywhere (conservative,
        # Project nodes narrow it on the way down)
        apply(plan, set(used))


# ----------------------------------------------------------------------


class _Resolver:
    def __init__(self, scope: Scope):
        self.scope = scope

    def __call__(self, e: Optional[Expr]) -> Optional[Expr]:
        if e is None:
            return None
        if isinstance(e, ColRef):
            q, _ = self.scope.resolve(e.name, e.table)
            return ColRef(q)
        if isinstance(e, AggCall):
            return AggCall(e.op, tuple(self(a) for a in e.args), e.distinct)
        if isinstance(e, WindowCall):
            return WindowCall(e.op, tuple(self(a) for a in e.args),
                              tuple(self(a) for a in e.partition_by),
                              tuple((self(x), asc) for x, asc in e.order_by),
                              e.running, e.frame)
        if isinstance(e, Call):
            if e.op in ("l2_distance", "cosine_distance", "inner_product"):
                return self._vector_distance(e)
            return Call(e.op, tuple(self(a) for a in e.args))
        return e

    def _vector_distance(self, e: Call) -> Expr:
        """Expand a distance call over the vector's component columns: the
        ANN score becomes a plain arithmetic expression that fuses into the
        jitted program — `ORDER BY L2_DISTANCE(col, '[...]') LIMIT k` rides
        the existing top-k, WHERE filters, joins, the mesh (reference routes
        ANN through a faiss sidecar, vector_index.cpp:2341)."""
        if len(e.args) != 2 or not isinstance(e.args[0], ColRef) or \
                not isinstance(e.args[1], Lit):
            raise PlanError(f"{e.op.upper()}(vector_column, '[...]') "
                            "expected")
        ref, lit = e.args
        key = None
        if ref.table is not None:
            key = f"{ref.table}.{ref.name}"
            if key not in self.scope.vector_cols:
                raise PlanError(f"{key} is not a VECTOR column")
        else:
            hits = [k for k in self.scope.vector_cols
                    if k.endswith(f".{ref.name}")]
            if not hits:
                raise PlanError(f"{ref.name!r} is not a VECTOR column")
            if len(hits) > 1:
                raise PlanError(f"ambiguous vector column {ref.name!r}")
            key = hits[0]
        dim, comps = self.scope.vector_cols[key]
        raise NotPortedError("vector distance expressions")
        q = _parse_vector(lit.value, dim)

        def add_all(terms):
            out = terms[0]
            for t in terms[1:]:
                out = Call("add", (out, t))
            return out

        if e.op == "l2_distance":
            return Call("sqrt", (add_all([
                Call("mul", (d := Call("sub", (ColRef(c), Lit(float(qi)))), d))
                for c, qi in zip(comps, q)]),))
        dot = add_all([Call("mul", (ColRef(c), Lit(float(qi))))
                       for c, qi in zip(comps, q)])
        if e.op == "inner_product":
            return dot
        # cosine_distance = 1 - dot/(|a| * |q|)
        norm_a = Call("sqrt", (add_all([
            Call("mul", (ColRef(c), ColRef(c))) for c in comps]),))
        qn = float(sum(x * x for x in q) ** 0.5) or 1.0
        return Call("sub", (Lit(1.0), Call("div", (dot, Call("mul", (
            norm_a, Lit(qn)))))))


def _colrefs(e: Expr) -> set[str]:
    """All column names referenced by an (already-resolved) expression."""
    out: set[str] = set()

    def walk(x):
        if isinstance(x, ColRef):
            out.add(x.name)
        elif isinstance(x, (Call, AggCall)):
            for a in x.args:
                walk(a)

    walk(e)
    return out


# the one AND-splitting primitive lives in plan/eqclasses.py; this alias
# keeps the planner's historical name for its many call sites
from .eqclasses import conjuncts as _conjuncts  # noqa: E402


def _equi_pair(e: Expr, lcols: set, rcols: set) -> Optional[tuple[str, str]]:
    if not (isinstance(e, Call) and e.op == "eq"):
        return None
    a, b = e.args
    if not (isinstance(a, ColRef) and isinstance(b, ColRef)):
        return None
    if a.name in lcols and b.name in rcols:
        return a.name, b.name
    if b.name in lcols and a.name in rcols:
        return b.name, a.name
    return None


def _join_schema(left: PlanNode, right: PlanNode, how: str) -> Schema:
    if how in ("semi", "anti"):
        return left.schema
    fields = list(left.schema.fields)
    names = {f.name for f in fields}
    for f in right.schema.fields:
        name = f.name if f.name not in names else f.name + "_r"
        nullable = True if how == "left" else f.nullable
        fields.append(Field(name, f.ltype, nullable))
    return Schema(tuple(fields))


def _pushable_children(node: PlanNode):
    """Children that share the outer query's row stream: subquery subplans
    (semi/anti right sides, scalar sources) are separate scopes and must not
    receive outer predicates even when labels collide."""
    if isinstance(node, ScalarSourceNode):
        return node.children[:1]
    if isinstance(node, JoinNode) and getattr(node, "subquery_right", False):
        return node.children[:1]
    if isinstance(node, ProjectNode) and node.derived:
        return []
    return node.children


def _push_into_scans(node: PlanNode, pushed: dict[str, Expr]):
    if isinstance(node, ScanNode):
        if node.label in pushed:
            p = pushed[node.label]
            node.pushed_filter = p if node.pushed_filter is None else \
                Call("and", (node.pushed_filter, p))
        return
    # do not push through joins' right side for left joins: planner already
    # excluded those labels
    for c in _pushable_children(node):
        _push_into_scans(c, pushed)


def _contains_agg(e: Expr) -> bool:
    return any(isinstance(x, AggCall) for x in walk(e))


def _display_name(e: Expr) -> str:
    if isinstance(e, ColRef):
        return e.name.split(".")[-1] if e.table is None else e.name
    return repr(e)


def copy_stmt_without_ctes(stmt: SelectStmt) -> SelectStmt:
    import copy
    s = copy.copy(stmt)
    s.ctes = []
    return s


def dreplace_union(stmt: SelectStmt) -> SelectStmt:
    """Bare-arm copy: no union link, no ORDER BY/LIMIT (those bind to the
    union result, not the arm)."""
    import copy
    s = copy.copy(stmt)
    s.union = None
    s.order_by = []
    s.limit = None
    s.offset = 0
    return s
