"""Plan executor: run the plan IR as eager torch operators on one device.

The port of the single-device part of ``baikaldb_tpu/exec/executor.py``.
PyTorch runs eagerly, so there is no program to trace: ``compile_plan``
returns a function that walks the plan over the table batches.  Torch needs
no static shapes either: a join emits exactly its matched rows (one host
read of the match total per expanding join, ops/join.py), so there are no
join capacities and no overflow-retry loop, and ``ShrinkNode`` (a capacity
cut that exists for XLA) passes its child through.  A scalar subquery reads
its live row count to the host and raises "Subquery returns more than 1
row" at once, where the JAX session checks the count after the program ran.

One run evaluates each derived table or CTE body once: copies of one body
(TPC-H q15 reads its ``revenue`` view twice) share the first copy's batch.
Float sums on the card come from atomic adds and are not bitwise repeatable,
so two evaluations of one view could differ in the last bit, and q15's
``total_revenue = (SELECT MAX(total_revenue) FROM revenue)`` would lose its
row.  The JAX package evaluates both copies, with the same result, because
its sums are deterministic.

Ported nodes: Scan (with its pushed filter), Filter, Shrink, Project, Join
(cross, EXISTS-with-<>, dense PK-FK, sort join), Union, Membership (SQL
three-valued IN / NOT IN), ScalarSource, Agg (scalar, dense with
``key_shift``, sorted), Distinct, Sort (with top-k), Limit and Values.
Every other node (the mesh's Exchange and MultiJoin, Window, the streamed
result) raises :class:`NotPortedError`.
"""

from __future__ import annotations

import re
from dataclasses import replace as dreplace
from typing import Callable

import numpy as np
import torch

from ..column.batch import Column, ColumnBatch, concat_batches
from ..column.dictionary import Dictionary
from ..errors import NotPortedError
from ..expr.compile import cast_column, eval_output, eval_predicate
from ..ops import join as join_ops
from ..ops.compact import compact, head
from ..ops.hashagg import (group_aggregate_dense, group_aggregate_sorted,
                           scalar_aggregate)
from ..ops.sort import SortKey, sort_batch, top_k
from ..plan.nodes import (AggNode, DistinctNode, FilterNode, JoinNode,
                          LimitNode, MembershipNode, PlanNode, ProjectNode,
                          ScalarSourceNode, ScanNode, ShrinkNode, SortNode,
                          UnionNode, ValuesNode, plan_signature)
from ..plan.planner import PlanError
from ..types import LType


class ExecError(RuntimeError):
    pass


def compile_plan(plan: PlanNode, device) -> Callable:
    """-> fn(table_batches: dict) -> ColumnBatch, run on ``device``."""
    device = torch.device(device)

    def run(batches: dict) -> ColumnBatch:
        return _eval(plan, batches, device, {})

    return run


def derived_key(node: ProjectNode) -> str:
    """The plan signature of a derived table or CTE body with the names the
    planner generated while planning it (``node.generated``: ``__a0``,
    ``__ai1`` ...) renumbered by first appearance: two copies of one body,
    planned with different generated names, get the same key.  A generated
    name that is also a column some scan of the body reads is left as it is,
    so a table's own columns always count."""
    scanned: set = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ScanNode):
            scanned.update(n.columns)
        stack.extend(n.children)
    names = sorted(node.generated - scanned, key=lambda n: (-len(n), n))
    text = repr(plan_signature(node))
    if not names:
        return text
    seen: dict = {}
    token = re.compile(r"(?<![A-Za-z0-9_])(?:" + "|".join(map(re.escape, names))
                       + r")(?![A-Za-z0-9_])")
    return token.sub(lambda m: seen.setdefault(m.group(0), f"__#{len(seen)}"), text)


def _shift_keys(b: ColumnBatch, shift: dict, sign: int) -> ColumnBatch:
    """Add ``sign * min`` to each shifted dense key (planner ``key_shift``)."""
    cols = list(b.columns)
    for kn, mn in shift.items():
        i = b.names.index(kn)
        c = cols[i]
        cols[i] = dreplace(c, data=c.data + torch.tensor(sign * mn, dtype=c.data.dtype,
                                                         device=c.data.device))
    return ColumnBatch(b.names, cols, b.sel, b.num_rows, device=b.device)


def _eval(node: PlanNode, batches: dict, device, memo: dict) -> ColumnBatch:
    """``memo``: derived_key -> batch of the derived-table bodies evaluated
    so far in this run."""
    if isinstance(node, ProjectNode) and node.derived:
        key = derived_key(node)
        if key not in memo:
            memo[key] = _eval_node(node, batches, device, memo)
        b = memo[key]
        # this copy's own output names (generated names may differ)
        return ColumnBatch(tuple(node.names), b.columns, b.sel, b.num_rows,
                           device=b.device)
    return _eval_node(node, batches, device, memo)


def _eval_node(node: PlanNode, batches: dict, device, memo: dict) -> ColumnBatch:
    if isinstance(node, ScanNode):
        b = batches[node.table_key]
        names = tuple(f"{node.label}.{c}" for c in node.columns)
        cols = [b.column(c) for c in node.columns]
        out = ColumnBatch(names, cols, b.sel, b.num_rows,
                          live_prefix=b.live_prefix, device=b.device)
        if node.pushed_filter is not None:
            out = out.and_sel(eval_predicate(node.pushed_filter, out))
        return out

    if isinstance(node, FilterNode):
        child = _eval(node.child(), batches, device, memo)
        return child.and_sel(eval_predicate(node.pred, child))

    if isinstance(node, ShrinkNode):
        return _eval(node.child(), batches, device, memo)

    if isinstance(node, ProjectNode):
        child = _eval(node.child(), batches, device, memo)
        n = len(child)
        cols = [_broadcast(eval_output(e, child), n) for e in node.exprs]
        return ColumnBatch(tuple(node.names), cols, child.sel, child.num_rows,
                           device=child.device)

    if isinstance(node, JoinNode):
        left = _eval(node.children[0], batches, device, memo)
        right = _eval(node.children[1], batches, device, memo)
        if node.how == "cross":
            out, _ = join_ops.cross_join(left, right)
        elif node.neq is not None and node.how in ("semi", "anti"):
            # EXISTS + one <> residual: range counts, no expansion
            out, _ = join_ops.semi_join_neq(left, node.left_keys, right,
                                            node.right_keys, node.neq[0],
                                            node.neq[1], how=node.how)
        elif node.strategy == "dense":
            # unique-build PK-FK join: scatter/gather over the dense key
            # domain(s); the output keeps the probe's rows
            out, _ = join_ops.dense_join(left, node.left_keys, right,
                                         node.right_keys, list(node.dense_lo),
                                         list(node.dense_span), how=node.how)
        else:
            out, _ = join_ops.join(
                left, node.left_keys, right, node.right_keys, how=node.how,
                wide_keys_ok=getattr(node, "pack32_verified", False),
                build_sorted=getattr(node, "build_sorted", False))
        # label-qualified names are globally unique, no suffixing occurs
        return out

    if isinstance(node, UnionNode):
        names = tuple(f.name for f in node.schema.fields)
        parts = []
        for c in node.children:
            p = compact(_eval(c, batches, device, memo))
            parts.append(_harmonize(ColumnBatch(names, p.columns, p.sel, p.num_rows,
                                                device=p.device), node.schema))
        return concat_batches(_align_string_dicts(parts))

    if isinstance(node, MembershipNode):
        child = _eval(node.children[0], batches, device, memo)
        sub = _eval(node.children[1], batches, device, memo)
        col = join_ops.membership(child.column(node.key_col), sub, node.negate)
        return ColumnBatch(tuple(child.names) + (node.out_name,),
                           list(child.columns) + [col], child.sel, child.num_rows,
                           device=child.device)

    if isinstance(node, ScalarSourceNode):
        child = _eval(node.children[0], batches, device, memo)
        sub = compact(_eval(node.children[1], batches, device, memo))
        live = int(sub.live_count())
        if live > 1:
            # MySQL ER_SUBQUERY_NO_1_ROW (1242)
            raise PlanError("Subquery returns more than 1 row")
        n = len(child)
        names = list(child.names)
        cols = list(child.columns)
        for i, name in enumerate(node.col_names):
            c = sub.columns[i]
            if len(sub) == 0:
                # zero-capacity source: constant NULL
                v0 = torch.zeros((), dtype=c.data.dtype, device=child.device)
                val0 = torch.tensor(False, device=child.device)
            else:
                v0 = c.data[0]
                val0 = c.valid_mask()[0] & (live > 0)   # empty subquery -> NULL
            cols.append(Column(v0.expand(n), val0.expand(n), c.ltype, c.dictionary))
            names.append(name)
        return ColumnBatch(tuple(names), cols, child.sel, child.num_rows,
                           device=child.device)

    if isinstance(node, AggNode):
        child = _eval(node.child(), batches, device, memo)
        if node.merge:
            raise NotPortedError("mesh partial-aggregate merge")
        if not node.key_names:
            return scalar_aggregate(child, node.specs)
        if node.strategy == "dense":
            shift = getattr(node, "key_shift", {}) or {}
            work = _shift_keys(child, shift, -1) if shift else child
            out = group_aggregate_dense(work, node.key_names, node.domains, node.specs)
            return _shift_keys(out, shift, 1) if shift else out
        mg = node.max_groups or max(1, len(child))
        return group_aggregate_sorted(child, node.key_names, node.specs, mg)

    if isinstance(node, DistinctNode):
        child = _eval(node.child(), batches, device, memo)
        return group_aggregate_sorted(child, list(child.names), [], max(1, len(child)))

    if isinstance(node, SortNode):
        child = _eval(node.child(), batches, device, memo)
        keys = [SortKey(k, asc) for k, asc in node.keys]
        if node.limit is not None:
            out = top_k(child, keys, node.limit + node.offset)
            if node.offset:
                out = head(out, node.limit, node.offset)
            return out
        return sort_batch(child, keys)

    if isinstance(node, LimitNode):
        child = _eval(node.child(), batches, device, memo)
        return head(child, node.limit, node.offset)

    if isinstance(node, ValuesNode):
        empty = ColumnBatch((), [], None, None, device=device)
        cols = [_broadcast(eval_output(e, empty), 1) for e in node.exprs[0]]
        return ColumnBatch(tuple(node.names), cols, device=device)

    raise NotPortedError(f"plan node {type(node).__name__}")


def _broadcast(c: Column, n: int) -> Column:
    data = c.data
    if data.ndim == 0:
        data = data.expand(n)
    v = c.validity
    if v is not None and v.ndim == 0:
        v = v.expand(n)
    return dreplace(c, data=data, validity=v)


def _align_string_dicts(parts: list[ColumnBatch]) -> list[ColumnBatch]:
    """Remap string columns of UNION arms onto shared dictionaries."""
    if len(parts) < 2:
        return parts
    out = [list(p.columns) for p in parts]
    for i, c0 in enumerate(parts[0].columns):
        if c0.ltype is not LType.STRING:
            continue
        dicts = [p.columns[i].dictionary for p in parts]
        if any(d is None for d in dicts):
            raise ExecError("UNION string column lacks a dictionary")
        if all(d._id == dicts[0]._id for d in dicts):
            continue
        values = dicts[0].values
        for d in dicts[1:]:
            values = np.union1d(values, d.values)
        merged = Dictionary(values)
        for pi, p in enumerate(parts):
            c = p.columns[i]
            remap = np.searchsorted(values, c.dictionary.values).astype(np.int32)
            out[pi][i] = dreplace(c, data=join_ops._remap_codes(c.data, remap),
                                  dictionary=merged)
    return [ColumnBatch(p.names, cols, p.sel, p.num_rows, device=p.device)
            for p, cols in zip(parts, out)]


def _harmonize(p: ColumnBatch, schema) -> ColumnBatch:
    """Cast union arms to the unified schema's types."""
    cols = []
    for c, f in zip(p.columns, schema.fields):
        if c.ltype != f.ltype:
            if c.ltype is LType.STRING or f.ltype is LType.STRING:
                raise ExecError("UNION of string and non-string columns")
            c = cast_column(c, f.ltype)
        cols.append(c)
    return ColumnBatch(p.names, cols, p.sel, p.num_rows, device=p.device)
