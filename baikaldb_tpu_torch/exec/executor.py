"""Plan executor: run the plan IR as eager torch operators, on one device or
over a mesh of shards.

The port of ``baikaldb_tpu/exec/executor.py``.  PyTorch runs eagerly, so
there is no program to trace: ``compile_plan`` returns a function that walks
the plan over the table batches.  Torch needs no static shapes either: a
join emits exactly its matched rows (one host read of the match total per
expanding join, ops/join.py), so there are no join capacities and no
overflow-retry loop, and ``ShrinkNode`` (a capacity cut that exists for XLA)
passes its child through.  A scalar subquery reads its live row count to the
host and raises "Subquery returns more than 1 row" at once, where the JAX
session checks the count after the program ran.

One run evaluates each derived table or CTE body once: copies of one body
(TPC-H q15 reads its ``revenue`` view twice) share the first copy's batch.
Float sums on the card come from atomic adds and are not bitwise repeatable,
so two evaluations of one view could differ in the last bit, and q15's
``total_revenue = (SELECT MAX(total_revenue) FROM revenue)`` would lose its
row.  The JAX package evaluates both copies, with the same result, because
its sums are deterministic.

On a mesh (``compile_plan(plan, device, mesh)``, the plan distributed by
plan/distribute.py) the JAX package runs the whole plan inside one
``shard_map``.  Here the single controller evaluates it node by node: a
table scan yields a :class:`~..parallel.mesh.ShardedBatch`, a node without a
collective runs its single-device code on every shard (a replicated input
is what every shard holds of it), and the nodes the distribution pass marks
run their collective (parallel/collectives.py):

- ``Exchange(gather)``: all_gather, the replicated value;
- ``Exchange(repartition)``: hash repartition (parallel/shuffle.py), or the
  child as it is where the keyed exchange scheduler proved it partitioned;
- ``MultiJoin``: every input that needs it repartitions once, then one fused
  multiway join per shard;
- ``Agg`` with ``merge``: per-shard partials (dense or scalar), merged by
  psum / pmin / pmax; the adaptive ``agg_dist = local`` arm of a sorted
  GROUP BY pre-reduces per shard and repartitions only the partials;
- ``Sort`` with ``dist_topk``: per-shard top-k, all_gather, final top-k.

Every executed repartition is recorded in the run's ``exchanges`` (what the
session's mesh telemetry reads).

Ported nodes: all of them.  Scan (with its pushed filter), Filter, Shrink,
Project, Join (cross, EXISTS-with-<>, dense PK-FK, sort join, the radix
join under ``radix_join_buckets``), MultiJoin,
Exchange, Union, Membership (SQL three-valued IN / NOT IN), ScalarSource,
Agg (scalar, dense with ``key_shift``, sorted, the mesh merges), Distinct,
Window, Sort (with top-k), Limit and Values, and the StreamResult leaf
through which the finalize step of a streamed scan (exec/streaming.py) reads
its folded aggregate.

A join's build side, an EXISTS-with-<> build and a sorted GROUP BY take the
host presort permutation the session staged for them (``presort_input``, a
``__presort__`` key of the batches) in place of a device sort, as the JAX
executor does (``_presort_order``).

With a trace live (obs/trace.py), each executed node is one ``op.*`` span
under the caller's span (``exec.run``): its children are evaluated before
it opens, so the spans are flat and exclusive.  Its attributes are what the
host already knows (the strategy, the input rows), and on a CUDA device the
span also records its device interval.  ``ShrinkNode``, a memoised copy of
a derived table and a streamed scan's folded result are pass-throughs and
record none.  With no trace live no span is built.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from dataclasses import replace as dreplace
from typing import Callable, Optional

import numpy as np
import torch

from ..analysis.runtime import host_read
from ..column.batch import Column, ColumnBatch, concat_batches
from ..column.dictionary import Dictionary
from ..expr.compile import cast_column, eval_output, eval_predicate
from ..expr.params import PARAMS_KEY, bind_params
from ..obs import progress, trace
from ..ops import join as join_ops
from ..ops.compact import compact, head
from ..ops.hashagg import (group_aggregate_dense, group_aggregate_sorted,
                           scalar_aggregate)
from ..ops.sort import SortKey, sort_batch, top_k
from ..ops.window import window_compute
from ..parallel.agg import (dist_group_aggregate_dense,
                            dist_group_aggregate_partial_shuffled,
                            dist_scalar_aggregate)
from ..parallel.collectives import all_gather
from ..parallel.mesh import Mesh, ShardedBatch, shard_of
from ..parallel.shuffle import dist_hash_repartition
from ..plan.nodes import (AggNode, DistinctNode, ExchangeNode, FilterNode,
                          JoinNode, LimitNode, MembershipNode, MultiJoinNode,
                          PlanNode, ProjectNode, ScalarSourceNode, ScanNode,
                          ShrinkNode, SortNode, StreamResultNode, UnionNode,
                          ValuesNode, WindowNode, plan_signature)
from ..plan.planner import PlanError
from ..types import LType
from ..utils.flags import FLAGS, define

define("radix_join_buckets", 0,
       "hash-partition sort-join builds into this many buckets (power of "
       "two; 0 = off): per-bucket sorts replace the one global sort "
       "(ops/radix.py)")
define("radix_join_min_build", 65536,
       "radix-partition joins only engage for builds at least this large")


class ExecError(RuntimeError):
    pass


@dataclass
class Ctx:
    """One run's state: its device (and mesh), the derived-table batches
    evaluated so far (``derived_key`` -> batch), the executed exchanges
    ((ExchangeNode | JoinNode | MultiJoinNode | site name, rows) pairs),
    when EXPLAIN ANALYZE counts, each node's live output rows (``id(node)``
    -> 0-d tensor, summed over the shards of a sharded value), whether a
    trace was live when the run started (one ``op.*`` span a node), and on
    a CUDA device the stream on which the spans record their intervals."""

    device: torch.device
    mesh: Optional[Mesh] = None
    batches: dict = field(default_factory=dict)
    memo: dict = field(default_factory=dict)
    exchanges: list = field(default_factory=list)
    counts: Optional[dict] = None
    traced: bool = False
    stream: object = None


def device_params(values, device) -> tuple:
    """The bound params (plan/paramize.py ``bind``: numpy scalars, or
    ``[2]`` code bounds of a strcmp slot) as tensors on ``device``, one
    transfer a slot."""
    return tuple(torch.as_tensor(v, device=device) for v in values)


def compile_plan(plan: PlanNode, device, mesh: Optional[Mesh] = None,
                 count_rows: bool = False) -> Callable:
    """-> fn(table_batches: dict) -> ColumnBatch, run on ``device``, or over
    ``mesh`` (the table batches then are ShardedBatches and the result is
    replicated on ``mesh.home``).  ``fn.exchanges`` holds the last run's
    executed exchanges.  A parameterized plan's bound values ride the
    batches under ``PARAMS_KEY`` (expr/params.py); every ``Param`` reads
    its slot.  With ``count_rows`` the run also keeps each node's live
    output rows in ``fn.counts`` (``id(node)`` -> int, one host read after
    the run): the EXPLAIN ANALYZE feed."""
    device = torch.device(device)

    def run(batches: dict) -> ColumnBatch:
        traced = trace.active()
        ctx = Ctx(device, mesh, batches, counts={} if count_rows else None, traced=traced,
                  stream=torch.cuda.current_stream(device)
                  if traced and device.type == "cuda" else None)
        run.exchanges = ctx.exchanges
        params = batches.get(PARAMS_KEY)
        with bind_params(device_params(params, device) if params is not None else ()):
            out = _eval(plan, batches, ctx)
        if isinstance(out, ShardedBatch):      # distribute gathers the root
            raise ExecError("a distributed plan must end replicated")
        if count_rows:
            ids = list(ctx.counts)
            vals = host_read(torch.stack([ctx.counts[i].reshape(()).to(torch.int64)
                                          for i in ids])).tolist() if ids else []
            run.counts = dict(zip(ids, vals))
        return out

    run.exchanges = []
    run.counts = {}
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
        cols[i] = dreplace(c, data=c.data + sign * mn)
    return dreplace(b, columns=cols)


def _rename(b: ColumnBatch, names) -> ColumnBatch:
    return ColumnBatch(tuple(names), b.columns, b.sel, b.num_rows, device=b.device)


def _each(value, fn):
    """``fn`` over every shard of a sharded value, or over the value."""
    if isinstance(value, ShardedBatch):
        return ShardedBatch([fn(b) for b in value.shards])
    return fn(value)


def _eval(node: PlanNode, batches: dict, ctx: Ctx):
    if isinstance(node, ProjectNode) and node.derived:
        key = derived_key(node)
        if key not in ctx.memo:
            ctx.memo[key] = _eval_node(node, batches, ctx)
        # this copy's own output names (generated names may differ)
        out = _each(ctx.memo[key], lambda b: _rename(b, node.names))
    else:
        out = _eval_node(node, batches, ctx)
    if ctx.counts is not None:
        if isinstance(out, ShardedBatch):
            ctx.counts[id(node)] = sum(b.live_count().to(torch.int64).to(ctx.device)
                                       for b in out.shards)
        else:
            ctx.counts[id(node)] = out.live_count()
    return out


def _eval_node(node: PlanNode, batches: dict, ctx: Ctx):
    if isinstance(node, StreamResultNode):
        # the chunk-folded aggregate's finalized batch (exec/streaming.py)
        return batches[node.key]
    # a scan's one input is its table's batch
    kids = [batches[node.table_key]] if isinstance(node, ScanNode) else \
        [_eval(c, batches, ctx) for c in node.children]
    if not ctx.traced or isinstance(node, ShrinkNode):
        return _run_node(node, kids, ctx)
    name, attrs = _op_span(node, kids, ctx)
    with trace.span(name, ctx.stream, **attrs):
        return _run_node(node, kids, ctx)


def _run_node(node: PlanNode, kids: list, ctx: Ctx):
    """``node`` over its evaluated children: its collective on a mesh, or
    its single-device code on every shard, or on the one device."""
    if isinstance(node, ScanNode):
        return _each(kids[0], lambda b: _scan(node, b))
    mesh = ctx.mesh
    if mesh is not None and any(isinstance(k, ShardedBatch) for k in kids):
        out = _mesh_node(node, kids, ctx)
        if out is not None:
            return out
        return ShardedBatch([_apply(node, [shard_of(k, i, mesh) for k in kids], ctx)
                             for i in range(mesh.size)])
    return _apply(node, kids, ctx)


_OP_NAMES = {ScanNode: "op.scan", FilterNode: "op.filter", ProjectNode: "op.project",
             JoinNode: "op.join", MultiJoinNode: "op.join", MembershipNode: "op.membership",
             ScalarSourceNode: "op.scalar", AggNode: "op.agg", DistinctNode: "op.distinct",
             SortNode: "op.sort", LimitNode: "op.limit", WindowNode: "op.window",
             UnionNode: "op.union", ValuesNode: "op.values", ExchangeNode: "op.exchange"}


def _rows(value) -> int:
    """Rows of a batch or of every shard of a sharded value (its shapes,
    no device read)."""
    if isinstance(value, ShardedBatch):
        return sum(len(b) for b in value.shards)
    return len(value)


def _op_span(node: PlanNode, kids: list, ctx: Ctx) -> tuple:
    """The ``op.*`` span name of ``node`` and its attributes: the strategy
    where the node has several, and the input rows, all known on the host."""
    name = _OP_NAMES[type(node)]
    attrs = {"rows": _rows(kids[0])} if kids else {}
    if isinstance(node, ScanNode):
        attrs["table"] = node.table_key
    elif isinstance(node, JoinNode):
        attrs.update(strategy=_join_route(node, kids[1], ctx), how=node.how,
                     build=_rows(kids[1]))
    elif isinstance(node, MultiJoinNode):
        attrs.update(strategy="multiway", builds=len(kids) - 1)
    elif isinstance(node, AggNode):
        # a dense GROUP BY's ``route`` is set by the code that takes it
        # (ops/hashagg.py group_aggregate_dense, through trace.annotate)
        attrs["strategy"] = "scalar" if not node.key_names else \
            "dense" if node.strategy == "dense" else "sorted"
    elif isinstance(node, ExchangeNode):
        attrs["kind"] = node.kind
    elif isinstance(node, UnionNode):
        attrs["arms"] = len(kids)
    return name, attrs


def _scan(node: ScanNode, b: ColumnBatch) -> ColumnBatch:
    names = tuple(f"{node.label}.{c}" for c in node.columns)
    cols = [b.column(c) for c in node.columns]
    out = ColumnBatch(names, cols, b.sel, b.num_rows,
                      live_prefix=b.live_prefix, device=b.device)
    if node.pushed_filter is not None:
        out = out.and_sel(eval_predicate(node.pushed_filter, out))
    return out


def _presort_order(node, ctx: Ctx, expected_len: int):
    """The host presort permutation the session staged for ``node``, or
    None when there is none or the input's positions are not the base
    table's (an access-path gather, a shard)."""
    pkey = getattr(node, "presort_input", None)
    order = ctx.batches.get(pkey) if pkey else None
    if order is not None and len(order) != expected_len:
        return None
    return order


def _join_route(node: JoinNode, right, ctx: Ctx) -> str:
    """How a binary join runs: ``cross``, ``neq`` (EXISTS with one <>),
    ``dense`` (PK-FK over the key domain), ``radix`` or ``sort``.  The radix
    join takes the JAX executor's gate: a presorted or planner-sorted build
    side, or float keys, keep the sort join."""
    if node.how == "cross":
        return "cross"
    if node.neq is not None and node.how in ("semi", "anti"):
        return "neq"
    if node.strategy == "dense":
        return "dense"
    if isinstance(right, ShardedBatch):     # the span's attribute: shard 0 decides
        right = right.shards[0]
    nb = int(FLAGS.radix_join_buckets)
    if nb >= 2 and nb & (nb - 1) == 0 and not getattr(node, "build_sorted", False) \
            and len(right) >= int(FLAGS.radix_join_min_build) \
            and _presort_order(node, ctx, len(right)) is None \
            and not any(right.column(k).ltype.is_float
                        for k in node.right_keys if k in right.names):
        return "radix"
    return "sort"


def _apply(node: PlanNode, kids: list, ctx: Ctx) -> ColumnBatch:
    """``node`` over its evaluated children, on one device (one shard)."""
    if isinstance(node, ValuesNode):
        empty = ColumnBatch((), [], None, None, device=ctx.device)
        cols = [_broadcast(eval_output(e, empty), 1) for e in node.exprs[0]]
        return ColumnBatch(tuple(node.names), cols, device=ctx.device)

    if isinstance(node, FilterNode):
        return kids[0].and_sel(eval_predicate(node.pred, kids[0]))

    if isinstance(node, ShrinkNode):
        return kids[0]

    if isinstance(node, ProjectNode):
        child = kids[0]
        n = len(child)
        cols = [_broadcast(eval_output(e, child), n) for e in node.exprs]
        return ColumnBatch(tuple(node.names), cols, child.sel, child.num_rows,
                           device=child.device)

    if isinstance(node, JoinNode):
        left, right = kids
        route = _join_route(node, right, ctx)
        if route == "cross":
            out, rows = join_ops.cross_join(left, right)
        elif route == "neq":
            # EXISTS + one <> residual: range counts, no expansion
            out, rows = join_ops.semi_join_neq(left, node.left_keys, right,
                                               node.right_keys, node.neq[0],
                                               node.neq[1], how=node.how,
                                               order=_presort_order(node, ctx, len(right)))
        elif route == "dense":
            # unique-build PK-FK join: scatter/gather over the dense key
            # domain(s); the output keeps the probe's rows
            out, rows = join_ops.dense_join(left, node.left_keys, right,
                                            node.right_keys, list(node.dense_lo),
                                            list(node.dense_span), how=node.how)
        elif route == "radix":
            out, rows, _ = join_ops.radix_join(
                left, node.left_keys, right, node.right_keys, how=node.how,
                wide_keys_ok=getattr(node, "pack32_verified", False),
                n_buckets=int(FLAGS.radix_join_buckets))
        else:
            out, rows = join_ops.join(
                left, node.left_keys, right, node.right_keys, how=node.how,
                wide_keys_ok=getattr(node, "pack32_verified", False),
                build_sorted=getattr(node, "build_sorted", False),
                order=_presort_order(node, ctx, len(right)))
        if ctx.mesh is not None and any(isinstance(c, ExchangeNode)
                                        and c.kind == "repartition"
                                        for c in node.children):
            ctx.exchanges.append((node, rows))      # a shuffle join's output
        # label-qualified names are globally unique, no suffixing occurs
        return out

    if isinstance(node, MultiJoinNode):
        out, rows = join_ops.multiway_join(
            kids[0], node.probe_keys, list(zip(kids[1:], node.build_keys)),
            list(node.hows), level_keys=node.level_keys, packs=node.packs)
        if ctx.mesh is not None:
            ctx.exchanges.append((node, rows))
        return out

    if isinstance(node, UnionNode):
        names = tuple(f.name for f in node.schema.fields)
        parts = []
        for k in kids:
            p = compact(k)
            parts.append(_harmonize(ColumnBatch(names, p.columns, p.sel, p.num_rows,
                                                device=p.device), node.schema))
        return concat_batches(_align_string_dicts(parts))

    if isinstance(node, MembershipNode):
        child, sub = kids
        col = join_ops.membership(child.column(node.key_col), sub, node.negate)
        return ColumnBatch(tuple(child.names) + (node.out_name,),
                           list(child.columns) + [col], child.sel, child.num_rows,
                           device=child.device)

    if isinstance(node, ScalarSourceNode):
        child = kids[0]
        sub = compact(kids[1])
        live = int(host_read(sub.live_count()))
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
        child = kids[0]
        if not node.key_names:
            return scalar_aggregate(child, node.specs)
        if node.strategy == "dense":
            shift = getattr(node, "key_shift", {}) or {}
            work = _shift_keys(child, shift, -1) if shift else child
            out = group_aggregate_dense(work, node.key_names, node.domains, node.specs)
            return _shift_keys(out, shift, 1) if shift else out
        mg = node.max_groups or max(1, len(child))
        return group_aggregate_sorted(child, node.key_names, node.specs, mg,
                                      order=_presort_order(node, ctx, len(child)))

    if isinstance(node, DistinctNode):
        child = kids[0]
        return group_aggregate_sorted(child, list(child.names), [], max(1, len(child)))

    if isinstance(node, WindowNode):
        keys = [SortKey(k, asc) for k, asc in node.order_keys]
        return window_compute(kids[0], node.partition_names, keys, node.specs)

    if isinstance(node, SortNode):
        child = kids[0]
        keys = [SortKey(k, asc) for k, asc in node.keys]
        if node.limit is not None:
            out = top_k(child, keys, node.limit + node.offset)
            if node.offset:
                out = head(out, node.limit, node.offset)
            return out
        return sort_batch(child, keys)

    if isinstance(node, LimitNode):
        return head(kids[0], node.limit, node.offset)

    if isinstance(node, ExchangeNode):
        raise ExecError("an Exchange runs only on a mesh: compile the plan with its mesh")

    raise ExecError(f"unknown plan node {type(node).__name__}")


# -- mesh collectives (plan/distribute.py marks the nodes) -------------------

def _mesh_node(node: PlanNode, kids: list, ctx: Ctx):
    """The nodes that run a collective, over at least one sharded input;
    None for every other node (it runs shard by shard)."""
    mesh = ctx.mesh
    # a KILL lands between exchange rounds: every operator over sharded
    # inputs starts at a cancellation point (a host seam, no device read)
    progress.current().checkpoint()
    if isinstance(node, ExchangeNode):
        child = kids[0]
        if node.kind == "gather":
            return all_gather(child.shards, mesh.home)
        if node.reused:
            # keyed exchange scheduler: the child is already hash-partitioned
            # on this key class; rows flow through, no collective
            return child
        keys = node.keys if node.keys is not None else list(child.names)
        out, needed = dist_hash_repartition(child, keys, mesh)
        ctx.exchanges.append((node, needed))
        return out

    if isinstance(node, MultiJoinNode):
        # the fused exchange: every input repartitions ONCE on the segment's
        # key class; inputs already partitioned on it (reuse) and replicated
        # rider builds (exch None) flow through without a collective
        reuse = node.reuse or [False] * len(node.children)
        exch = node.exch_keys or ([list(node.probe_keys)]
                                  + [list(bk) for bk in node.build_keys])
        inputs = []
        for i, (b, keys) in enumerate(zip(kids, exch)):
            if reuse[i] or keys is None:
                inputs.append(b)
                continue
            out, needed = dist_hash_repartition(b, list(keys), mesh)
            ctx.exchanges.append((f"multiway[{i}]", needed))
            inputs.append(out)
        return ShardedBatch([_apply(node, [shard_of(x, i, mesh) for x in inputs], ctx)
                             for i in range(mesh.size)])

    if isinstance(node, AggNode):
        return _mesh_agg(node, kids[0], ctx)

    if isinstance(node, SortNode) and node.limit is not None and node.dist_topk:
        # per-shard top-k, all_gather the candidates, final top-k: the
        # TopNSorter merge of per-region streams (src/runtime/topn_sorter.cpp)
        keys = [SortKey(k, asc) for k, asc in node.keys]
        k = node.limit + node.offset
        out = top_k(all_gather([top_k(b, keys, k) for b in kids[0].shards], mesh.home),
                    keys, k)
        return head(out, node.limit, node.offset) if node.offset else out
    return None


def _mesh_agg(node: AggNode, child: ShardedBatch, ctx: Ctx):
    mesh = ctx.mesh
    if node.merge:
        # per-shard partial tables merged in shard order (parallel/agg.py)
        if not node.key_names:
            return dist_scalar_aggregate(child, node.specs, mesh)
        shift = getattr(node, "key_shift", {}) or {}
        if shift:
            child = _each(child, lambda b: _shift_keys(b, shift, -1))
        out = dist_group_aggregate_dense(child, node.key_names, node.domains,
                                         node.specs, mesh)
        return _shift_keys(out, shift, 1) if shift else out
    if node.key_names and getattr(node, "agg_dist", "") == "local" \
            and node.strategy != "dense":
        # cardinality-adaptive "local" arm (sorted strategy): pre-reduce each
        # shard's rows, repartition only the partials, merge them once; the
        # planner's group bound (or, with none, the shard's rows) caps each
        # shard's partial table
        out, needed = dist_group_aggregate_partial_shuffled(
            child, node.key_names, node.specs, mesh, node.max_groups or (1 << 62))
        ctx.exchanges.append(("agg", needed))
        return out
    return None


def exchange_summary(plan: PlanNode) -> dict:
    """Exchange accounting for a distributed plan: the numbers the keyed
    exchange scheduler exists to move.  One round = one EXECUTED
    synchronized repartition step: a binary shuffle join's two input
    exchanges are ONE round, a fused MultiJoin's N+1 input exchanges are
    ONE round, a lone repartition (group-by / distinct co-location) or a
    "local" adaptive agg's internal partial shuffle is one each.  Reused
    partitions (scheduler-proved, collective skipped at runtime) count in
    ``reused``, never in ``rounds`` or ``collectives``.  ``collectives``
    counts individual executed repartitions (a fused segment's probe + each
    shuffled build; replicated rider builds cost none); ``keys`` lists the
    chosen partition key (short names) per counted round, outermost-last."""
    rounds = 0
    reused = 0
    collectives = 0
    keys: list = []
    skip: set = set()
    seen: set = set()

    def short(cols) -> str:
        return "+".join(c.split(".")[-1] for c in (cols or ()))

    def walk(n: PlanNode) -> None:
        nonlocal rounds, reused, collectives
        if id(n) in seen:           # DAG-shared subtrees count once
            return
        seen.add(id(n))
        if isinstance(n, MultiJoinNode):
            r = n.reuse or [False] * len(n.children)
            exch = n.exch_keys or ([n.probe_keys] + list(n.build_keys))
            execd = sum(1 for i in range(len(n.children))
                        if exch[i] is not None and not r[i])
            reused += sum(1 for i in range(len(n.children))
                          if exch[i] is not None and r[i])
            collectives += execd
            if execd:
                rounds += 1
                keys.append(short(n.probe_keys))
        elif isinstance(n, JoinNode):
            reps = [c for c in n.children
                    if isinstance(c, ExchangeNode) and c.kind == "repartition"]
            if reps:
                reused += sum(c.reused for c in reps)
                execd = sum(1 for c in reps if not c.reused)
                collectives += execd
                if execd:
                    rounds += 1
                    keys.append(short(n.left_keys))
                skip.update(id(c) for c in reps)
        elif isinstance(n, ExchangeNode) and n.kind == "repartition" \
                and id(n) not in skip:
            if n.reused:
                reused += 1
            else:
                rounds += 1
                collectives += 1
                keys.append(short(n.keys) or "*")
        elif isinstance(n, AggNode) and \
                getattr(n, "agg_dist", "") == "local" \
                and n.strategy != "dense":
            rounds += 1
            collectives += 1
            keys.append(short(n.key_names))
        for c in n.children:
            walk(c)

    walk(plan)
    # outermost-last reads as execution order (keys collected top-down)
    keys.reverse()
    return {"rounds": rounds, "reused": reused, "collectives": collectives,
            "keys": keys}


def progress_totals(plan: PlanNode) -> dict:
    """Host-side work estimates for the live progress record (obs/
    progress.py): operator count, scan count, and the executed exchange
    rounds a multi-round mesh query pays: the denominators SHOW
    PROCESSLIST renders "m/n" against.  A walk over the plan's host
    objects; nothing here touches a tensor."""
    operators = 0
    scans = 0
    seen: set = set()

    def walk(n: PlanNode) -> None:
        nonlocal operators, scans
        if id(n) in seen:
            return
        seen.add(id(n))
        operators += 1
        if isinstance(n, ScanNode):
            scans += 1
        for c in n.children:
            walk(c)

    walk(plan)
    return {"operators": operators, "scans": scans,
            "rounds": exchange_summary(plan)["rounds"]}


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
