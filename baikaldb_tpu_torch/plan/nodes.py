"""Plan IR — the analog of the reference's ExecNode tree (include/exec/
exec_node.h:79) plus the pb::PlanNode serialized form (proto/plan.proto).

One IR serves as both logical and physical plan; the planner's passes
(plan/planner.py) annotate it (pushed-down predicates, pruned columns, join
keys, group-by strategy) the way the reference's PhysicalPlanner pass pipeline
rewrites its tree (src/physical_plan/physical_planner.cpp:27-120).  The
executor (exec/executor.py) lowers this IR to jax kernels inside one jit —
the replacement for the volcano open/get_next loop and the Acero Declaration
path (exec_node.h:411-414).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..expr.ast import Expr
from ..ops.hashagg import AggSpec
from ..types import Schema


@dataclass
class PlanNode:
    children: list["PlanNode"] = field(default_factory=list)
    # output schema, filled by the binder/planner
    schema: Optional[Schema] = None
    # row distribution over the mesh axis, set by plan/distribute.py:
    # "shard" (rows partitioned across devices) | "rep" (replicated) | None
    # (single-device plan)
    dist: Optional[str] = None

    def child(self) -> "PlanNode":
        return self.children[0]

    def tree_repr(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [pad + self._label()]
        for c in self.children:
            lines.append(c.tree_repr(indent + 1))
        return "\n".join(lines)

    def _label(self) -> str:
        return type(self).__name__


@dataclass
class ScanNode(PlanNode):
    """Table scan (reference: RocksdbScanNode / the column-store reader).
    Emits columns under qualified names ``label.col``."""
    table_key: str = ""        # "db.table"
    label: str = ""            # alias in the query
    columns: list[str] = field(default_factory=list)   # pruned physical columns
    pushed_filter: Optional[Expr] = None               # PredicatePushDown result
    access_desc: str = ""      # IndexSelector choice (EXPLAIN display)
    # ANN candidate reduction (index/annindex): (ix_name, vec_col, metric,
    # qvec tuple, k) — the batch builder prunes the scan to the IVF
    # candidate set; the plan re-ranks exactly
    ann: Optional[tuple] = None

    def _label(self):
        f = f" filter={self.pushed_filter!r}" if self.pushed_filter else ""
        a = f" access={self.access_desc}" if self.access_desc else ""
        return (f"Scan({self.table_key} as {self.label} "
                f"cols={self.columns}{f}{a})")


@dataclass
class FilterNode(PlanNode):
    pred: Optional[Expr] = None

    def _label(self):
        return f"Filter({self.pred!r})"


@dataclass
class ProjectNode(PlanNode):
    exprs: list[Expr] = field(default_factory=list)
    names: list[str] = field(default_factory=list)
    # True when this Project wraps a derived table / CTE body: its subtree is
    # a separate name scope, so outer predicate pushdown must stop here even
    # when an inner scan shares a table label with an outer table
    derived: bool = False
    # on a derived Project: the names the planner generated while planning
    # its body (outside the plan signature; exec/executor.py derived_key)
    generated: frozenset = frozenset()

    def _label(self):
        return f"Project({', '.join(f'{n}={e!r}' for n, e in zip(self.names, self.exprs))})"


@dataclass
class JoinNode(PlanNode):
    how: str = "inner"                      # inner|left|semi|anti|cross
    left_keys: list[str] = field(default_factory=list)   # resolved column names
    right_keys: list[str] = field(default_factory=list)
    residual: Optional[Expr] = None         # non-equi conjuncts, post-filter
    cap: Optional[int] = None               # static output capacity
    # dense PK-FK strategy (ops/join.dense_join): build key(s) unique with
    # stats-bounded [lo, lo+span) integer domains (per key; composite keys
    # index the product space)
    strategy: str = "sort"                  # sort | dense
    dense_lo: list = field(default_factory=list)
    dense_span: list = field(default_factory=list)
    # semi/anti with ONE "build_col <> probe_col" residual: range-count
    # path, no expansion (ops/join.semi_join_neq)
    neq: Optional[tuple] = None             # (probe_col, build_col)
    # build side is a position-preserving view of one base table: the
    # executor feeds store.sort_permutation(cols) so the kernel skips its
    # on-device sort.  (table_key, (key_col, neq_col))
    presort: Optional[tuple] = None
    # build side PROVED key-sorted over live rows (a sorted group-by on
    # exactly the join keys): the kernel's lexsort degrades to an O(n)
    # stable deadness partition
    build_sorted: bool = False

    def _label(self):
        dense = ""
        if self.strategy == "dense":
            dense = " dense" + "x".join(
                f"[{lo},+{sp})" for lo, sp in zip(self.dense_lo,
                                                  self.dense_span))
        return (f"Join({self.how} on {list(zip(self.left_keys, self.right_keys))}"
                + (f" residual={self.residual!r}" if self.residual else "")
                + (f" neq={self.neq}" if self.neq else "")
                + dense + ")")


@dataclass
class AggNode(PlanNode):
    """GROUP BY + aggregates (reference: AggNode partial/merge,
    src/exec/agg_node.cpp).  Key exprs are precomputed into columns named
    key_names by a child ProjectNode."""
    key_names: list[str] = field(default_factory=list)
    specs: list[AggSpec] = field(default_factory=list)
    strategy: str = "sorted"                 # dense | sorted
    domains: list[int] = field(default_factory=list)     # dense: per-key domain
    max_groups: int = 0                      # sorted: static group cap
    # "collective": per-shard partials merged in-network (psum/pmin/pmax) —
    # the partial-AggNode + MERGE_AGG_NODE pair as one collective
    merge: str = ""
    # cardinality-adaptive MPP aggregation (plan/distribute.py, from
    # index/stats ndv estimates — the Partial Partial Aggregates policy):
    #   "local": pre-reduce per shard before the exchange (dense partial
    #            tables psum-merged, or sorted partials shuffled + merged)
    #   "raw":   shuffle raw rows and aggregate once per shard
    # "" = single-device / decision not applicable
    agg_dist: str = ""
    # sorted strategy over base-table keys of one position-preserving scan
    # chain: the executor feeds store.agg_sort_permutation(cols) so the
    # kernel skips its multi-key device sort.  (table_key, (col, ...))
    presort: Optional[tuple] = None

    def _label(self):
        s = f"dense{self.domains}" if self.strategy == "dense" else f"sorted<= {self.max_groups}"
        m = " merge=collective" if self.merge else ""
        a = f" agg_dist={self.agg_dist}" if self.agg_dist else ""
        return f"Agg(keys={self.key_names} {s} aggs={[sp.out_name for sp in self.specs]}{m}{a})"


@dataclass
class SortNode(PlanNode):
    keys: list[tuple[str, bool]] = field(default_factory=list)  # (col, asc)
    limit: Optional[int] = None              # fused top-k
    offset: int = 0
    # distributed top-k: per-shard top-k, all_gather, final top-k
    dist_topk: bool = False

    def _label(self):
        lim = f" limit={self.limit}+{self.offset}" if self.limit is not None else ""
        d = " dist-topk" if self.dist_topk else ""
        return f"Sort({self.keys}{lim}{d})"


@dataclass
class ShrinkNode(PlanNode):
    """Adaptive capacity cut: pack live rows into a smaller static batch so
    downstream operators stop paying the base table's full capacity for a
    selective subtree (ops/compact.shrink).  ``cap`` settles through the
    session's overflow-retry loop exactly like join caps."""
    cap: Optional[int] = None

    def _label(self):
        return f"Shrink(cap={self.cap})"


@dataclass
class LimitNode(PlanNode):
    limit: int = 0
    offset: int = 0

    def _label(self):
        return f"Limit({self.limit} offset {self.offset})"


@dataclass
class UnionNode(PlanNode):
    all: bool = True

    def _label(self):
        return f"Union({'all' if self.all else 'distinct'})"


@dataclass
class DistinctNode(PlanNode):
    def _label(self):
        return "Distinct"


@dataclass
class ScalarSourceNode(PlanNode):
    """Broadcast a 1-row subplan result onto the main stream as constant
    columns (uncorrelated scalar subquery; reference: subquery decorrelation
    + DualScan bridging).  children = [main, subplan]."""
    col_names: list[str] = field(default_factory=list)

    def _label(self):
        return f"ScalarSource({self.col_names})"


@dataclass
class MembershipNode(PlanNode):
    """x IN (subquery) as a VALUE column (for subquery predicates nested under
    OR/CASE/...): appends a nullable BOOL column with SQL IN semantics
    (NULL key -> NULL; not-found with NULLs in the list -> NULL).
    children = [main, subplan]."""
    key_col: str = ""
    out_name: str = ""
    negate: bool = False

    def _label(self):
        n = "NOT IN" if self.negate else "IN"
        return f"Membership({self.key_col} {n} subquery -> {self.out_name})"


@dataclass
class ExchangeNode(PlanNode):
    """Data movement across the mesh (inserted by plan/distribute.py — the
    Separate/MppAnalyzer analog).  Unlike the reference's ExchangeSender/
    Receiver pair shipping Arrow batches over brpc (src/exec/
    exchange_sender_node.cpp, mpp_analyzer.cpp), this lowers to ONE XLA
    collective inside the jitted program:

    - kind="gather":       all_gather over ICI — shard-partitioned rows become
                           replicated (broadcast-join build sides, final
                           result collection, small subquery results).
    - kind="repartition":  hash-partition rows on ``keys`` + all_to_all, so
                           equal keys land on one shard (distributed join /
                           high-cardinality group-by).  ``cap`` is the static
                           per-destination capacity; overflow rides the flag
                           channel and the session retries with a larger cap.
    """
    kind: str = "gather"
    keys: list[str] = field(default_factory=list)
    cap: Optional[int] = None
    # keyed exchange scheduler (plan/distribute._mark_partition_reuse): the
    # child is ALREADY hash-partitioned on this key class — the executor
    # passes rows through without a collective, and the round does not
    # count as executed in exec/executor.exchange_summary
    reused: bool = False

    def _label(self):
        if self.kind == "gather":
            return "Exchange(gather -> replicated)"
        r = " reused" if self.reused else ""
        return f"Exchange(repartition on {self.keys} cap={self.cap}{r})"


@dataclass
class MultiJoinNode(PlanNode):
    """Fused multiway hash join over ONE shared equi-key (the Efficient
    Multiway Hash Join shape): children = [probe, build_1, ..., build_N],
    every level joining the probe stream on the SAME probe key columns.

    plan/distribute.py folds a left-deep chain of shuffle joins that all
    repartition on one key into this node; the executor then radix-
    partitions / ``all_to_all``s each input ONCE on that key hash (one
    exchange round instead of one per binary join) and runs a single
    fused multi-build probe pass (ops/join.multiway_join) per shard.
    Intermediate join results never materialize and never re-shuffle.

    The keyed exchange scheduler (beyond-one-shared-key fusion) generalizes
    this: ``level_keys`` carries PER-LEVEL probe key columns (all living on
    the probe stream, possibly rewritten onto equality-class siblings of
    the original join keys) while ``probe_keys`` stays the PARTITION key —
    the class representative every input repartitions on.  When
    ``level_keys`` is None every level joins on ``probe_keys`` (the
    one-shared-key shape).  ``reuse[i]`` marks child ``i`` (0 = probe) as
    already partitioned on the segment's key class: its repartition
    collective is skipped entirely.

    ``cap`` is the fused output capacity (rides the overflow retry-flag
    protocol like binary join caps); ``exch_caps`` hold the per-input
    shuffle capacities (runtime-settled _CapBox objects, same protocol)."""
    probe_keys: list[str] = field(default_factory=list)
    build_keys: list[list[str]] = field(default_factory=list)  # per build
    hows: list[str] = field(default_factory=list)              # inner|left
    level_keys: Optional[list[list[str]]] = None   # per-level probe keys
    reuse: Optional[list[bool]] = None             # per child, 0 = probe
    # per-child partition columns for the fused exchange (0 = probe):
    # None = no repartition (replicated rider build, or a rider-only
    # segment's pass-through probe); a shuffle build's list may be a
    # SUBSET of its join keys when the segment partitions on a shared
    # class (co-location on the subset co-locates the full key)
    exch_keys: Optional[list] = None
    # per-level planner-verified 32-bit key packing (JoinNode's
    # pack32_verified, carried through fusion — levels with it never
    # rewrite onto class siblings, whose bounds the proof did not cover)
    packs: Optional[list[bool]] = None
    cap: Optional[int] = None
    exch_caps: Optional[list] = None       # per-child _CapBox, trace-settled

    def _label(self):
        keys = self.level_keys or [self.probe_keys] * len(self.hows)
        sides = ", ".join(f"{h}:{pk}={bk}" if pk != self.probe_keys
                          else f"{h}:{bk}"
                          for h, pk, bk in zip(self.hows, keys,
                                               self.build_keys))
        reused = sum(self.reuse) if self.reuse else 0
        r = f" reused={reused}" if reused else ""
        return (f"MultiJoin(on {self.probe_keys} x{len(self.hows)} "
                f"[{sides}]{r})")


@dataclass
class WindowNode(PlanNode):
    """Window functions over one (partition, order) spec (reference:
    src/exec/window_node.cpp)."""
    partition_names: list[str] = field(default_factory=list)
    order_keys: list[tuple[str, bool]] = field(default_factory=list)
    specs: list = field(default_factory=list)   # list[ops.window.WinSpec]

    def _label(self):
        return (f"Window(partition={self.partition_names} order={self.order_keys} "
                f"fns={[s.out_name for s in self.specs]})")


@dataclass
class ValuesNode(PlanNode):
    """Literal rows (SELECT without FROM)."""
    rows: list[list] = field(default_factory=list)
    names: list[str] = field(default_factory=list)
    exprs: list[list] = field(default_factory=list)

    def _label(self):
        return f"Values({len(self.rows)} rows)"


@dataclass
class StreamResultNode(PlanNode):
    """Leaf standing in for a chunk-folded aggregate (exec/streaming.py):
    the streamed fold produces the aggregate's finalized batch outside any
    single program, then the ancestors above the AggNode (project / sort /
    limit) run as a normal remainder plan reading this batch from the
    batches dict under ``key``."""
    key: str = ""

    def _label(self):
        return f"StreamResult({self.key})"


# -- plan fingerprinting ----------------------------------------------------

# runtime-settled / display-only attributes: NOT part of what the executor
# traces as a fixed program choice.  Caps settle through the overflow-retry
# protocol (keeping an old plan keeps its settled caps — a feature);
# presort_input is rebound per execution; access_desc is EXPLAIN text.
_SIG_SKIP = frozenset({"children", "cap", "radix_width", "presort_input",
                       "access_desc", "exch_caps", "agg_exch_cap",
                       # derived partition metadata (canonical class tuples
                       # recomputed per plan); the reuse DECISIONS stay in
                       # the signature via reused/reuse fields
                       "partitioned_on", "generated"})


def _sig_value(v):
    if isinstance(v, Expr):
        return v.key()
    if isinstance(v, (list, tuple)):
        return tuple(_sig_value(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _sig_value(x)) for k, x in v.items()))
    return repr(v)


def plan_signature(node: PlanNode) -> tuple:
    """Structural fingerprint of everything trace-relevant in a plan.

    Two plans with equal signatures lower to the same XLA program for equal
    input shapes, so the session's plan cache can replan on a table-version
    bump (stats-derived choices — dense domains, key shifts — may be stale)
    while KEEPING the compiled executables whenever the fresh plan came out
    structurally identical.  That split — version gates the plan, capacity
    bucket gates the executable — is what makes DML inside one capacity
    bucket cost zero retraces."""
    fields_sig = tuple(
        (k, _sig_value(v)) for k, v in sorted(vars(node).items())
        if k not in _SIG_SKIP)
    return (type(node).__name__, fields_sig,
            tuple(plan_signature(c) for c in node.children))
