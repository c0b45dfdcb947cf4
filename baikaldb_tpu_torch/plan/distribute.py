"""Plan distribution pass: the Separate / MppAnalyzer analog.

A copy of ``baikaldb_tpu/plan/distribute.py`` (host code).  The reference
splits a physical plan into frontend manager nodes plus per-region store
fragments (src/physical_plan/separate.cpp:43) and, for MPP, into a DAG of
fragments connected by exchange nodes with a hash-partition count chosen
from statistics (src/physical_plan/mpp_analyzer.cpp:33-87,723).  This pass
keeps ONE plan and annotates every node with its row distribution over the
mesh:

  - ``shard``: rows are partitioned across the mesh's shards (the Region
    fan-out analog; table scans start here),
  - ``rep``:   every shard holds the identical full value (the coordinator
    state analog),

and inserts explicit :class:`ExchangeNode`s where the distribution must
change.  exec/executor.py then runs the annotated plan shard by shard: every
Exchange lowers to a collective of parallel/collectives.py (all_gather /
all_to_all) and partial-aggregate merges to psum / pmin / pmax (the
MERGE_AGG_NODE analog, proto/plan.proto:14-16).

Join strategy (the JoinTypeAnalyzer/MppAnalyzer choice): with both sides
sharded, either *broadcast* the build side (all_gather: a small right side)
or *repartition both sides* on the join keys (all_to_all: the MPP shuffle
join).  The decision uses estimated row counts propagated bottom-up from
table statistics, like the reference sizing exchanges from statistics
(mpp_analyzer.cpp:723-728).

The fragment half (``FragmentSpec``, ``slice_fragments``,
``fragment_subtrees``) slices the store-executable subtrees of a plan into
per-region dispatch units for the pushed fragments (exec/fragments.py,
plan/fragment.py).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from ..types import Field, LType, Schema
from ..utils import metrics
from ..utils.flags import FLAGS, define
from .eqclasses import ClassMap, region_children, region_classes
from .nodes import (AggNode, DistinctNode, ExchangeNode, FilterNode, JoinNode,
                    LimitNode, MembershipNode, MultiJoinNode, PlanNode,
                    ProjectNode, ScalarSourceNode, ScanNode, ShrinkNode,
                    SortNode, UnionNode, ValuesNode, WindowNode)

define("mpp_force_shuffle", False,
       "repartition every sharded join input regardless of build size "
       "(bench/test knob: the pure-MPP regime where the per-edge baseline "
       "pays one shuffle round per binary join — broadcast joins are "
       "usually the better plan for small builds)")
define("multiway_join", True,
       "keyed exchange scheduler: fuse chains of shuffle joins into "
       "multiway exchanges planned over the WHOLE join graph — levels "
       "sharing one equality class of keys repartition once per class "
       "(not once per join), partitions reuse transitively, and chains "
       "whose keys differ per level lower as a sequence of fused "
       "MultiJoins (off: chained binary joins, one shuffle round each)")

SHARD = "shard"
REP = "rep"

# build sides at or below this estimated row count are broadcast (all_gather)
# rather than shuffle-repartitioned; dims in a star schema land here
BROADCAST_ROWS = 1 << 16


def _clear_exchanged_sorted_builds(plan: PlanNode) -> None:
    """An Exchange on a join's build side (all_gather concatenation of
    per-shard runs, or all_to_all interleave) destroys the key order the
    planner's interesting-order pass proved — the O(n)-partition fast path
    would silently mis-join, so it must revert to the lexsort."""
    def has_exchange(n: PlanNode) -> bool:
        if isinstance(n, ExchangeNode):
            return True
        return any(has_exchange(c) for c in n.children)

    def walk(n: PlanNode) -> None:
        if isinstance(n, JoinNode) and getattr(n, "build_sorted", False) \
                and len(n.children) > 1 and has_exchange(n.children[1]):
            n.build_sorted = False
        for c in n.children:
            walk(c)
    walk(plan)


def distribute(plan: PlanNode, n_shards: int,
               rows_fn: Optional[Callable[[str], int]] = None,
               broadcast_rows: Optional[int] = None,
               ndv_fn: Optional[Callable[[str, str], Optional[int]]] = None,
               stats_fn: Optional[Callable[[str, str], Optional[dict]]] = None,
               where_selectivity: Optional[float] = None,
               ) -> PlanNode:
    """Annotate ``plan`` in place and insert Exchange nodes; returns the (new)
    root.  ``rows_fn(table_key) -> row count`` feeds the broadcast-vs-shuffle
    join decision; absent stats are treated as small (broadcast).
    ``ndv_fn(table_key, col) -> distinct count`` (index/stats) feeds the
    cardinality-adaptive aggregation choice; absent stats keep the
    conservative raw-row shuffle.  ``stats_fn(table_key, col) -> stats
    payload`` feeds the keyed exchange scheduler's partition-key tie-break.
    ``where_selectivity`` is the session's bound-value estimate of the
    fraction of rows the WHERE keeps (index/stats over THIS execution's
    literals; None = no basis) — it scales the adaptive-agg rows-per-shard
    so a highly selective predicate flips local -> raw per execution (the
    mesh plan cache keys on its selectivity class)."""
    if broadcast_rows is None:
        broadcast_rows = BROADCAST_ROWS     # module attr: patchable in tests
    d = _Distributor(n_shards, rows_fn or (lambda tk: 0), broadcast_rows,
                     ndv_fn, where_selectivity)
    dist, _ = d.visit(plan)
    _clear_exchanged_sorted_builds(plan)
    if FLAGS.multiway_join and n_shards > 1:
        sched = _Scheduler(stats_fn)
        plan = sched.fuse(plan)
        _mark_partition_reuse(plan)
    if dist == SHARD:
        root = ExchangeNode(children=[plan], schema=plan.schema, kind="gather")
        root.dist = REP
        return root
    return plan


# -- multiway shuffle-join fusion (the MPP exchange v2 rewrite) ------------

def _fusable_shuffle_join(node: PlanNode) -> bool:
    """A binary join both of whose inputs the distributor chose to
    hash-repartition, in a shape the fused multiway kernel reproduces
    exactly (plain sort-strategy inner/left equi-join; the planner already
    moved residuals into a FilterNode above and semi/anti/dense take other
    kernels)."""
    return (isinstance(node, JoinNode) and node.how in ("inner", "left")
            and node.strategy == "sort" and node.neq is None
            and len(node.children) == 2
            and all(isinstance(c, ExchangeNode) and c.kind == "repartition"
                    for c in node.children))


def _fusable_bcast_join(node: PlanNode) -> bool:
    """A broadcast join the scheduler may absorb as a RIDER level: the
    build is replicated (all_gathered), so the level joins correctly under
    any probe partitioning and costs no repartition — absorbing it keeps a
    chain of shuffle joins contiguous instead of breaking it at every
    small-dimension join (the TPC-H snowflake shape)."""
    return (isinstance(node, JoinNode) and node.how in ("inner", "left")
            and node.strategy == "sort" and node.neq is None
            and bool(node.left_keys)
            and len(node.children) == 2
            and not isinstance(node.children[0], ExchangeNode)
            and isinstance(node.children[1], ExchangeNode)
            and node.children[1].kind == "gather")


def _hash_family(lt: Optional[LType]):
    """Partition-hash compatibility class of a column type.  Two columns
    may substitute for each other as partition keys only when equal VALUES
    produce equal shuffle hashes: strings hash by value through the
    dictionary (always compatible), every other type must match exactly
    (utils/hashing folds 64-bit lanes differently from 32-bit ones, so a
    negative BIGINT and the equal INT route to different shards)."""
    if lt is LType.STRING:
        return "str"
    return lt


def _schema_ltypes(*schemas) -> dict:
    out: dict = {}
    for sch in schemas:
        for f in sch.fields:
            out[f.name] = f.ltype
    return out


def _multiway_schema(probe_schema: Schema, build_schemas: list[Schema],
                     hows: list[str]) -> Schema:
    """Output schema of one fused segment, mirroring the kernel's column
    order and collision suffixing (probe fields, then each build's fields;
    LEFT levels make build fields nullable)."""
    fields = list(probe_schema.fields)
    names = {f.name for f in fields}
    for sch, how in zip(build_schemas, hows):
        for f in sch.fields:
            name = f.name if f.name not in names else f.name + "_r"
            names.add(name)
            fields.append(Field(name, f.ltype,
                                True if how == "left" else f.nullable))
    return Schema(tuple(fields))


class _Scheduler:
    """The keyed exchange scheduler: plans partitioning for whole shuffle-
    join CHAINS instead of per edge.  A chain's levels group into segments
    by the equality class of their probe-side keys — every level in a
    segment joins (and every input repartitions) on ONE class, chosen to
    serve the most levels, so a chain pays one shuffle round per KEY CLASS
    rather than one per join.  Levels whose keys differ lower as a
    sequence of fused MultiJoins (bushy where build inputs hold their own
    chains); inner levels may rewrite their key onto an equality-class
    sibling already on the probe stream (`f.k = a.k AND a.k = b.k` joins
    b on f.k directly — the transitive-equality case)."""

    def __init__(self, stats_fn=None):
        self.stats_fn = stats_fn
        self._seen: dict[int, PlanNode] = {}
        self._refs: dict[int, int] = {}

    def fuse(self, plan: PlanNode) -> PlanNode:
        self._count_refs(plan)
        return self._visit(plan, None)

    def _count_refs(self, plan: PlanNode) -> None:
        """Parent-edge counts: a chain must not absorb a DAG-shared inner
        join (the other parent still needs it as a standalone subplan)."""
        visited: set[int] = set()

        def walk(n: PlanNode) -> None:
            for c in n.children:
                self._refs[id(c)] = self._refs.get(id(c), 0) + 1
                if id(c) not in visited:
                    visited.add(id(c))
                    walk(c)
        self._refs[id(plan)] = 1
        walk(plan)

    def _visit(self, node: PlanNode, cm: Optional[ClassMap]) -> PlanNode:
        hit = self._seen.get(id(node))
        if hit is not None:
            return hit
        self._seen[id(node)] = node     # provisional: breaks DAG cycles
        if cm is None:
            # region root (plan root / union arm / derived body / subquery
            # subplan): equality classes valid for THIS name scope only
            cm = region_classes(node)
        if _fusable_shuffle_join(node) or _fusable_bcast_join(node):
            out = self._schedule_chain(node, cm)
        else:
            in_region = {id(c) for c in region_children(node)}
            for i, c in enumerate(node.children):
                node.children[i] = self._visit(
                    c, cm if id(c) in in_region else None)
            out = node
        self._seen[id(node)] = out
        return out

    # -- chain collection ------------------------------------------------
    def _schedule_chain(self, top: JoinNode, cm: ClassMap) -> PlanNode:
        levels = []           # outermost-first here, reversed below
        cur = top
        while True:
            if _fusable_shuffle_join(cur):
                lx, rx = cur.children
                levels.append({"build": rx.children[0],
                               "bkeys": list(cur.right_keys),
                               "pkeys": list(cur.left_keys),
                               "how": cur.how, "kind": "shuffle",
                               "pack": bool(getattr(cur, "pack32_verified",
                                                    False))})
                spine = lx.children[0]
            else:
                # broadcast rider: the build is replicated (gathered), so
                # the level joins correctly under ANY probe partitioning —
                # it fuses into whichever segment its keys are available
                # in, paying no repartition and, crucially, no longer
                # BREAKING the chain between two shuffle levels
                levels.append({"build": cur.children[1],
                               "bkeys": list(cur.right_keys),
                               "pkeys": list(cur.left_keys),
                               "how": cur.how, "kind": "bcast",
                               "pack": bool(getattr(cur, "pack32_verified",
                                                    False))})
                spine = cur.children[0]
            # ShrinkNodes between fused levels only cut the INTERMEDIATE
            # result's capacity before its re-shuffle; the fused plan never
            # materializes that intermediate, so they unwrap.  Shrinks on
            # the BASE probe input survive (that input is real).
            unwrapped = spine
            while isinstance(unwrapped, ShrinkNode):
                unwrapped = unwrapped.child()
            if (_fusable_shuffle_join(unwrapped)
                    or _fusable_bcast_join(unwrapped)) and \
                    self._refs.get(id(unwrapped), 1) <= 1 and \
                    self._refs.get(id(spine), 1) <= 1:
                cur = unwrapped
            else:
                probe = spine
                break
        levels.reverse()      # innermost level first
        n_shuffle = sum(1 for lv in levels if lv["kind"] == "shuffle")
        if len(levels) == 1 or n_shuffle == 0:
            # a lone join stays binary (keeps the radix/presort/
            # build_sorted fast paths); still recurse into inputs
            for i, c in enumerate(list(top.children)):
                if isinstance(c, ExchangeNode):
                    c.children[0] = self._visit(c.children[0], cm)
                else:
                    top.children[i] = self._visit(c, cm)
            return top
        probe = self._visit(probe, cm)
        for lv in levels:
            lv["build"] = self._visit(lv["build"], cm)

        ltypes = _schema_ltypes(probe.schema,
                                *(lv["build"].schema for lv in levels))
        segments = self._plan_segments(levels, probe, cm, ltypes)
        return self._lower_segments(probe, levels, segments)

    # -- segment planning ------------------------------------------------
    def _rewrite_keys(self, lv: dict, stream: set, cm: ClassMap,
                      ltypes: dict) -> Optional[list[str]]:
        """Probe-side key columns for this level, resolved onto the current
        probe stream — the literal key when present, else (inner levels
        only) an equality-class sibling of the same type.  LEFT levels
        never rewrite: their ON equality holds only for matched rows, so a
        sibling is NOT interchangeable on the preserved side.  Neither do
        pack32-verified levels: the planner's 32-bit bound proof covers
        the ORIGINAL columns, not their class siblings."""
        out = []
        for k in lv["pkeys"]:
            if k in stream:
                out.append(k)
                continue
            if lv["how"] != "inner" or lv.get("pack"):
                return None
            cand = [m for m in cm.cls(k) if m in stream
                    and ltypes.get(m) == ltypes.get(k)]
            if not cand:
                return None
            out.append(min(cand))
        return out

    def _key_spread(self, keys: list[str], origins: dict) -> int:
        """Partition-key spread estimate (index/stats) for the tie-break:
        more distinct values -> better shard balance."""
        from ..index.stats import partition_key_ndv

        if self.stats_fn is None:
            return 0
        total = 1
        for k in keys:
            src = origins.get(k)
            if src is None:
                return 0
            try:
                st = self.stats_fn(*src)
            except Exception:   # noqa: BLE001 — stats are advisory
                metrics.count_swallowed("distribute.spread")
                return 0
            total *= partition_key_ndv(st)
        return total

    def _plan_segments(self, levels: list, probe: PlanNode, cm: ClassMap,
                       ltypes: dict) -> list[dict]:
        """Greedy grouping: repeatedly take, among shuffle levels whose
        keys resolve on the current probe stream, the partition-class
        signature serving the MOST levels, and fuse them into one segment.
        A candidate signature may be a SUBSET of a level's key classes
        (co-location on a subset co-locates the full key — the build then
        repartitions on just the matching columns), which is how a 2-key
        join shares a round with a 1-key join on one of its classes.
        Ties break toward the signature the probe is ALREADY partitioned
        on (its repartition is then skipped outright), then toward wider
        keys and higher ndv spread (index/stats).  Broadcast riders attach
        to the earliest segment their keys are available in — they pay no
        repartition under any signature.  Progress is guaranteed: the
        earliest unplaced level's keys live on base/earlier-level columns,
        all placed."""
        origins = _column_origins(probe)
        for lv in levels:
            for k, v in _column_origins(lv["build"]).items():
                origins.setdefault(k, v)
        stream = {f.name for f in probe.schema.fields}
        remaining = list(range(len(levels)))
        segments: list[dict] = []
        incoming = None       # partition sig of the running probe stream
        while remaining:
            rewrites: dict[int, list] = {}
            sigs: dict[int, tuple] = {}
            for i in remaining:
                rew = self._rewrite_keys(levels[i], stream, cm, ltypes)
                if rew is None:
                    continue
                rewrites[i] = rew
                if levels[i]["kind"] == "shuffle":
                    sigs[i] = tuple((cm.cls(k), _hash_family(ltypes.get(k)))
                                    for k in rew)
            if not rewrites:    # cannot happen (see docstring); belt+braces
                i0 = remaining[0]
                rewrites[i0] = list(levels[i0]["pkeys"])
                if levels[i0]["kind"] == "shuffle":
                    sigs[i0] = tuple(
                        (cm.cls(k), _hash_family(ltypes.get(k)))
                        for k in rewrites[i0])
            cands: dict[tuple, list] = {}
            for sig in sigs.values():
                cands[sig] = []
                for p in sig:
                    cands[(p,)] = []
            for P in cands:
                cands[P] = sorted(i for i, sig in sigs.items()
                                  if set(P) <= set(sig))
            members: list = []
            part_keys: list = []
            exch_cols: dict[int, list] = {}
            if cands:
                def rank(P):
                    # coverage (levels served) dominates, then an incoming-
                    # partition match (probe repartition skipped outright);
                    # after that PRESERVE THE PLANNER'S COST-BASED JOIN
                    # ORDER (-min: selective levels stay early — deferring
                    # a selective build inflates every later segment's
                    # intermediate capacity), then wider partition keys
                    # and the index/stats ndv spread break exact ties
                    pk = self._part_cols(P, cm, ltypes, stream)
                    return (len(cands[P]),
                            1 if incoming is not None and P == incoming
                            else 0,
                            -min(cands[P]),
                            len(P),
                            self._key_spread(pk, origins) if pk else -1)
                P = max(cands, key=rank)
                part_keys = self._part_cols(P, cm, ltypes, stream)
                members = cands[P]
                for i in members:
                    # build-side partition columns: the key pair matching
                    # each class of P (a subset of the level's full keys)
                    cols = []
                    for p in P:
                        j = sigs[i].index(p)
                        cols.append(levels[i]["bkeys"][j])
                    exch_cols[i] = cols
                incoming = P
            riders = [i for i in rewrites
                      if levels[i]["kind"] == "bcast"]
            seg_members = sorted(members + riders)
            if not seg_members:
                break           # unreachable; guards infinite loops
            segments.append({
                "part_keys": part_keys,
                "members": seg_members,
                "level_keys": [rewrites[i] for i in seg_members],
                "exch_keys": [exch_cols.get(i) for i in seg_members]})
            for i in seg_members:
                remaining.remove(i)
                stream |= {f.name for f in levels[i]["build"].schema.fields}
        return segments

    @staticmethod
    def _part_cols(P: tuple, cm: ClassMap, ltypes: dict,
                   stream: set) -> list:
        """Probe-stream representative column per class of ``P`` (the
        columns the fused exchange hashes)."""
        out = []
        for cls, fam in P:
            cand = [c for c in cls if c in stream
                    and _hash_family(ltypes.get(c)) == fam]
            if not cand:
                return []
            out.append(min(cand))
        return out

    # -- lowering --------------------------------------------------------
    def _lower_segments(self, probe: PlanNode, levels: list,
                        segments: list[dict]) -> PlanNode:
        cur = probe
        for seg in segments:
            seg_levels = [levels[i] for i in seg["members"]]
            hows = [lv["how"] for lv in seg_levels]
            schema = _multiway_schema(
                cur.schema, [lv["build"].schema for lv in seg_levels], hows)
            part = list(seg["part_keys"])
            mj = MultiJoinNode(
                children=[cur] + [lv["build"] for lv in seg_levels],
                schema=schema,
                probe_keys=part,
                build_keys=[list(lv["bkeys"]) for lv in seg_levels],
                hows=hows,
                level_keys=[list(ks) for ks in seg["level_keys"]],
                packs=[lv.get("pack", False) for lv in seg_levels],
                # per-child partition columns: probe on the segment class
                # reps, each shuffle build on its matching key subset,
                # riders (replicated builds) on None = no collective
                exch_keys=[part or None] + [
                    list(ks) if ks is not None else None
                    for ks in seg["exch_keys"]])
            mj.dist = SHARD
            metrics.multiway_joins_fused.add(1)
            cur = mj
            if seg is not segments[-1]:
                # the intermediate DOES materialize at segment boundaries:
                # the ShrinkNode the chained plan had between binary joins,
                # re-inserted at the fused granularity (a capacity cut for
                # the JAX package's static shapes; the port's executor,
                # which sizes every join exactly, passes it through).
                # Shard-local: partitioned_on survives.
                sh = ShrinkNode(children=[cur], schema=cur.schema)
                sh.dist = SHARD
                cur = sh
        return cur


# -- transitive partition reuse ---------------------------------------------

def _partition_sig(keys, cm: ClassMap, ltypes: dict):
    """Canonical routing identity of a partition key list: per column the
    equality class plus the hash-compatibility family.  Two exchanges with
    equal signatures route live rows identically (class members are
    equal-valued wherever the enforcing predicate holds — see
    plan/eqclasses.py), so the second one is a no-op."""
    if not keys:
        return None
    sig = []
    for k in keys:
        lt = ltypes.get(k)
        if lt is None:
            return None
        sig.append((cm.cls(k), _hash_family(lt)))
    return tuple(sig)


def _all_ltypes(node: PlanNode) -> dict:
    out: dict = {}
    seen: set[int] = set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if n.schema is not None:
            for f in n.schema.fields:
                out.setdefault(f.name, f.ltype)
        for c in region_children(n):
            walk(c)
    walk(node)
    return out


def _mark_partition_reuse(plan: PlanNode) -> None:
    """Bottom-up partition-property pass: compute ``partitioned_on`` for
    every node of the POST-fusion plan and mark repartition exchanges /
    MultiJoin inputs whose child already carries a compatible partition as
    reused — the executor then skips the collective.  Runs after fusion so
    the property reflects the segments the scheduler actually built."""

    def visit(n: PlanNode, cm: ClassMap, ltypes: dict):
        memo = getattr(n, "partitioned_on", "__unset__")
        if memo != "__unset__":
            return memo
        n.partitioned_on = None         # provisional (DAG cycles)
        in_region = {id(c) for c in region_children(n)}
        child_sigs = []
        for c in n.children:
            if id(c) in in_region:
                child_sigs.append(visit(c, cm, ltypes))
            else:
                sub_cm = region_classes(c)
                child_sigs.append(visit(c, sub_cm, _all_ltypes(c)))
        sig = None
        if isinstance(n, ExchangeNode):
            if n.kind == "repartition" and n.keys:
                sig = _partition_sig(n.keys, cm, ltypes)
                if sig is not None and child_sigs[0] == sig:
                    n.reused = True
        elif isinstance(n, MultiJoinNode):
            exch = n.exch_keys or ([list(n.probe_keys)]
                                   + [list(bk) for bk in n.build_keys])
            wanted = [None if ks is None
                      else _partition_sig(ks, cm, ltypes) for ks in exch]
            # a child co-locates if it is ALREADY partitioned exactly the
            # way its fused-exchange entry would partition it (riders,
            # exch None, never repartition in the first place)
            reuse = [w is not None and cs == w
                     for w, cs in zip(wanted, child_sigs)]
            if any(reuse):
                n.reuse = reuse
            sig = (_partition_sig(n.probe_keys, cm, ltypes)
                   if n.probe_keys else child_sigs[0])
        elif isinstance(n, JoinNode):
            if n.how == "cross":
                sig = child_sigs[0]
            elif len(n.children) > 1 and all(
                    isinstance(c, ExchangeNode) and c.kind == "repartition"
                    for c in n.children[:2]):
                sig = _partition_sig(n.left_keys, cm, ltypes)
            else:
                # broadcast/gathered build: probe rows never move
                sig = child_sigs[0]
        elif isinstance(n, AggNode):
            if n.key_names and n.strategy != "dense" and \
                    getattr(n, "agg_dist", "") in ("local", "raw"):
                sig = _partition_sig(n.key_names, cm, ltypes)
            else:
                # dense-local is psum-merged = REPLICATED, not
                # hash-partitioned (the raw demotion rewrites strategy to
                # "sorted", so dense here always means the collective arm)
                sig = None              # collective-merged / scalar: REP
        elif isinstance(n, (FilterNode, ShrinkNode, ProjectNode,
                            MembershipNode, ScalarSourceNode)):
            # row positions unchanged (Shrink compacts WITHIN the shard);
            # Project renames ride the eq classes (projection identities)
            sig = child_sigs[0] if child_sigs else None
        n.partitioned_on = sig
        return sig

    visit(plan, region_classes(plan), _all_ltypes(plan))


def _column_origins(node: PlanNode) -> dict:
    """Map each output column name of ``node`` to its base-table source
    ``(table_key, physical_col)`` where derivable — the resolution the
    adaptive-agg ndv estimate needs.  Conservative: renamed/computed
    columns simply drop out of the map."""
    from ..expr.ast import ColRef

    if isinstance(node, ScanNode):
        return {f"{node.label}.{c}": (node.table_key, c)
                for c in node.columns}
    if isinstance(node, ProjectNode):
        child = _column_origins(node.child())
        out = {}
        for name, e in zip(node.names, node.exprs):
            if isinstance(e, ColRef) and e.name in child:
                out[name] = child[e.name]
        return out
    if isinstance(node, (JoinNode, MultiJoinNode, UnionNode)):
        out: dict = {}
        for c in node.children:
            for k, v in _column_origins(c).items():
                out.setdefault(k, v)
        return out
    if isinstance(node, (MembershipNode, ScalarSourceNode)):
        return _column_origins(node.children[0])
    if node.children:
        return _column_origins(node.children[0])
    return {}


class _Distributor:
    def __init__(self, n_shards: int, rows_fn, broadcast_rows: int,
                 ndv_fn=None, where_selectivity=None):
        self.n = n_shards
        self.rows_fn = rows_fn
        self.broadcast_rows = broadcast_rows
        self.ndv_fn = ndv_fn
        self.where_sel = where_selectivity
        # plans are DAGs (subquery rewrites share the outer stream between a
        # Membership probe and its joined subplan): visit shared subtrees
        # once, or the second walk would find its own inserted Exchanges
        self._memo: dict[int, tuple[str, int]] = {}

    # -- exchange insertion helpers --------------------------------------
    def _gather(self, parent: PlanNode, i: int):
        child = parent.children[i]
        ex = ExchangeNode(children=[child], schema=child.schema, kind="gather")
        ex.dist = REP
        parent.children[i] = ex

    def _repartition(self, parent: PlanNode, i: int,
                     keys: Optional[list[str]]):
        child = parent.children[i]
        ex = ExchangeNode(children=[child], schema=child.schema,
                          kind="repartition",
                          keys=None if keys is None else list(keys))
        ex.dist = SHARD
        parent.children[i] = ex

    def _est_groups(self, node: AggNode, child_est: int) -> Optional[int]:
        """Group-key cardinality estimate from index/stats distinct counts
        (product over key columns, capped by the child's row estimate).
        None = no basis (unresolvable key or missing stats) — the caller
        keeps the conservative raw shuffle."""
        if self.ndv_fn is None:
            return None
        origins = _column_origins(node.child())
        total = 1
        for k in node.key_names:
            src = origins.get(k)
            if src is None:
                return None
            try:
                ndv = self.ndv_fn(*src)
            except Exception:       # noqa: BLE001 — stats are advisory
                metrics.count_swallowed("distribute.ndv")
                return None
            if not ndv:
                return None
            total *= int(ndv)
            if total >= child_est:
                return child_est
        return min(total, child_est)

    # -- the pass --------------------------------------------------------
    def visit(self, node: PlanNode) -> tuple[str, int]:
        """-> (dist, estimated rows); sets node.dist."""
        hit = self._memo.get(id(node))
        if hit is not None:
            return hit
        dist, est = self._visit(node)
        node.dist = dist
        self._memo[id(node)] = (dist, est)
        return dist, est

    def _visit(self, node: PlanNode) -> tuple[str, int]:
        if isinstance(node, ScanNode):
            return SHARD, max(1, int(self.rows_fn(node.table_key) or 1))

        if isinstance(node, ValuesNode):
            return REP, max(1, len(node.exprs))

        if isinstance(node, (FilterNode, ProjectNode)):
            return self.visit(node.child())

        if isinstance(node, ShrinkNode):
            # shard-local capacity cut (passed through by the port's
            # executor)
            return self.visit(node.child())

        if isinstance(node, JoinNode):
            dl, el = self.visit(node.children[0])
            dr, er = self.visit(node.children[1])
            est = el if node.how in ("semi", "anti") else max(el, er)
            if node.how == "cross":
                est = el * er
            if dl == REP and dr == REP:
                return REP, est
            if dl == SHARD and dr == REP:
                return SHARD, est          # broadcast join, build replicated
            if dl == REP and dr == SHARD:
                # replicated probe over sharded build would duplicate output
                # rows on every shard; collect the build side instead
                self._gather(node, 1)
                return REP, est
            # both sharded: broadcast small builds, shuffle big ones
            force = bool(FLAGS.mpp_force_shuffle) and node.how != "cross" \
                and node.left_keys
            if not force and (node.how == "cross"
                              or er <= self.broadcast_rows
                              or er * self.n <= el):
                self._gather(node, 1)
            else:
                self._repartition(node, 0, node.left_keys)
                self._repartition(node, 1, node.right_keys)
            return SHARD, est

        if isinstance(node, AggNode):
            from ..ops.hashagg import ROW_AGGS

            d, e = self.visit(node.child())
            # DISTINCT and row-holding sketches (percentile, HLL) cannot
            # merge scalar partials: co-locate each group's rows instead
            has_distinct = any(s.distinct or s.op in ROW_AGGS
                               for s in node.specs)
            if not node.key_names:
                if d == SHARD:
                    if has_distinct:
                        self._gather(node, 0)
                    else:
                        node.merge = "collective"
                return REP, 1
            est = min(e, math.prod(x + 1 for x in node.domains)
                      if node.strategy == "dense" else (node.max_groups or e))
            if d == REP:
                return REP, est
            from ..parallel.agg import choose_strategy

            rows_per_shard = max(1, e // max(1, self.n))
            if node.strategy == "dense" and not has_distinct:
                # the psum pre-merge exchanges the whole domain table per
                # shard: the table size IS the group count the local arm
                # pays for
                table = math.prod(x + 1 for x in node.domains)
                if choose_strategy(table, rows_per_shard,
                                   self.where_sel) == "local":
                    node.merge = "collective"   # psum/pmin/pmax partial merge
                    node.agg_dist = "local"
                    metrics.agg_strategy_local.add(1)
                    return REP, est
                # domain table wider than the rows it would summarize:
                # demote to the sorted raw-row shuffle (groups co-located,
                # aggregated once)
                node.strategy = "sorted"
                node.max_groups = 0      # executor: local capacity bound
                node.agg_dist = "raw"
                metrics.agg_strategy_raw.add(1)
                self._repartition(node, 0, node.key_names)
                return SHARD, est
            if not has_distinct and \
                    choose_strategy(self._est_groups(node, e),
                                    rows_per_shard,
                                    self.where_sel) == "local":
                # low-cardinality sorted GROUP BY: pre-reduce per shard and
                # shuffle only the partial rows (executor-internal exchange
                # — no ExchangeNode inserted here)
                node.agg_dist = "local"
                metrics.agg_strategy_local.add(1)
                return SHARD, est
            # sorted strategy or DISTINCT aggregates: co-locate each group on
            # one shard, then aggregate locally (the MPP hash-agg plan)
            node.agg_dist = "raw"
            metrics.agg_strategy_raw.add(1)
            self._repartition(node, 0, node.key_names)
            return SHARD, est

        if isinstance(node, DistinctNode):
            d, e = self.visit(node.child())
            if d == SHARD:
                # keys=None: hash on ALL child columns (resolved when it runs)
                self._repartition(node, 0, None)
            return d, e

        if isinstance(node, SortNode):
            d, e = self.visit(node.child())
            est = min(e, node.limit + node.offset) if node.limit is not None else e
            if d == SHARD:
                if node.limit is not None:
                    # per-shard top-k, all_gather, final top-k (executor)
                    node.dist_topk = True
                else:
                    self._gather(node, 0)
            return REP, est

        if isinstance(node, LimitNode):
            d, e = self.visit(node.child())
            if d == SHARD:
                self._gather(node, 0)
            return REP, min(e, node.limit + node.offset)

        if isinstance(node, UnionNode):
            dists = []
            est = 0
            for i, c in enumerate(node.children):
                dc, ec = self.visit(c)
                dists.append(dc)
                est += ec
            if all(dc == SHARD for dc in dists):
                return SHARD, est
            for i, dc in enumerate(dists):
                if dc == SHARD:
                    self._gather(node, i)
            return REP, est

        if isinstance(node, (MembershipNode, ScalarSourceNode)):
            dm, em = self.visit(node.children[0])
            ds, _ = self.visit(node.children[1])
            if ds == SHARD:
                # every shard's probe rows need the full subquery result
                self._gather(node, 1)
            return dm, em

        if isinstance(node, WindowNode):
            d, e = self.visit(node.child())
            if d == SHARD:
                self._gather(node, 0)
            return REP, e

        if isinstance(node, ExchangeNode):   # pragma: no cover - pass runs once
            raise ValueError("plan already distributed")

        raise ValueError(f"distribute: unknown node {type(node).__name__}")

# -- pushed-down fragment slicing (the Separate half of the reference's
# plan split, src/physical_plan/separate.cpp:43: the store-executable
# subtree leaves the frontend plan and ships to the region owners) --------

from dataclasses import dataclass, field as _field     # noqa: E402


@dataclass
class FragmentSpec:
    """One dispatch unit of a pushed-down fragment: the serialized
    store-executable subtree keyed to the region that owns its row slice.
    The body travels by content hash (``frag_key`` — the AOT-artifact
    discipline); ``frag`` rides along only for the need_frag recovery
    resend.  ``route_start``/``route_end`` is the frontend's routed range
    at slicing time — the store intersects it with its committed range, so
    a spec sliced just before a split can never double-serve rows."""

    region_id: int
    route_start: bytes
    route_end: bytes
    peers: list = _field(default_factory=list)     # [(store_id, address)]
    frag_key: str = ""
    frag: dict = _field(default_factory=dict)


def slice_fragments(frag: dict, tier, frag_key: str) -> list:
    """Slice one wire fragment into per-region FragmentSpecs keyed by
    region ownership (tier routing order = start-key order, which the
    dispatcher preserves so the merged result is bit-identical to the
    serial per-region path).  Returns ``[(spec, region), ...]``."""
    out = []
    for r in sorted(tier.regions, key=lambda r: r.start_key):
        out.append((FragmentSpec(region_id=r.region_id,
                                 route_start=r.start_key,
                                 route_end=r.end_key,
                                 peers=[(sid, a) for sid, a in r.peers],
                                 frag_key=frag_key, frag=frag), r))
    return out


class _NotSliceable(Exception):
    pass


def _frag_bare(e, label):
    """Rewrite scan-output column references (``label.col`` or
    table-qualified) to the bare names a store daemon's decoded rows
    carry; anything referencing another scope is not sliceable."""
    from ..expr.ast import AggCall, Call, ColRef, Lit

    if isinstance(e, ColRef):
        if e.table is not None:
            if e.table != label:
                raise _NotSliceable(f"foreign column {e!r}")
            return ColRef(e.name)
        if "." in e.name:
            t, _, c = e.name.partition(".")
            if t != label:
                raise _NotSliceable(f"foreign column {e!r}")
            return ColRef(c)
        return e
    if isinstance(e, Lit):
        return e
    if isinstance(e, (Call, AggCall)):
        args = tuple(_frag_bare(a, label) for a in e.args)
        return Call(e.op, args) if isinstance(e, Call) else \
            AggCall(e.op, args, e.distinct)
    raise _NotSliceable(f"not sliceable: {type(e).__name__}")


def _frag_scan_chain(node):
    """Peel a store-executable input chain down to its ScanNode: returns
    (scan, conjunct filter exprs, project mapping or None).  Raises
    _NotSliceable when the chain contains anything a store cannot run."""
    filters = []
    project = None
    while True:
        if isinstance(node, ScanNode):
            if node.ann is not None:
                raise _NotSliceable("ANN-pruned scan")
            if node.pushed_filter is not None:
                filters.append(node.pushed_filter)
            return node, filters, project
        if isinstance(node, FilterNode):
            if node.pred is not None:
                filters.append(node.pred)
            node = node.child()
            continue
        if isinstance(node, ProjectNode) and not node.derived \
                and project is None:
            project = dict(zip(node.names, node.exprs))
            node = node.child()
            continue
        raise _NotSliceable(f"chain node {type(node).__name__}")


def _frag_filter_wire(filters, label):
    from ..expr.ast import Call
    from ..expr.roweval import expr_supported, expr_to_wire

    if not filters:
        return None
    e = _frag_bare(filters[0], label)
    for f in filters[1:]:
        e = Call("and", (e, _frag_bare(f, label)))
    if not expr_supported(e):
        raise _NotSliceable(f"filter {e!r}")
    return expr_to_wire(e)


# aggregate kinds whose partials merge with sum/min/max alone — the
# store-pushable set (avg decomposes to sum+count at the STATEMENT level,
# plan/fragment._build_agg; a tree-level AggSpec("avg") is left on the
# frontend rather than guessed at)
_SLICE_AGGS = frozenset({"count", "count_star", "sum", "min", "max"})


def fragment_subtrees(plan: PlanNode) -> list:
    """Recognize the store-executable subtrees of a physical plan — the
    slicing targets of pushed-down execution:

    - ``agg``: an AggNode whose input chain is scan -> filter(s) ->
      (key-projection), with every key expr, agg arg, and filter conjunct
      row-evaluable and every aggregate in the sum/min/max-mergeable set;
    - ``join_build``: a JoinNode's build side that is a plain
      scan -> filter(s) chain — the store streams back only the build
      rows that survive the filter (rows-mode fragment), which is what
      bounds the build side's wire cost in a pushed join.

    Returns ``[{"role", "table_key", "label", "frag", "node"}, ...]``;
    subtrees that are not expressible are simply not listed (pushdown is
    an optimization with a full-fidelity fallback, never a requirement)."""
    from ..expr.ast import ColRef
    from ..expr.roweval import expr_supported, expr_to_wire
    from .fragment import GROUP_CAP

    found: list = []

    def try_agg(node: AggNode) -> None:
        scan, filters, project = _frag_scan_chain(node.child())
        keys = []
        for kn in node.key_names:
            src = (project or {}).get(kn, ColRef(kn))
            ke = _frag_bare(src, scan.label)
            if not expr_supported(ke):
                raise _NotSliceable(f"key {ke!r}")
            keys.append([kn, expr_to_wire(ke)])
        aggs = []
        for sp in node.specs:
            if sp.op not in _SLICE_AGGS or sp.distinct:
                raise _NotSliceable(f"agg {sp.op}")
            arg = None
            if sp.input is not None:
                src = (project or {}).get(sp.input, ColRef(sp.input))
                ae = _frag_bare(src, scan.label)
                if not expr_supported(ae):
                    raise _NotSliceable(f"agg arg {ae!r}")
                arg = expr_to_wire(ae)
            aggs.append([sp.op, arg, sp.out_name])
        frag = {"v": 1, "mode": "agg",
                "filter": _frag_filter_wire(filters, scan.label),
                "keys": keys, "aggs": aggs, "group_cap": GROUP_CAP}
        found.append({"role": "agg", "table_key": scan.table_key,
                      "label": scan.label, "frag": frag, "node": node})

    def try_join_build(node: JoinNode) -> None:
        scan, filters, project = _frag_scan_chain(node.children[1])
        if project is not None:
            raise _NotSliceable("projected build side")
        outputs = []
        for c in scan.columns:
            bare = c.partition(".")[2] if c.startswith(scan.label + ".") \
                else c
            outputs.append([c, expr_to_wire(ColRef(bare))])
        frag = {"v": 1, "mode": "rows",
                "filter": _frag_filter_wire(filters, scan.label),
                "outputs": outputs, "limit": None}
        found.append({"role": "join_build", "table_key": scan.table_key,
                      "label": scan.label, "frag": frag, "node": node})

    def walk(node: PlanNode) -> None:
        if isinstance(node, AggNode):
            try:
                try_agg(node)
            except _NotSliceable:
                pass
        elif isinstance(node, JoinNode) and len(node.children) > 1:
            try:
                try_join_build(node)
            except _NotSliceable:
                pass
        for c in node.children:
            walk(c)

    walk(plan)
    return found
