"""Out-of-core streaming scans: double-buffered prefetch + chunk folding.

The port of ``baikaldb_tpu/exec/streaming.py``.  ``device_table_batch``
bounds a scan by what fits on the card at once.  This module removes that
bound for the plan shape it hurts most — scan -> filter -> aggregate — by
running it as a FOLD over the table's chunked segments
(storage/streamchunks.py):

- eligibility (``eligible``): the whole plan must be one Project/Filter/
  Sort/Limit chain under the root down to a single AggNode, then a
  Project/Filter chain down to exactly one ScanNode.  The aggregate must be
  expressible as mergeable partials (ops/hashagg.partial_specs): no
  DISTINCT, no row-set aggregates, and no scalar (keyless) stddev/variance
  — the keyless aggregate uses a mean-centered formula the sumsq partial
  form does not reproduce;
- the fold step, per chunk: evaluate the below-agg chain over the chunk,
  aggregate it into partials (through the group-by kernels when the dense
  gate admits the partial specs), merge the partials into the accumulator
  under the MERGE_OP protocol.  Torch runs eagerly and needs no static
  shapes, so the first partial is the accumulator and each chunk's tensors
  die when the loop drops them (the reference's ``eval_shape`` fixpoint
  and buffer donation have no counterpart here).  A dense or scalar
  accumulator holds the same slots as every partial, so its merge is
  elementwise (``_combine``); the reference stacks the two tables and
  group-bys them again, which on the card costs a few dozen more launches
  per chunk for the same values.  The sorted strategy merges as the
  reference does;
- a daemon thread decodes the next chunks (segment read -> decode ->
  pinned ring slot) while chunk i folds, and the folding thread issues
  chunk i+1's copy on a side stream before it folds chunk i, so host
  decode and the copy overlap the fold; the fold waits for a chunk's copy
  on the compute stream, not on the host.  ``stream_prefetch_wait_ms``
  against the per-chunk stage time is the overlap measurement;
- sorted-strategy accumulators carry an overflow bit ORed on the device
  and read ONCE on the host, after the loop; overflow restarts the whole
  fold with a doubled accumulator, bounded by the table's row count;
- the finalize step (partials -> user aggregates, then the remainder of
  the plan above the aggregate) runs over a plan copy whose agg subtree is
  replaced by a StreamResultNode leaf.

With ``streaming_scan`` off (or any gate failing) the session takes the
resident path unchanged.
"""

from __future__ import annotations

import copy
import time

import torch

from ..column.batch import (Column, ColumnBatch, bucket_capacity, concat_batches,
                            dtype_max, dtype_min)
from ..expr.params import PARAMS_KEY, bind_params
from ..obs import progress, trace
from ..ops.hashagg import (finalize_partials, group_aggregate_dense,
                           group_aggregate_sorted, partial_specs, scalar_aggregate)
from ..parallel.agg import merge_partial_agg_specs, rewrap_partial
from ..plan.nodes import (AggNode, FilterNode, LimitNode, PlanNode,
                          ProjectNode, ScanNode, SortNode, StreamResultNode)
from ..storage.streamchunks import ChunkLoader, ChunkSource
from ..utils import metrics
from ..utils.prefetch import staged
from . import executor

# the batches-dict slot the remainder plan's StreamResultNode leaf reads
STREAM_KEY = "__stream__"

# keyless stddev/variance use hashagg's mean-centered formula; the sumsq
# partial finalize is a different float expression
_SCALAR_NO_PARTIAL = ("stddev", "stddev_samp", "variance", "var_samp")

# the chain nodes a fold can leave for the finalize step (above the agg) /
# evaluate per chunk (below it) — anything else (joins, windows, distinct,
# unions, subquery sources) needs cross-chunk row visibility
_ABOVE_OK = (ProjectNode, FilterNode, SortNode, LimitNode)
_BELOW_OK = (ProjectNode, FilterNode)


def eligible(plan: PlanNode, scan_node=None):
    """-> (above_chain, agg, below_root, scan) when ``plan`` is a
    chunk-foldable single-scan aggregate, else None.  ``scan_node`` (when
    given) must be the one ScanNode the walk lands on — the session calls
    this per scan it is about to stage."""
    above: list = []
    node = plan
    while not isinstance(node, AggNode):
        if isinstance(node, _ABOVE_OK) and len(node.children) == 1:
            above.append(node)
            node = node.children[0]
        else:
            return None
    agg = node
    if agg.merge or getattr(agg, "agg_dist", ""):
        return None
    if len(agg.children) != 1:
        return None
    try:
        parts, _fin = partial_specs(agg.specs)
    except ValueError:          # ROW_AGGS have no scalar partial form
        return None
    if any(p.distinct for p in parts) or any(s.distinct for s in agg.specs):
        return None
    if not agg.key_names and any(s.op in _SCALAR_NO_PARTIAL
                                 for s in agg.specs):
        return None
    below = agg.children[0]
    node = below
    while not isinstance(node, ScanNode):
        if isinstance(node, _BELOW_OK) and len(node.children) == 1:
            node = node.children[0]
        else:
            return None
    scan = node
    if scan.children or getattr(scan, "ann", None) is not None:
        return None
    if scan_node is not None and scan is not scan_node:
        return None
    return above, agg, below, scan


def stream_source(batches: dict):
    """The (table_key, ChunkSource) riding this execution's batches, or
    None — how the session recognizes a streamed execution."""
    for k, v in batches.items():
        if isinstance(v, ChunkSource):
            return k, v
    return None


class StreamRunner:
    """One plan's streamed execution: the per-chunk fold, the sorted
    accumulator's capacity, and the finalize/remainder step."""

    def __init__(self, plan: PlanNode, table_key: str, device):
        parsed = eligible(plan)
        if parsed is None:          # the session gated on this already
            raise executor.ExecError("plan is not streaming-eligible")
        self.table_key = table_key
        self.device = torch.device(device)
        above, self.agg, self.below, _scan = parsed
        self.parts, self.finalize = partial_specs(self.agg.specs)
        self.merge_specs = merge_partial_agg_specs(self.parts)
        self.keys = list(self.agg.key_names)
        self.shift = dict(getattr(self.agg, "key_shift", {}) or {})
        self.sorted = bool(self.keys) and self.agg.strategy == "sorted"
        self.acc_cap = 0            # sorted strategy only (``_size``)
        self.cap_limit = 0
        # the finalize step runs the plan ABOVE the aggregate against the
        # folded result: shallow node copies, so the live plan's nodes
        # never alias the remainder's
        rem: PlanNode = StreamResultNode(key=STREAM_KEY)
        rem.schema = getattr(self.agg, "schema", None)
        for anc in reversed(above):
            c = copy.copy(anc)
            c.children = [rem]
            rem = c
        self.remainder = rem

    # -- the fold step ----------------------------------------------------
    def _partial(self, chunk):
        child = executor._eval(self.below, {self.table_key: chunk}, executor.Ctx(self.device))
        if not self.keys:
            return rewrap_partial(scalar_aggregate(child, self.parts))
        if self.agg.strategy == "dense":
            work = executor._shift_keys(child, self.shift, -1) if self.shift else child
            return rewrap_partial(group_aggregate_dense(
                work, self.keys, self.agg.domains, self.parts))
        # per-chunk cap = chunk capacity: a chunk cannot carry more groups
        # than rows, so the PARTIAL never overflows — only the merge into
        # the accumulator needs the overflow bit
        return rewrap_partial(group_aggregate_sorted(
            child, self.keys, self.parts, len(chunk)))

    def _merge(self, acc, part):
        """-> (accumulator, overflow bit or None).  ``acc`` None: the first
        partial is the accumulator (sorted: it merges alone, into the
        accumulator's capacity)."""
        if not self.sorted:
            return (part if acc is None else self._combine(acc, part)), None
        both = concat_batches([part] if acc is None else [acc, part])
        out, ovf = group_aggregate_sorted(both, self.keys, self.merge_specs,
                                          self.acc_cap, with_overflow=True)
        return rewrap_partial(out), ovf

    def _combine(self, acc, part):
        """Merge two dense (or scalar) partial tables slot by slot: both
        hold the same slots, so each partial column merges elementwise under
        its MERGE_OP.  The same values, validity and slot liveness as the
        reference's group-by over the two tables stacked (a slot's sum is
        the sum of its two live values, its min/max their extreme), without
        the stacked tables' segment reductions."""
        sel = acc.sel | part.sel
        cols = [acc.column(k) for k in self.keys]
        for m in self.merge_specs:
            a, p = acc.column(m.input), part.column(m.input)
            la, lp = acc.sel & a.valid_mask(), part.sel & p.valid_mask()
            if m.op == "sum":
                dt = torch.int64 if a.ltype.is_integer else torch.float64
                zero = torch.zeros((), dtype=dt, device=sel.device)
                data = torch.where(la, a.data.to(dt), zero) + torch.where(lp, p.data.to(dt), zero)
            else:
                big = dtype_max(a.data.dtype) if m.op == "min" else dtype_min(a.data.dtype)
                ident = torch.tensor(big, dtype=a.data.dtype, device=sel.device)
                f = torch.minimum if m.op == "min" else torch.maximum
                data = f(torch.where(la, a.data, ident), torch.where(lp, p.data, ident))
            cols.append(Column(data, la | lp, a.ltype, a.dictionary))
        return ColumnBatch(acc.names, cols, sel, None, device=acc.device)

    def _finalize_batch(self, acc):
        out = acc
        if self.keys and self.agg.strategy == "dense" and self.shift:
            out = executor._shift_keys(out, self.shift, +1)
        return finalize_partials(out, self.finalize, self.keys)

    # -- the drive loop -----------------------------------------------------
    def _size(self, cs) -> None:
        """The sorted accumulator's first capacity (the planner's group
        estimate) and its limit (the table's row count)."""
        self.cap_limit = bucket_capacity(max(1, cs.total_rows))
        if self.sorted:
            want = self.agg.max_groups or 1024
            self.acc_cap = min(bucket_capacity(want), self.cap_limit)

    def run(self, source: ChunkSource):
        cs = source.chunks
        self._size(cs)
        nlive = sum(1 for n in cs.live if n)
        skipped = nlive - len(source.keep)
        if skipped:
            metrics.stream_chunks_skipped.add(skipped)
        stats = {"chunks": 0, "chunks_total": cs.n_chunks,
                 "skipped": skipped, "bytes_h2d": 0,
                 "prefetch_wait_ms": 0.0, "stage_ms": 0.0, "restarts": 0}
        while True:
            acc, ovf = self._fold(source, stats)
            # the one host read of the overflow bit, after the whole fold
            if ovf is None or not bool(ovf):
                break
            # sorted accumulator overflowed: the only carry-dependent
            # capacity.  Grow (bounded by the table's row count — the true
            # group count can never exceed it) and re-fold
            if self.acc_cap >= self.cap_limit:
                raise executor.ExecError(
                    "stream aggregate overflow at table row capacity")
            self.acc_cap = min(self.acc_cap * 2, self.cap_limit)
            metrics.stream_restarts.add(1)
            stats["restarts"] += 1
        with trace.span("stream.finalize"):
            out = executor._eval(self.remainder,
                                 {STREAM_KEY: self._finalize_batch(acc)},
                                 executor.Ctx(self.device))
        trace.event("stream", **{k: (round(v, 3) if isinstance(v, float) else v)
                                 for k, v in stats.items()})
        return out

    def _fold(self, source: ChunkSource, stats: dict):
        cs = source.chunks
        # zero chunks survived pruning: fold chunk 0 with an all-False sel
        # so the aggregate still sees its (empty) input — COUNT renders 0,
        # not a missing row
        dead = not source.keep
        ids = source.keep or [0]
        loader = ChunkLoader(cs)

        def stage(i):
            t0 = time.perf_counter()
            slot = loader.stage(i, dead=dead)
            return slot, (time.perf_counter() - t0) * 1e3

        def take():
            t0 = time.perf_counter()
            _i, (slot, stage_ms) = next(it)
            wait = (time.perf_counter() - t0) * 1e3
            chunk = loader.upload(slot)
            metrics.stream_prefetch_wait_ms.observe(wait)
            metrics.stream_bytes_h2d.add(chunk.nbytes)
            stats["prefetch_wait_ms"] += wait
            stats["stage_ms"] += stage_ms
            stats["bytes_h2d"] += chunk.nbytes
            return chunk

        acc, ovf = None, None
        qp = progress.current()
        op = f"StreamScan({self.table_key})"
        it = staged(ids, stage, name="stream-prefetch")
        try:
            with trace.span("stream.fold", chunks=len(ids)):
                nxt = None
                for m in range(len(ids)):
                    # a beat a chunk, before the next copy is issued: a KILL
                    # lands between two chunks' launches (and before the
                    # first chunk of an overflow re-fold)
                    qp.beat(operator=op, chunk_no=m, chunks_total=len(ids))
                    chunk = nxt if nxt is not None else take()
                    # the next chunk's copy goes out before this one folds
                    nxt = take() if m + 1 < len(ids) else None
                    loader.wait(chunk)
                    acc, movf = self._merge(acc, self._partial(chunk.batch))
                    if movf is not None:
                        ovf = movf if ovf is None else ovf | movf
                    del chunk
                    if not dead:
                        metrics.stream_chunks.add(1)
                        stats["chunks"] += 1
                qp.beat(chunk_no=len(ids), chunks_total=len(ids))
        finally:
            it.close()      # stops the stager and drains on early exit
        return acc, ovf


def run_streamed(plan: PlanNode, batches: dict, device):
    """Entry point from the session's ``_select``: fold the ChunkSource in
    ``batches`` on ``device`` (a parameterized plan's bound values bound
    for the whole fold) and return the (padded) result batch for egress."""
    src = stream_source(batches)
    if src is None:
        raise executor.ExecError("no chunk source in batches")
    table_key, source = src
    params = batches.get(PARAMS_KEY)
    with bind_params(executor.device_params(params, device) if params is not None else ()):
        return StreamRunner(plan, table_key, device).run(source)
