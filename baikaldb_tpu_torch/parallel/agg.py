"""Distributed aggregation: per-shard partials merged across the mesh.

The port of ``baikaldb_tpu/parallel/agg.py``.  Each shard computes the SAME
fixed-size partial table (the dense group domain, or one row for a scalar
aggregate), and the tables merge under each partial's merge op: ``psum`` for
sum and count partials, ``pmin`` / ``pmax`` for min and max
(parallel/collectives.py), the reference's partial AggNode per region plus
MERGE_AGG_NODE (BASELINE.json north-star config #2: "per-region partial agg
+ psum").  On the card each shard's partial is its own dense group-by, so
the group-by kernels (K1-K3, the segment kernel) launch once a shard.

Cardinality-adaptive partial aggregation (the Partial Partial Aggregates
policy): pre-reducing locally only pays when the group-key cardinality is
small against each shard's row count.  ``choose_strategy`` picks per query
from the index/stats ndv estimate: "local" pre-reduces before the merge or
the exchange, "raw" shuffles raw rows and aggregates once.
plan/distribute.py records the decision on the AggNode.

The streamed fold (exec/streaming.py) uses ``merge_partial_agg_specs`` and
``rewrap_partial`` too.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..column.batch import Column, ColumnBatch
from ..ops.hashagg import (MERGE_OP, AggSpec, finalize_partials,
                           group_aggregate_dense, group_aggregate_sorted,
                           partial_specs, scalar_aggregate)
from .collectives import MERGE, pany
from .mesh import Mesh, ShardedBatch
from .shuffle import dist_hash_repartition

# pre-reduce locally when the estimated groups are at most this share of a
# shard's rows (above it the partial pass moves more data than it saves);
# the JAX package's ``agg_local_ratio`` default
AGG_LOCAL_RATIO = 0.5

def choose_strategy(est_groups: Optional[int], rows_per_shard: int,
                    selectivity: Optional[float] = None) -> str:
    """-> "local" | "raw".  Pre-reduction shrinks each shard's exchange
    payload from ~rows_per_shard rows to ~min(groups, rows_per_shard)
    partials; it pays exactly when groups is well under rows_per_shard.
    Unknown cardinality (no stats) keeps the conservative raw shuffle.
    ``selectivity`` (the bound-value WHERE selectivity estimate, None = no
    basis) scales the effective rows per shard: the pre-pass only
    summarizes rows the filter keeps."""
    if est_groups is None:
        return "raw"
    if selectivity is not None:
        rows_per_shard = max(1, int(rows_per_shard * float(selectivity)))
    return "local" if est_groups <= max(1, int(rows_per_shard * AGG_LOCAL_RATIO)) \
        else "raw"


def merge_partial_agg_specs(parts: list[AggSpec]) -> list[AggSpec]:
    """Specs that re-aggregate PARTIAL rows into final partials: each
    partial column merges under its MERGE_OP (sum-of-sums, min-of-mins,
    ...) keeping its name so the finalize plan still binds."""
    return [AggSpec(MERGE_OP[p.op], p.out_name, p.out_name) for p in parts]


def rewrap_partial(part: ColumnBatch) -> ColumnBatch:
    """Partial rows as a PLAIN batch: drop the group count (the next
    aggregate recomputes liveness from sel) and make the mask explicit, so
    every merge sees the same structure."""
    sel = part.sel if part.sel is not None \
        else torch.ones(len(part), dtype=torch.bool, device=part.device)
    return ColumnBatch(part.names, part.columns, sel, None, device=part.device)


def _merge(parts: list, specs: list[AggSpec], key_names: list[str], device) -> list:
    """Merge the per-shard partial tables ``parts`` (one layout on every
    shard) column by column on ``device``: the key columns from shard 0,
    each partial under its MERGE_OP in shard order, validity where any
    shard's is set."""
    first = parts[0]
    cols = []
    for i, (name, c) in enumerate(zip(first.names, first.columns)):
        if name in key_names:
            cols.append(Column(c.data.to(device), None if c.validity is None
                               else c.validity.to(device), c.ltype, c.dictionary))
            continue
        spec = next(s for s in specs if s.out_name == name)
        merged = MERGE[MERGE_OP[spec.op]]([p.columns[i].data for p in parts], device)
        validity = None if c.validity is None else \
            pany([p.columns[i].validity for p in parts], device)
        cols.append(Column(merged, validity, c.ltype, c.dictionary))
    return cols


def _no_distinct(parts: list[AggSpec], what: str) -> None:
    if any(s.distinct for s in parts):
        raise ValueError(f"DISTINCT aggregates cannot merge partials: {what}")


def dist_group_aggregate_dense(batch: ShardedBatch, key_names: list[str],
                               domains: list[int], specs: list[AggSpec],
                               mesh: Mesh) -> ColumnBatch:
    """GROUP BY over a row-sharded batch with dense key domains: every
    shard reduces its rows into the [prod(domains + 1)] partial table, then
    the tables merge (the partial AggNode on every region + MERGE_AGG_NODE,
    src/exec/agg_node.cpp).  The output is replicated (small)."""
    parts, fin = partial_specs(specs)
    _no_distinct(parts, "they need a shuffle")
    local = [group_aggregate_dense(b, key_names, domains, parts) for b in batch.shards]
    cols = _merge(local, parts, key_names, mesh.home)
    present = pany([p.sel_mask() for p in local], mesh.home)
    merged = ColumnBatch(local[0].names, cols, present, None, device=mesh.home)
    return finalize_partials(merged, fin, key_names)


def dist_group_aggregate_partial_shuffled(batch: ShardedBatch, key_names: list[str],
                                          specs: list[AggSpec], mesh: Mesh,
                                          max_groups_per_shard: int):
    """Low-cardinality GROUP BY over the sorted strategy: each shard
    pre-reduces its rows into partial-aggregate rows (AVG -> SUM + COUNT,
    ...), repartitions only the PARTIALS on the key hash, and merges
    co-located partials once: the "local" arm of the adaptive policy.  The
    exchange moves O(groups) rows a shard instead of O(rows).
    -> (sharded batch, the exchange's needed)."""
    parts, fin = partial_specs(specs)
    merge_specs = merge_partial_agg_specs(parts)
    local = []
    for b in batch.shards:
        mg_part = min(max_groups_per_shard, max(1, len(b)))
        local.append(rewrap_partial(group_aggregate_sorted(b, key_names, parts, mg_part)))
    shuf, needed = dist_hash_repartition(ShardedBatch(local), key_names, mesh)
    out = []
    for b in shuf.shards:
        final = group_aggregate_sorted(b, key_names, merge_specs, max(1, len(b)))
        out.append(finalize_partials(final, fin, key_names))
    return ShardedBatch(out), needed


def dist_scalar_aggregate(batch: ShardedBatch, specs: list[AggSpec],
                          mesh: Mesh) -> ColumnBatch:
    """Global aggregates (no GROUP BY) over a row-sharded batch."""
    parts, fin = partial_specs(specs)
    _no_distinct(parts, "scalar ones need a gather")
    local = [scalar_aggregate(b, parts) for b in batch.shards]
    merged = ColumnBatch(local[0].names, _merge(local, parts, [], mesh.home), None, None,
                         device=mesh.home)
    return finalize_partials(merged, fin, [])
