"""Partial-aggregate helpers shared by every consumer that merges partials.

The part of ``baikaldb_tpu/parallel/agg.py`` that the streamed fold
(exec/streaming.py) uses: ``merge_partial_agg_specs`` (specs that merge
partial columns into partials again) and ``rewrap_partial`` (a partial
table as a plain batch).  The mesh aggregation waits for the port of the
mesh (ROADMAP item 7).
"""

from __future__ import annotations

import torch

from ..column.batch import ColumnBatch
from ..ops.hashagg import MERGE_OP, AggSpec


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
