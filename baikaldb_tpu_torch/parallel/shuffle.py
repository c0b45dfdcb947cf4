"""MPP shuffle: the hash repartition of a row-sharded batch.

The port of ``baikaldb_tpu/parallel/shuffle.py``.  An exchange runs as in
the JAX package:

  1. each shard computes ``dest = hash(key) % n`` for its rows (dead rows
     go nowhere),
  2. orders its rows by ``dest``, stably,
  3. ``all_to_all`` (parallel/collectives.py) hands destination j the rows
     every shard sent it, in source order,

so every destination holds the JAX package's live rows in the JAX package's
order (its stable dest-major send buffer), and float sums and ORDER BY ties
downstream follow the reference.  The JAX package sends fixed ``[n, cap]``
buffers and retries with a larger ``cap`` when a destination overflows.  The
port knows each destination's exact count before it moves anything (K3,
``ops/group_kernels.partition_histogram``, one launch a shard on the card),
so it sends exactly the live rows: no capacity, no overflow flag, no retry.
``needed``, the largest count one shard sends one destination, is what the
JAX package would report as the capacity the exchange needs.

After a repartition, keys are disjoint across shards, so the executor runs
the join, the fused multiway join or the GROUP BY above it shard by shard
(exec/executor.py) with no further exchange.
"""

from __future__ import annotations

import torch

from ..analysis.runtime import host_read
from ..column.batch import ColumnBatch
from ..ops.group_kernels import partition_histogram
from ..types import LType
from ..utils.hashing import partition_ids
from .collectives import all_to_all
from .mesh import Mesh, ShardedBatch, slice_rows


def partition_key_arrays(b: ColumnBatch, key_names: list[str]) -> list:
    """Key columns -> hashable lanes for shuffle partitioning.

    String columns hash by VALUE (codes mapped through the dictionary's
    per-value hash table), so two tables with different dictionaries still
    co-locate equal strings.  NULL lanes canonicalize to 0 so every NULL-key
    row routes to one shard (validity still separates NULL from key 0 in the
    shard's group-by or join)."""
    keys = []
    for k in key_names:
        c = b.column(k)
        d = c.data
        if c.ltype is LType.STRING and c.dictionary is not None:
            if len(c.dictionary) == 0:
                d = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
            else:
                # the uint32 hashes as int32 bits: a 32-bit lane, as in the
                # JAX package (utils/hashing folds 64-bit lanes differently)
                table = torch.from_numpy(c.dictionary.value_hashes().view("int32")).to(d.device)
                d = table[d.clamp(0, len(c.dictionary) - 1).to(torch.int64)]
        if c.validity is not None:
            d = torch.where(c.validity, d, torch.zeros((), dtype=d.dtype, device=d.device))
        keys.append(d)
    return keys


def _local_repartition(b: ColumnBatch, key_names: list[str], n: int):
    """One shard's send side -> (its live rows ordered by destination,
    stably; rows per destination, int64 [n])."""
    dest = partition_ids(partition_key_arrays(b, key_names), n)
    sel = b.sel_mask().contiguous()
    counts = partition_histogram(dest.contiguous(), sel, n)
    order = torch.argsort(torch.where(sel, dest, n), stable=True)
    return order, counts


def dist_hash_repartition(sb: ShardedBatch, key_names: list[str], mesh: Mesh):
    """Hash-partition every shard's live rows on ``key_names`` and exchange
    them: equal keys land on one shard.  -> (repartitioned ShardedBatch,
    needed).  One host read (every shard's counts, together) sizes the
    exchange."""
    n = mesh.size
    sent = [_local_repartition(b, key_names, n) for b in sb.shards]
    counts = host_read(torch.stack([c.to(mesh.home) for _, c in sent])).tolist()
    sends = []
    for b, (order, _), row in zip(sb.shards, sent, counts):
        rows = b.gather(order[:sum(row)])
        off, parts = 0, []
        for c in row:
            parts.append(slice_rows(rows, off, off + c))
            off += c
        sends.append(parts)
    needed = max((c for row in counts for c in row), default=0)
    return ShardedBatch(all_to_all(sends, mesh.devices)), needed

