"""A mesh of shards and the row-axis sharding of column batches.

The port of ``baikaldb_tpu/parallel/mesh.py``.  The JAX package runs a mesh
as one ``shard_map`` program over a ``jax.sharding.Mesh`` of devices, from a
single controller.  The port keeps the single controller: a :class:`Mesh` is
``n`` shards, each placed on a torch device, and a row-sharded value is a
:class:`ShardedBatch`, one :class:`ColumnBatch` per shard.  The executor runs
each shard's operators in turn and the collectives of
``parallel/collectives.py`` move rows between the shards' batches.
``make_mesh(n)`` spreads the shards over the CUDA devices there are (all of
them on ``cuda:0`` on a one-card machine, the same SPMD program the JAX
tests run on 8 virtual CPU devices); ``make_mesh(n, device="cpu")`` puts
every shard on the CPU.

Every shard holds the same number of rows, as in the JAX package: the
table's rows are cut into ``n`` equal slices of the length the JAX package
gives them under its default power-of-two capacity buckets, the tail
filled with dead rows (``sel`` False).  So each shard holds exactly the
table rows it holds there.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..column.batch import ColumnBatch, bucket_capacity, pad_batch

# smallest capacity bucket of a sharded table: the JAX package's
# ``batch_bucket_min`` default, under its default ``batch_bucketing``
BATCH_BUCKET_MIN = 1024

@dataclass(frozen=True)
class Mesh:
    """``devices[i]`` holds shard i; replicated values live on ``home``."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


@dataclass
class ShardedBatch:
    """One row-sharded value: ``shards[i]`` lies on the mesh's device i."""

    shards: list

    @property
    def names(self) -> tuple:
        return self.shards[0].names


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards.  With no ``device`` shard i lies on
    ``cuda:(i % torch.cuda.device_count())`` (one shard per card by
    default), and no CUDA device raises; any other ``device`` (``"cpu"``,
    ``"cuda:1"``) holds every shard."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("baikaldb_tpu_torch runs on a CUDA device and none "
                               "is available; pass device='cpu' to make a CPU mesh")
        count = torch.cuda.device_count()
        n = n_devices or count
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        n = n_devices or 1
        devices = (torch.device(device),) * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(devices)


def shard_length(rows: int, n: int) -> int:
    """Rows of each shard for a table of ``rows`` rows, as the JAX package
    gives them: its device image pads to ``bucket_capacity(rows,
    batch_bucket_min)`` rows and ``shard_batch`` cuts that into ``n`` slices
    of ``bucket_capacity(ceil(padded / n), batch_bucket_min // n)``."""
    padded = bucket_capacity(rows, BATCH_BUCKET_MIN)
    per = -(-max(padded, 1) // n)
    return bucket_capacity(per, max(1, BATCH_BUCKET_MIN // n))


def slice_rows(b: ColumnBatch, lo: int, hi: int) -> ColumnBatch:
    """Rows ``[lo, hi)`` of ``b`` (views)."""
    cols = [replace(c, data=c.data[lo:hi],
                    validity=None if c.validity is None else c.validity[lo:hi])
            for c in b.columns]
    sel = None if b.sel is None else b.sel[lo:hi]
    return ColumnBatch(b.names, cols, sel, None, device=b.device)


def to_device(b: ColumnBatch, device) -> ColumnBatch:
    """``b`` on ``device`` (itself when it already lies there)."""
    device = torch.device(device)
    if b.device == device:
        return b
    cols = [replace(c, data=c.data.to(device, non_blocking=True),
                    validity=None if c.validity is None
                    else c.validity.to(device, non_blocking=True))
            for c in b.columns]
    sel = None if b.sel is None else b.sel.to(device, non_blocking=True)
    nr = None if b.num_rows is None else b.num_rows.to(device, non_blocking=True)
    return ColumnBatch(b.names, cols, sel, nr, b.live_prefix, device=device)


def shard_batch(batch: ColumnBatch, mesh: Mesh) -> ShardedBatch:
    """Cut a whole-table batch into the mesh's shards, shard i holding rows
    ``[i * per, (i + 1) * per)`` (``per`` from :func:`shard_length`), the
    tail past the table's end dead.  A shard that lies wholly inside the
    table is a view of ``batch`` where it already sits on the shard's
    device; the others are padded copies."""
    from ..obs import trace

    with trace.span("mesh.shard", rows=len(batch), devices=mesh.size):
        n = mesh.size
        per = shard_length(len(batch), n)
        rows = len(batch)
        shards = []
        for i, dev in enumerate(mesh.devices):
            lo, hi = min(i * per, rows), min((i + 1) * per, rows)
            part = slice_rows(batch, lo, hi)
            if hi - lo < per:
                part = pad_batch(part, per)
            shards.append(to_device(part, dev))
        return ShardedBatch(shards)


def shard_of(value, i: int, mesh: Mesh) -> ColumnBatch:
    """Shard i's part of a sharded value, or a replicated value on shard
    i's device (what every shard of the JAX program holds of it)."""
    if isinstance(value, ShardedBatch):
        return value.shards[i]
    return to_device(value, mesh.devices[i])
