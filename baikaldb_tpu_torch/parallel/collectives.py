"""The mesh's collectives, as plain functions over per-shard values.

The counterparts of ``jax.lax.all_gather`` / ``psum`` / ``pmin`` / ``pmax`` /
``all_to_all`` over the mesh axis, which the JAX package's executor and
``parallel/`` modules call inside ``shard_map``.  Here a per-shard value is a
list indexed by shard (shard i on ``mesh.devices[i]``) and each collective
runs from the single controller:

- ``all_gather``: concatenate every shard's batch, in shard order;
- ``psum`` / ``pmin`` / ``pmax``: reduce in shard order 0 ... n-1, in the
  partial's own dtype;
- ``all_to_all``: destination j takes part j of every shard's send list, in
  source order.

Across devices the data moves with ``.to(device, non_blocking=True)``:
PyTorch orders a copy between two CUDA devices after the work queued on the
source's current stream and before later work on the destination's.  On one
device they are concatenations and elementwise reductions only.
"""

from __future__ import annotations

import torch

from ..column.batch import ColumnBatch, concat_batches
from .mesh import to_device


def all_gather(parts: list, device) -> ColumnBatch:
    """Every shard's rows, live and dead, in shard order, on ``device``
    (the replicated value)."""
    return concat_batches([to_device(p, device) for p in parts])


def _reduce(xs: list, device, op) -> torch.Tensor:
    device = torch.device(device)
    acc = xs[0].to(device, non_blocking=True)
    for x in xs[1:]:
        acc = op(acc, x.to(device, non_blocking=True))
    return acc


def psum(xs: list, device) -> torch.Tensor:
    return _reduce(xs, device, torch.add)


def pmin(xs: list, device) -> torch.Tensor:
    return _reduce(xs, device, torch.minimum)


def pmax(xs: list, device) -> torch.Tensor:
    return _reduce(xs, device, torch.maximum)


def pany(xs: list, device) -> torch.Tensor:
    """Elementwise OR of bool tensors (the ``psum(x.astype(int)) > 0`` of
    the JAX package)."""
    return _reduce(xs, device, torch.logical_or)


MERGE = {"sum": psum, "min": pmin, "max": pmax}


def all_to_all(sends: list, devices) -> list:
    """``sends[s][j]``: the batch shard s sends to shard j.  -> one batch
    per destination j, on ``devices[j]``: the concatenation over s of
    ``sends[s][j]``, in source order."""
    return [concat_batches([to_device(sends[s][j], dev) for s in range(len(sends))])
            for j, dev in enumerate(devices)]
