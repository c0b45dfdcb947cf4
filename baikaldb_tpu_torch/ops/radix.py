"""Radix hash partitioning for the sort join (the port of
``baikaldb_tpu/ops/radix.py``).

The sort join sorts its whole build side once.  Radix partitioning replaces
that sort by

1. bucket = multiplicative-hash(key) >> (64 - log2 nb), one op per row,
2. a stable bucket-major order of the rows,
3. per-bucket key sorts laid out as one ``[nb, width]`` matrix,
4. probes that hash to their bucket and binary-search only its row.

The bucket ids are bit-identical to the JAX package's: torch has no usable
uint64 arithmetic on CUDA, so the uint64 multiply is an int64 multiply,
which wraps to the same low 64 bits, by the constant's signed value, and
the logical shift is an arithmetic shift masked to ``log2 nb`` bits.

Torch has no static shapes, so ``width`` is the largest live bucket,
read to the host once (``radix_build``): no bucket overflows and there is
no retry.  Everything is plain torch; the JAX package promises a Pallas
per-bucket sort and never wrote it, so there is no kernel to port here.
"""

from __future__ import annotations

import math

import torch

from ..analysis.runtime import host_read
from ..column.batch import dtype_max

_MULT = 0x9E3779B97F4A7C15
_MULT_SIGNED = _MULT - (1 << 64)          # the same 64 bits as an int64


def bucket_of(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Multiplicative hash -> bucket id in [0, n_buckets) (int32);
    ``n_buckets`` must be a power of two (the hash's quality sits in its
    high bits)."""
    if n_buckets < 2 or n_buckets & (n_buckets - 1):
        raise ValueError("n_buckets must be a power of two >= 2 (a shift "
                         "by 64 is implementation-defined)")
    bits = int(math.log2(n_buckets))
    h = keys.to(torch.int64) * _MULT_SIGNED
    return ((h >> (64 - bits)) & (n_buckets - 1)).to(torch.int32)


def stable_bucket_order(bucket: torch.Tensor, n_buckets: int) -> tuple:
    """-> (perm, offsets, counts): ``perm`` lists row indices bucket-major,
    stable within a bucket; ``offsets[b]`` is bucket b's first position and
    ``counts[b]`` its rows (all int64)."""
    perm = torch.sort(bucket.to(torch.int64), stable=True).indices
    counts = torch.bincount(bucket.to(torch.int64), minlength=n_buckets)[:n_buckets]
    offsets = torch.cumsum(counts, 0) - counts
    return perm, offsets, counts


def radix_build(keys: torch.Tensor, dead: torch.Tensor, n_buckets: int):
    """Partition the build side and sort each bucket by key.

    -> (sort_src [nb, width], sort_keys [nb, width], width): each bucket's
    row holds its live keys in ascending order (ties in row order), padded
    with the dtype's maximum, and ``sort_src`` their source rows
    (``len(keys)`` in the padding).  Dead rows (NULL keys, filtered rows)
    go to an overflow bucket and never enter the matrix.  ``width`` is the
    largest live bucket (at least 1): the one host read."""
    nb = n_buckets
    n = keys.shape[0]
    dev = keys.device
    bucket = torch.where(dead, nb, bucket_of(keys, nb).to(torch.int64))
    _, offsets, counts = stable_bucket_order(bucket, nb + 1)
    width = max(1, int(host_read(counts[:nb].max()))) if n else 1
    # bucket-major with keys ascending inside a bucket: a stable sort by key
    # and then a stable sort by bucket
    by_key = torch.sort(keys, stable=True).indices
    src = by_key[torch.sort(bucket[by_key], stable=True).indices]
    row_bucket = bucket[src]
    slot = torch.arange(n, device=dev) - offsets[row_bucket]
    live = row_bucket < nb
    tgt = (row_bucket * width + slot)[live]
    sort_keys = torch.full((nb * width,), dtype_max(keys.dtype), dtype=keys.dtype,
                           device=dev)
    sort_src = torch.full((nb * width,), n, dtype=torch.int64, device=dev)
    sort_keys[tgt] = keys[src[live]]
    sort_src[tgt] = src[live]
    return sort_src.view(nb, width), sort_keys.view(nb, width), width


def radix_probe(pk: torch.Tensor, pdead: torch.Tensor, sort_keys: torch.Tensor,
                n_buckets: int):
    """-> (bucket, lo, hi): each probe key's match range within its
    bucket's sorted row, by a branchless binary search over the flat matrix
    from each probe's row base (``log2 width + 1`` gathers a bound, never a
    ``[n_probe, width]`` gather).  Dead probes get an empty range."""
    width = sort_keys.shape[1]
    flat = sort_keys.reshape(-1)
    b = bucket_of(pk, n_buckets)
    base = b.to(torch.int64) * width
    dt = torch.promote_types(flat.dtype, pk.dtype)
    flat, key = flat.to(dt), pk.to(dt)

    def bsearch(right: bool):
        lo = torch.zeros(pk.shape, dtype=torch.int64, device=pk.device)
        hi = torch.full(pk.shape, width, dtype=torch.int64, device=pk.device)
        for _ in range(int(width).bit_length() + 1):
            mid = (lo + hi) // 2
            v = flat[(base + mid).clamp(max=flat.shape[0] - 1)]
            go_right = (v <= key) if right else (v < key)
            active = lo < hi
            lo, hi = (torch.where(active & go_right, mid + 1, lo),
                      torch.where(active & ~go_right, mid, hi))
        return lo

    lo = torch.where(pdead, 0, bsearch(False))
    hi = torch.where(pdead, 0, bsearch(True))
    return b, lo, hi
