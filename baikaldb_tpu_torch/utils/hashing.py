"""Vectorized integer hashing for group keys, HLL registers and HASH().

The port of ``baikaldb_tpu/utils/hashing.py``, bit-identical to it.  Keys are
fixed-width lanes; each becomes a uint32 (``_as_u32``), goes through the
murmur3 finalizer and the columns fold with an xor-mix.

Torch has no usable uint32 arithmetic (multiply, shift and ``%`` are missing
for ``torch.uint32`` on both devices), so every "uint32" here is an int64
tensor holding a value in ``[0, 2**32)``:

- a right shift of an unsigned value is ``(x >> k) & MASK`` (the values are
  non-negative, so the arithmetic shift already matches);
- a 32-bit multiply is split into 16-bit halves (``_mul32``), so no int64
  product overflows;
- float bits are read with ``.view(torch.int32)``; float64 goes through the
  JAX package's 53-bit mantissa split (``split64``), and -0.0 and
  subnormals are folded to 0.0 before hashing, as ``_as_u32`` does there.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for x in [0, 2**32) without an int64 overflow:
    the low 16 bits times c stay below 2**48, and of the high half's
    product only the bits that land below 2**32 are kept."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def split64(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A 64-bit lane tensor -> (lo, hi) 32-bit halves (int64 tensors).

    Integers split by mask and shift.  float64 decomposes as in the JAX
    package: frexp gives an exact (sign, exponent, 53-bit mantissa), the
    mantissa splits into two words and the exponent and sign go into the high
    word.  A non-finite value hashes as a zero mantissa and exponent with its
    sign (what the JAX package's float->uint32 conversions give), and a
    subnormal as the mantissa 0.5 and exponent -1074 (what its frexp gives
    on the CPU, where XLA flushes subnormals)."""
    if x.dtype.is_floating_point:
        x = x.to(torch.float64)
        neg = torch.signbit(x).to(torch.int64)
        finite = torch.isfinite(x)
        m, e = torch.frexp(torch.where(finite, x.abs(), torch.zeros_like(x)))
        sub = (x != 0) & (x.abs() < torch.finfo(torch.float64).tiny)
        m = torch.where(sub, 0.5, m)
        e = torch.where(sub, -1074, e)
        m53 = m * 2.0 ** 53                        # integer-valued, < 2**53
        lo = torch.remainder(m53, 4294967296.0).to(torch.int64)
        hi = torch.div(m53, 4294967296.0, rounding_mode="floor").to(torch.int64)
        ebits = (e.to(torch.int64) & MASK) << 21
        hi = (hi ^ ebits ^ (neg << 31)) & MASK
        return lo, hi
    x = x.to(torch.int64)
    return x & MASK, (x >> 32) & MASK


def _fold64(x: torch.Tensor) -> torch.Tensor:
    """Fold a 64-bit lane tensor to 32 bits via split64 + xor-mix."""
    lo, hi = split64(x)
    return lo ^ _mul32(hi, GOLDEN)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """Reduce any fixed-width lane to a 32-bit value (int64 tensor),
    canonicalizing -0.0 and widths."""
    if x.dtype is torch.bool:
        return x.to(torch.int64)
    if x.dtype.is_floating_point:
        # -0.0 == 0.0; and subnormals compare equal to zero in the JAX
        # package (XLA flushes them), so they hash as zero too
        zero = x.abs() < torch.finfo(x.dtype).tiny
        x = torch.where(zero, torch.zeros_like(x), x)
        if x.element_size() == 8:
            return _fold64(x)
        return x.to(torch.float32).view(torch.int32).to(torch.int64) & MASK
    if x.element_size() == 8:
        return _fold64(x)
    return x.to(torch.int64) & MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32: bijective avalanche on 32-bit lanes."""
    x = x.to(torch.int64) & MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_columns(arrays: list, seed: int = 0x12345678) -> torch.Tensor:
    """Combine N key tensors -> a 32-bit hash per row (int64 tensor)."""
    first = arrays[0]
    h = torch.full(first.shape, seed & MASK, dtype=torch.int64, device=first.device)
    for a in arrays:
        h = mix32(h ^ mix32(_as_u32(a)))
    return h


def partition_ids(arrays: list, num_partitions: int) -> torch.Tensor:
    """Row -> partition id in [0, num_partitions), for MPP-style shuffle."""
    return torch.remainder(hash_columns(arrays), num_partitions).to(torch.int32)
