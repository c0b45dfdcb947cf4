"""The result parity contract: when two query results are the same result.

Two runs of one statement (the card against the CPU, or the port against
the JAX package) agree when:

- keys, counts, integers, strings, dates, NULLs and ORDER BY order are
  exact;
- floats match within ``rtol`` (1e-9 for float64 summed in another order,
  1e-4 where the float32 group-by kernels ran), with ``ATOL`` for values
  that cancel to about zero;
- result sets without ORDER BY compare as multisets;
- rows that tie on every ORDER BY key compare as a multiset within the run;
- where LIMIT cuts through a tied run, only that run's ORDER BY values
  compare.
"""

from __future__ import annotations

import math

from ..sql.parser import parse_sql

ATOL = 1e-6


def _close(a, b, rtol: float) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=rtol, abs_tol=ATOL)
    return a == b and type(a) is type(b)


def _rows_close(r1: tuple, r2: tuple, rtol: float) -> bool:
    return len(r1) == len(r2) and all(_close(a, b, rtol) for a, b in zip(r1, r2))


def _canon(row: tuple):
    """Sort key for a multiset comparison: NULL first, then the value."""
    return tuple((v is not None, v if v is not None else 0) for v in row)


def _multiset_equal(got: list, want: list, rtol: float) -> bool:
    got, want = sorted(got, key=_canon), sorted(want, key=_canon)
    return len(got) == len(want) and all(_rows_close(a, b, rtol)
                                         for a, b in zip(got, want))


def order_keys(sql: str) -> tuple[list[str], bool]:
    """The output columns the statement's ORDER BY names, and whether it has
    a LIMIT."""
    stmt = parse_sql(sql)[0]
    return [o.expr.name.split(".")[-1] for o in stmt.order_by], stmt.limit is not None


def mismatch(got: list[dict], want: list[dict], sql: str,
             rtol: float = 1e-9) -> str | None:
    """None when ``got`` and ``want`` (rows as dicts) agree under the
    contract, else what differs."""
    if len(got) != len(want):
        return f"{len(got)} rows, expected {len(want)}"
    if not want:
        return None
    cols = list(want[0])
    if any(list(r) != cols for r in got):
        return f"columns differ: expected {cols}"
    keys, has_limit = order_keys(sql)
    g = [tuple(r.values()) for r in got]
    w = [tuple(r.values()) for r in want]
    if not keys:
        return None if _multiset_equal(g, w, rtol) else "rows differ (as multisets)"
    ki = [cols.index(k) for k in keys]

    def okey(row):
        return tuple(row[i] for i in ki)

    start = 0
    while start < len(w):
        end = start + 1
        while end < len(w) and _rows_close(okey(w[end]), okey(w[start]), rtol):
            end += 1
        for i in range(start, end):
            if not _rows_close(okey(g[i]), okey(w[i]), rtol):
                return f"row {i}: ORDER BY values {okey(g[i])}, expected {okey(w[i])}"
        cut = has_limit and end == len(w)
        if not cut and not _multiset_equal(g[start:end], w[start:end], rtol):
            return f"rows {start}..{end - 1} (tied on ORDER BY) differ"
        start = end
    return None
