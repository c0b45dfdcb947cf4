"""Window functions (the port of ``baikaldb_tpu/ops/window.py``).

One stable multi-key sort (``ops/sort.sort_permutation``) puts rows in
(partition, order) order; every window function is then O(n) prefix math
over the sorted rows — ``cumsum``, ``cummax`` of segment starts and gathers —
and the results go back to the batch's row order through the inverse
permutation.  No per-partition loops: a million tiny partitions cost what
one big one costs.

Where the JAX package runs ``lax.associative_scan`` for the segmented running
MIN/MAX, the port runs a log-step (Hillis-Steele) scan (``_seg_running``):
``ceil(log2 n)`` elementwise passes, each combining every row with the row
``2**k`` before it when both lie in one partition.  It is exact (MIN/MAX
only select), it propagates NaN as ``torch.minimum``/``maximum`` do, as
``jnp.minimum``/``maximum`` do in the JAX scan, and it needs no table.
``torch.cummax`` over one key packing the segment id above the value does
not fit: a float64's order-preserving image takes all 64 bits, and NaN has
no place in that order.  Framed MIN/MAX whose both bounds slide use a sparse
table of ``ceil(log2 n)`` levels, as in the JAX package.

Running and framed SUM/AVG are differences of one global prefix sum, as in
the JAX package: their rounding error is relative to the prefix of the whole
column, not to the partition's sum.  Every gather clamps its index
explicitly (a CUDA gather asserts on an out-of-range index).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..column.batch import Column, ColumnBatch, dtype_max, dtype_min, to_tensor
from ..column.dictionary import Dictionary
from ..types import LType
from .segments import seg_max, seg_min, seg_sum
from .sort import SortKey, sort_permutation


@dataclass(frozen=True)
class WinSpec:
    op: str                      # row_number | rank | dense_rank | ntile |
    #                              lead | lag | first_value | last_value |
    #                              sum | count | avg | min | max (partition or
    #                              running)
    input: Optional[str] = None
    out_name: str = ""
    offset: int = 1              # lead/lag
    default: Optional[float] = None
    n: int = 1                   # ntile buckets
    running: bool = False        # ROWS UNBOUNDED PRECEDING .. CURRENT ROW
    # explicit frame: ("rows"|"range", lo_bound, hi_bound), bounds as in
    # expr/ast.WindowCall
    frame: Optional[tuple] = None


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` with ``i`` clamped into range."""
    n = x.shape[0]
    if n == 0:
        return x[:0]
    return x[i.to(torch.int64).clamp(0, n - 1)]


def _cummax(x: torch.Tensor) -> torch.Tensor:
    if x.shape[0] == 0:
        return x
    return torch.cummax(x, 0).values


def window_compute(batch: ColumnBatch, partition_names: list[str],
                   order_keys: list[SortKey], specs: list[WinSpec]) -> ColumnBatch:
    """Append window-function columns (aligned to the batch's row order)."""
    n = len(batch)
    dev = batch.device
    sel = batch.sel_mask()

    # partition keys (primary) then order keys; dead rows last — one stable
    # multi-key sort, shared with ORDER BY
    perm = sort_permutation(batch, [SortKey(p, True) for p in partition_names]
                            + list(order_keys))
    pkey_data = []
    for pn in partition_names:
        c = batch.column(pn)
        d = c.data
        if d.dtype is torch.bool:
            d = d.to(torch.int32)
        if c.validity is not None:
            d = torch.where(c.validity, d, torch.zeros((), dtype=d.dtype, device=dev))
        pkey_data.append((c, d))

    idx = torch.arange(n, device=dev)
    inv = torch.empty_like(perm)
    inv[perm] = idx
    sel_s = sel[perm]

    def changed(x):
        return x != torch.roll(x, 1)

    # partition boundaries (NULL keys canonicalized above)
    flags = idx == 0
    for c, d in pkey_data:
        flags = flags | changed(d[perm])
        if c.validity is not None:
            flags = flags | changed(c.validity[perm])
    flags = flags | changed(sel_s)

    # order-key tie boundaries (for rank/dense_rank and RANGE peers)
    tie = flags
    for k in order_keys:
        c = batch.column(k.name)
        tie = tie | changed(c.data[perm])
        if c.validity is not None:
            tie = tie | changed(c.validity[perm])

    start_idx = _cummax(torch.where(flags, idx, 0))
    row_number = idx - start_idx + 1
    sid = torch.cumsum(flags.to(torch.int64), 0) - 1
    nseg = n + 1
    seg_size = seg_sum(sel_s.to(torch.int64), torch.where(sel_s, sid, n), nseg)[:n]
    size_here = _at(seg_size, sid)
    end_idx = start_idx + size_here.clamp(min=1) - 1

    names = list(batch.names)
    cols = list(batch.columns)
    fctx = None
    if any(s.frame for s in specs):
        # tie (peer) group bounds, shared by RANGE CURRENT ROW bounds
        tstart = _cummax(torch.where(tie, idx, 0))
        tid = torch.cumsum(tie.to(torch.int64), 0) - 1
        tsize = seg_sum(sel_s.to(torch.int64), torch.where(sel_s, tid, n), nseg)[:n]
        tend = tstart + _at(tsize, tid).clamp(min=1) - 1
        fctx = {"tstart": tstart, "tend": tend, "sid": sid,
                "start": start_idx, "end": end_idx, "idx": idx,
                "sel_s": sel_s, "nseg": nseg, "order_keys": order_keys,
                "perm": perm}
    for s in specs:
        if s.frame is not None:
            res = _one_framed(s, batch, fctx)
        else:
            res = _one(s, batch, perm, idx, sel_s, tie, sid, start_idx,
                       end_idx, row_number, size_here)
        if len(res) == 4:
            out_sorted, validity_sorted, lt, dct = res
        else:
            out_sorted, validity_sorted, lt = res
            dct = None
            if s.input is not None and lt is LType.STRING:
                dct = batch.column(s.input).dictionary
        data = out_sorted[inv]
        validity = None if validity_sorted is None else validity_sorted[inv]
        names.append(s.out_name)
        cols.append(Column(data, validity, lt, dct))
    return ColumnBatch(tuple(names), cols, batch.sel, batch.num_rows, device=dev)


def _identity(x: torch.Tensor, op: str):
    return dtype_max(x.dtype) if op == "min" else dtype_min(x.dtype)


def _one(s: WinSpec, batch, perm, idx, sel_s, tie, sid, start_idx, end_idx,
         row_number, size_here):
    n = idx.shape[0]
    dev = idx.device
    if s.op == "row_number":
        return row_number.to(torch.int64), None, LType.INT64
    if s.op == "rank":
        tstart = _cummax(torch.where(tie, idx, 0))
        return (tstart - start_idx + 1).to(torch.int64), None, LType.INT64
    if s.op == "dense_rank":
        c = torch.cumsum(tie.to(torch.int64), 0)
        return c - _at(c, start_idx) + 1, None, LType.INT64
    if s.op == "ntile":
        t = torch.div((row_number - 1) * s.n, size_here.clamp(min=1),
                      rounding_mode="floor") + 1
        return t.to(torch.int64), None, LType.INT64
    if s.op == "count" and s.input is None:
        # COUNT(*) OVER: all live rows count
        if s.running:
            return row_number.to(torch.int64), None, LType.INT64
        return size_here.to(torch.int64), None, LType.INT64

    c = batch.column(s.input)
    x = c.data[perm]
    xv = c.valid_mask()[perm] & sel_s

    if s.op in ("lead", "lag"):
        return _lead_lag(s, c, x, xv, idx, sid, sel_s)
    if s.op == "first_value":
        return _at(x, start_idx), _at(xv, start_idx), c.ltype
    if s.op == "last_value":
        if s.running:
            # default ordered frame (UNBOUNDED PRECEDING..CURRENT ROW):
            # LAST_VALUE is the current row's value
            return x, xv, c.ltype
        return _at(x, end_idx), _at(xv, end_idx), c.ltype

    # aggregates (partition-wide or running)
    dt = torch.int64 if c.ltype.is_integer else torch.float64
    xa = torch.where(xv, x.to(dt), torch.zeros((), dtype=dt, device=dev))
    ones = xv.to(torch.int64)
    sum_type = LType.INT64 if dt is torch.int64 else LType.FLOAT64
    if s.running:
        cs = torch.cumsum(xa, 0)
        run_sum = cs - _at(cs - xa, start_idx)
        cn = torch.cumsum(ones, 0)
        run_cnt = cn - _at(cn - ones, start_idx)
        if s.op == "sum":
            return run_sum, run_cnt > 0, sum_type
        if s.op == "count":
            return run_cnt, None, LType.INT64
        if s.op == "avg":
            return (run_sum.to(torch.float64) / run_cnt.clamp(min=1)), run_cnt > 0, \
                LType.FLOAT64
        if s.op in ("min", "max"):
            xm = torch.where(xv, x, torch.tensor(_identity(x, s.op), dtype=x.dtype,
                                                 device=dev))
            comb = torch.minimum if s.op == "min" else torch.maximum
            return _seg_running(xm, sid, comb), run_cnt > 0, c.ltype
        raise ValueError(f"unsupported running window aggregate {s.op}")
    # partition-wide
    gid = torch.where(sel_s, sid, n)
    if s.op == "count":
        return _at(seg_sum(ones, gid, n + 1)[:n], sid), None, LType.INT64
    cnt = _at(seg_sum(ones, gid, n + 1)[:n], sid)
    if s.op == "sum":
        return _at(seg_sum(xa, gid, n + 1)[:n], sid), cnt > 0, sum_type
    if s.op == "avg":
        t = _at(seg_sum(xa.to(torch.float64), gid, n + 1)[:n], sid)
        return t / cnt.clamp(min=1), cnt > 0, LType.FLOAT64
    if s.op in ("min", "max"):
        xm = torch.where(xv, x, torch.tensor(_identity(x, s.op), dtype=x.dtype, device=dev))
        f = seg_min if s.op == "min" else seg_max
        return _at(f(xm, gid, n + 1)[:n], sid), cnt > 0, c.ltype
    raise ValueError(f"unsupported window op {s.op}")


def _lead_lag(s: WinSpec, c: Column, x, xv, idx, sid, sel_s):
    n = idx.shape[0]
    off = s.offset if s.op == "lead" else -s.offset
    src = idx + off
    in_range = (src >= 0) & (src < n)
    ok = in_range & (_at(sid, src) == sid) & sel_s
    data = _at(x, src)
    validity = _at(xv, src) & ok
    if s.default is None:
        return data, validity, c.ltype
    if c.ltype is LType.STRING:
        if not isinstance(s.default, str):
            raise ValueError("lead/lag default on a string column must be a string")
        # the default becomes a code in an extended dictionary
        values = np.union1d(c.dictionary.values, np.asarray([s.default], dtype=str))
        remap = to_tensor(np.searchsorted(values, c.dictionary.values).astype(np.int32),
                          x.device)
        if len(remap):
            data = torch.where(data >= 0, _at(remap, data.clamp(min=0)), data)
        dcode = int(np.searchsorted(values, s.default))
        data = torch.where(ok, data, torch.tensor(dcode, dtype=data.dtype, device=x.device))
        return data, torch.where(ok, validity, True), c.ltype, Dictionary(values)
    if isinstance(s.default, str):
        raise ValueError("string default on a non-string column")
    if isinstance(s.default, float) and not float(s.default).is_integer() \
            and not x.dtype.is_floating_point:
        # a fractional default on an integer column widens the output to f64
        data = torch.where(ok, data.to(torch.float64), float(s.default))
        return data, torch.where(ok, validity, True), LType.FLOAT64, None
    data = torch.where(ok, data, torch.tensor(s.default, device=x.device).to(x.dtype))
    return data, torch.where(ok, validity, True), c.ltype


def _first_true(a, b, pred_at, n: int):
    """Vectorized monotone binary search: per row, the smallest j in
    [a, b+1) with pred_at(j) True (b+1 when none).  pred must be monotone
    (False..False True..True) over each row's range — the frame-bound
    invariant over (partition, order)-sorted values."""
    lo, hi = a, b + 1
    for _ in range(max(n, 2).bit_length() + 1):
        cont = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        p = pred_at(mid.clamp(0, max(n - 1, 0)))
        hi = torch.where(cont & p, mid, hi)
        lo = torch.where(cont & ~p, mid + 1, lo)
    return lo


def _sparse_table(xm: torch.Tensor, comb, n: int) -> torch.Tensor:
    """Doubling (sparse) table for O(1) range min/max queries: level k
    holds comb over [i, i + 2**k) (clamped at the end).  ``ceil(log2 n)`` + 1
    levels of n values."""
    levels = [xm]
    shift = 1
    while shift < n:
        prev = levels[-1]
        levels.append(torch.cat([comb(prev[:n - shift], prev[shift:]), prev[n - shift:]]))
        shift *= 2
    return torch.stack(levels)               # (K+1, n)


def _floor_log2(length: torch.Tensor) -> torch.Tensor:
    """floor(log2(length)) of positive int64 lengths, exactly (the float64
    exponent of an integer below 2**53 is exact)."""
    return torch.frexp(length.to(torch.float64))[1].to(torch.int64) - 1


def _range_query(table: torch.Tensor, comb, lo, hi, n: int):
    """comb over [lo, hi] via two overlapping power-of-two blocks."""
    length = (hi - lo + 1).clamp(min=1)
    k = _floor_log2(length).clamp(0, table.shape[0] - 1)
    flat = table.reshape(-1)
    left = _at(flat, k * n + lo.clamp(0, n - 1))
    width = torch.bitwise_left_shift(torch.ones_like(k), k)
    right = _at(flat, k * n + (hi - width + 1).clamp(0, n - 1))
    return comb(left, right)


def _one_framed(s: WinSpec, batch, fctx):
    """Aggregates / first_value / last_value over an explicit ROWS or RANGE
    frame.  Per-row frame bounds [lo, hi] come from clamped index arithmetic
    (ROWS) or a vectorized binary search over the single order key (RANGE n
    PRECEDING/FOLLOWING); aggregation is prefix-sum differences, with a
    segmented scan or a sparse table for min/max."""
    idx = fctx["idx"]
    n = idx.shape[0]
    dev = idx.device
    start_idx, end_idx = fctx["start"], fctx["end"]
    tstart, tend = fctx["tstart"], fctx["tend"]
    sid, sel_s, nseg = fctx["sid"], fctx["sel_s"], fctx["nseg"]
    perm = fctx["perm"]
    unit, lo_b, hi_b = s.frame

    def rows_bound(b, is_lo):
        if b == ("up",):
            return start_idx
        if b == ("uf",):
            return end_idx
        if b == ("c",):
            return idx
        off = int(b[1])
        return idx - off if b[0] == "p" else idx + off

    def range_bound(b, is_lo):
        if b == ("up",):
            return start_idx
        if b == ("uf",):
            return end_idx
        if b == ("c",):
            # RANGE CURRENT ROW means the current row's PEER group
            return tstart if is_lo else tend
        # n PRECEDING / n FOLLOWING over the single numeric order key
        ks = fctx["order_keys"]
        if len(ks) != 1:
            raise ValueError("RANGE n PRECEDING/FOLLOWING needs exactly one ORDER BY key")
        oc = batch.column(ks[0].name)
        if oc.ltype is LType.STRING:
            raise ValueError("RANGE frames need a numeric or temporal ORDER BY key")
        ov = oc.data[perm]
        ovalid = oc.valid_mask()[perm] & sel_s
        delta = b[1]
        dt = torch.float64 if (ov.dtype.is_floating_point or isinstance(delta, float)) \
            else torch.int64
        sv = ov.to(dt)
        sv = sv if ks[0].asc else -sv            # ascending in sort order
        # the order key's non-NULL run inside each partition (NULL rows are
        # peers of each other only; their frame is their peer group)
        gid = torch.where(sel_s, sid, n)
        first_valid = _at(seg_min(torch.where(ovalid, idx, n), gid, nseg)[:n], sid)
        last_valid = _at(seg_max(torch.where(ovalid, idx, -1), gid, nseg)[:n], sid)
        # target in ascending sv space: PRECEDING = -delta, FOLLOWING = +d;
        # lo wants the first index >= target, hi the last index <= target
        d = torch.tensor(delta, device=dev).to(dt)
        target = sv - d if b[0] == "p" else sv + d
        if is_lo:
            pos = _first_true(first_valid, last_valid, lambda j: _at(sv, j) >= target, n)
        else:
            pos = _first_true(first_valid, last_valid, lambda j: _at(sv, j) > target, n) - 1
        # NULL-ordered rows: peer-group frame
        return torch.where(ovalid, pos, tstart if is_lo else tend)

    bound = rows_bound if unit == "rows" else range_bound
    lo = torch.maximum(bound(lo_b, True), start_idx)
    hi = torch.minimum(bound(hi_b, False), end_idx)
    nonempty = (hi >= lo) & sel_s
    lo_c = lo.clamp(0, max(n - 1, 0))
    hi_c = hi.clamp(0, max(n - 1, 0))

    if s.op == "count" and s.input is None:
        return (torch.where(nonempty, hi - lo + 1, 0).to(torch.int64), None, LType.INT64)

    c = batch.column(s.input)
    x = c.data[perm]
    xv = c.valid_mask()[perm] & sel_s

    if s.op == "first_value":
        return _at(x, lo_c), _at(xv, lo_c) & nonempty, c.ltype
    if s.op == "last_value":
        return _at(x, hi_c), _at(xv, hi_c) & nonempty, c.ltype

    dt = torch.int64 if c.ltype.is_integer else torch.float64
    xa = torch.where(xv, x.to(dt), torch.zeros((), dtype=dt, device=dev))
    ones = xv.to(torch.int64)

    def span(prefix):
        prefix = torch.cumsum(prefix, 0)
        head = _at(prefix, hi_c)
        tail = torch.where(lo > 0, _at(prefix, lo - 1), torch.zeros((), dtype=prefix.dtype,
                                                                     device=dev))
        return torch.where(nonempty, head - tail, torch.zeros((), dtype=prefix.dtype,
                                                               device=dev))

    cnt = span(ones)
    if s.op == "count":
        return cnt, None, LType.INT64
    if s.op == "sum":
        return span(xa), cnt > 0, LType.INT64 if dt is torch.int64 else LType.FLOAT64
    if s.op == "avg":
        return span(xa).to(torch.float64) / cnt.clamp(min=1), cnt > 0, LType.FLOAT64
    if s.op in ("min", "max"):
        xm = torch.where(xv, x, torch.tensor(_identity(x, s.op), dtype=x.dtype, device=dev))
        comb = torch.minimum if s.op == "min" else torch.maximum
        # frames anchored at a partition edge (the default frame shape) use
        # an O(n log n) segmented scan + gather; the sparse table is only
        # built when BOTH bounds slide
        if lo_b == ("up",):
            vals = _at(_seg_running(xm, sid, comb), hi_c)
        elif hi_b == ("uf",):
            vals = _at(torch.flip(_seg_running(torch.flip(xm, (0,)), torch.flip(sid, (0,)),
                                               comb), (0,)), lo_c)
        else:
            vals = _range_query(_sparse_table(xm, comb, n), comb, lo_c, hi_c, n)
        return vals, (cnt > 0) & nonempty, c.ltype
    raise ValueError(f"unsupported framed window op {s.op}")


def _seg_running(xm: torch.Tensor, sid: torch.Tensor, comb) -> torch.Tensor:
    """Running min/max from each segment's start, by a log-step scan: after
    the pass with shift ``2**k`` every row holds comb over the (up to)
    ``2**(k+1)`` rows ending at it that share its segment.  Segments are
    contiguous runs of ``sid``, so equal ids at distance ``shift`` mean every
    row between lies in the same segment."""
    n = xm.shape[0]
    vals = xm
    shift = 1
    while shift < n:
        same = sid[shift:] == sid[:-shift]
        combined = torch.where(same, comb(vals[:-shift], vals[shift:]), vals[shift:])
        vals = torch.cat([vals[:shift], combined])
        shift *= 2
    return vals
