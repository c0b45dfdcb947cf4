"""Aggregation: scalar and dense-domain GROUP BY, in torch.

The port of ``baikaldb_tpu/ops/hashagg.py``.  When every group key has a
known dense domain (dictionary codes, small-range integers found by the
planner), the combined group id is a mixed-radix fold and each aggregate is
one segment reduction (ops/segments.py).  Mid-cardinality group-bys
(512 < groups <= 4096, the JAX package's gate) of COUNT/SUM/AVG/MIN/MAX over
float columns go through the hand-written kernels of ops/group_kernels.py
instead; on a CPU batch those run their plain versions, so the same
assembly code (float32 output contract, ``nonempty`` validity, casts) runs on
either device.

Keys without a dense domain take the sort-based group-by.  COUNT/SUM/AVG
(DISTINCT ...) sort and count boundaries, scalar and per group.  Not ported
yet: the HLL and percentile aggregates and the partial-aggregate merge
protocol.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..column.batch import Column, ColumnBatch, dtype_max, dtype_min
from ..errors import NotPortedError
from ..types import LType
from ..utils.flags import FLAGS
from .group_kernels import (MAX_GROUPS, filtered_group_sum,
                            fused_group_aggregate, partition_histogram)
from .segments import max_segments, seg_max, seg_min, seg_sum


def agg_result_type(op: str, input_type: LType) -> LType:
    if op in ("count", "count_star", "approx_count_distinct"):
        return LType.INT64
    if op == "sum":
        return LType.INT64 if input_type.is_integer else LType.FLOAT64
    if op in ("avg", "sumsq", "stddev", "stddev_samp", "variance", "var_samp",
              "percentile"):
        return LType.FLOAT64
    if op in ("min", "max"):
        return input_type
    raise ValueError(f"unknown aggregate {op}")


# aggregates whose state cannot merge as a single partial lane
ROW_AGGS = {"approx_count_distinct", "percentile"}

_STDDEV = ("stddev", "stddev_samp", "variance", "var_samp")


@dataclass(frozen=True)
class AggSpec:
    op: str                 # count | count_star | sum | avg | min | max |
    #                         stddev/variance family | approx_count_distinct |
    #                         percentile
    input: Optional[str]    # column name; None for count_star
    out_name: str
    distinct: bool = False
    param: Optional[float] = None   # percentile fraction


def _sum_dtype(c: Column):
    return torch.int64 if c.ltype.is_integer else torch.float64


def _minmax_identity(c: Column, is_min: bool):
    return dtype_max(c.data.dtype) if is_min else dtype_min(c.data.dtype)


def _not_ported(s: AggSpec):
    return NotPortedError(f"aggregate {s.op!r}")


# ----------------------------------------------------------------------
# scalar aggregation (no GROUP BY)


def scalar_aggregate(batch: ColumnBatch, specs: list[AggSpec]) -> ColumnBatch:
    sel = batch.sel_mask()
    names, cols = [], []
    for s in specs:
        names.append(s.out_name)
        cols.append(_scalar_one(batch, s, sel))
    return ColumnBatch(tuple(names), cols, device=batch.device)


def _one(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(1)


def _scalar_one(batch: ColumnBatch, s: AggSpec, sel) -> Column:
    if s.op == "count_star":
        return Column(_one(sel.sum().to(torch.int64)), None, LType.INT64)
    c = batch.column(s.input)
    live = sel & c.valid_mask()
    if s.distinct and s.op in ("count", "sum", "avg"):
        return _scalar_distinct(c, live, s)
    if s.op in ROW_AGGS:
        raise _not_ported(s)
    any_ = _one(live.any())
    if s.op == "count":
        return Column(_one(live.sum().to(torch.int64)), None, LType.INT64)
    if s.op == "sum":
        dt = _sum_dtype(c)
        v = torch.where(live, c.data.to(dt), torch.zeros((), dtype=dt, device=live.device))
        return Column(_one(v.sum()), any_, agg_result_type("sum", c.ltype))
    if s.op == "avg":
        x = torch.where(live, c.data.to(torch.float64), 0.0)
        ct = live.sum()
        return Column(_one(x.sum() / ct.clamp(min=1)), _one(ct > 0), LType.FLOAT64)
    if s.op in ("min", "max"):
        ident = _minmax_identity(c, s.op == "min")
        v = torch.where(live, c.data, torch.tensor(ident, dtype=c.data.dtype,
                                                   device=live.device))
        if v.numel() == 0:
            r = torch.full((1,), ident, dtype=c.data.dtype, device=live.device)
        else:
            r = _one(v.min() if s.op == "min" else v.max())
        return Column(r, any_, c.ltype, c.dictionary)
    if s.op == "sumsq":
        x = c.data.to(torch.float64)
        return Column(_one(torch.where(live, x * x, 0.0).sum()), any_, LType.FLOAT64)
    if s.op in _STDDEV:
        xd = c.data.to(torch.float64)
        x = torch.where(live, xd, 0.0)
        n = live.sum().to(torch.float64)
        n1 = n.clamp(min=1.0)
        mean = x.sum() / n1
        var = torch.where(live, (xd - mean) ** 2, 0.0).sum()
        denom = n1 if s.op in ("stddev", "variance") else (n - 1.0).clamp(min=1.0)
        v = var / denom
        if s.op.startswith("stddev"):
            v = torch.sqrt(v)
        return Column(_one(v), _one(n > 0), LType.FLOAT64)
    raise ValueError(f"unknown aggregate {s.op}")


def _scalar_distinct(c: Column, live, s: AggSpec) -> Column:
    """COUNT/SUM/AVG(DISTINCT x): sort + boundary count.  Dead/NULL lanes get
    the +max sentinel so they sort past the live prefix."""
    d = torch.where(live, c.data, torch.full_like(c.data, _minmax_identity(c, True)))
    srt = torch.sort(d).values
    idx = torch.arange(d.shape[0], device=d.device)
    new = (idx == 0) | (srt != torch.roll(srt, 1))
    uniq = new & (idx < live.sum())
    if s.op == "count":
        return Column(_one(uniq.sum().to(torch.int64)), None, LType.INT64)
    dt = _sum_dtype(c)
    sm = torch.where(uniq, srt.to(dt), torch.zeros((), dtype=dt, device=d.device)).sum()
    any_ = _one(uniq.any())
    if s.op == "sum":
        return Column(_one(sm), any_, agg_result_type("sum", c.ltype))
    ct = uniq.sum().clamp(min=1)
    return Column(_one(sm.to(torch.float64) / ct), any_, LType.FLOAT64)


# ----------------------------------------------------------------------
# dense-domain group-by


def combined_dense_id(key_cols: list[Column], domains: list[int]) -> torch.Tensor:
    """Mixed-radix fold of dense key codes -> single int32 group id.

    NULL keys get their own slot: each radix is domain+1 with NULL -> domain."""
    cid = None
    for c, dom in zip(key_cols, domains):
        code = c.data.to(torch.int32)
        if c.validity is not None:
            code = torch.where(c.validity, code, dom)
        code = code.clamp(0, dom)
        cid = code if cid is None else cid * (dom + 1) + code
    return cid


def dense_num_groups(domains: list[int]) -> int:
    n = 1
    for d in domains:
        n *= d + 1
    return n


def group_aggregate_dense(batch: ColumnBatch, key_names: list[str],
                          domains: list[int], specs: list[AggSpec]) -> ColumnBatch:
    """GROUP BY over dense-coded keys: one segment reduction per aggregate
    (or one kernel per value column, see ``dense_kernel_cols``).

    Output capacity = prod(domain+1); absent groups are masked via sel."""
    dev = batch.device
    key_cols = [batch.column(k) for k in key_names]
    ng = dense_num_groups(domains)
    gid = combined_dense_id(key_cols, domains)
    sel = batch.sel_mask()
    gid_live = torch.where(sel, gid, ng)  # dead rows -> dropped slot
    present = seg_sum(torch.ones_like(gid_live), gid_live, ng) > 0
    # reconstruct key columns from the slot index
    out_names, out_cols = [], []
    slot = torch.arange(ng, dtype=torch.int32, device=dev)
    stride = ng
    for name, c, dom in zip(key_names, key_cols, domains):
        stride //= dom + 1
        code = torch.remainder(torch.div(slot, stride, rounding_mode="floor"), dom + 1)
        validity = code < dom if c.validity is not None else None
        code = torch.where(code >= dom, 0, code)
        out_names.append(name)
        out_cols.append(Column(code.to(c.data.dtype), validity, c.ltype, c.dictionary))
    kernel_cols = dense_kernel_cols(batch, specs, gid, ng, sel)
    if kernel_cols is not None:
        out_names.extend(s.out_name for s in specs)
        out_cols.extend(kernel_cols)
    else:
        for s in specs:
            out_names.append(s.out_name)
            out_cols.append(_segment_one(batch, s, gid_live, ng, sel))
    return ColumnBatch(tuple(out_names), out_cols, present, None, device=dev)


def dense_kernel_cols(batch, specs, gid, ng: int, sel):
    """Mid-cardinality dense group-by through the hand-written kernels
    (ops/group_kernels.py), under the JAX package's gate (its
    ``_pallas_dense_cols``):

    - only COUNT/COUNT(*)/SUM/AVG/MIN/MAX, no DISTINCT;
    - value columns must be floats (counts are exact; float sums carry the
      float32 output contract's rounding); MIN/MAX need FLOAT32 columns;
    - group count in (onehot_max_segments, MAX_GROUPS];
    - FLAGS.pallas_group_kernels.

    The gate does not look at the device: on CUDA the kernels launch, on the
    CPU their plain versions run.  Returns the aggregate Columns (spec
    order), or None to use segment reductions."""
    if not (bool(FLAGS.pallas_group_kernels)
            and max_segments() < ng + 1 <= MAX_GROUPS):
        return None
    for s in specs:
        if s.distinct or s.op not in ("count_star", "count", "sum", "avg",
                                      "min", "max"):
            return None
        if s.op != "count_star":
            lt = batch.column(s.input).ltype
            if lt not in (LType.FLOAT32, LType.FLOAT64):
                return None
            if s.op in ("min", "max") and lt is not LType.FLOAT32:
                return None
    gid = gid.contiguous()
    sel = sel.contiguous()
    fused: dict = {}          # input name -> (cnt, sm, mn, mx)
    star_counts = None
    cols = []
    for s in specs:
        if s.op == "count_star":
            if star_counts is None:
                star_counts = partition_histogram(gid, sel, ng)
            cols.append(Column(star_counts.to(torch.int64), None, LType.INT64))
            continue
        c = batch.column(s.input)
        if s.input not in fused:
            live = (c.valid_mask() & sel).contiguous()
            values = c.data.contiguous()
            # min/max cost extra atomics per row: only the full kernel when
            # some spec on this column asks for them
            if any(x.op in ("min", "max") and x.input == s.input for x in specs):
                fused[s.input] = fused_group_aggregate(gid, values, live, ng)
            else:
                fused[s.input] = (*filtered_group_sum(gid, values, live, ng), None, None)
        cnt, sm, mn, mx = fused[s.input]
        nonempty = cnt > 0
        if s.op == "count":
            cols.append(Column(cnt.to(torch.int64), None, LType.INT64))
        elif s.op == "sum":
            cols.append(Column(sm.to(torch.float64), nonempty,
                               agg_result_type("sum", c.ltype)))
        elif s.op == "avg":
            cols.append(Column(sm.to(torch.float64) / cnt.clamp(min=1).to(torch.float64),
                               nonempty, LType.FLOAT64))
        elif s.op == "min":
            cols.append(Column(mn.to(c.data.dtype), nonempty, c.ltype))
        else:
            cols.append(Column(mx.to(c.data.dtype), nonempty, c.ltype))
    return cols


def _segment_one(batch: ColumnBatch, s: AggSpec, gid, ng: int, sel) -> Column:
    """One aggregate via segment reduction; gid==ng is the dead-row slot."""
    if s.op == "count_star":
        return Column(seg_sum(torch.ones_like(gid, dtype=torch.int64), gid, ng),
                      None, LType.INT64)
    c = batch.column(s.input)
    live = c.valid_mask() & sel
    gid_v = torch.where(live, gid, ng)
    if s.distinct:
        return _segment_distinct(c, gid_v, ng, s)
    if s.op in ROW_AGGS:
        raise _not_ported(s)

    def live_count(dtype=torch.int32):
        return seg_sum(live.to(dtype), gid_v, ng)

    if s.op == "count":
        return Column(live_count(torch.int64), None, LType.INT64)
    if s.op == "sum":
        v = seg_sum(c.data.to(_sum_dtype(c)), gid_v, ng)
        return Column(v, live_count() > 0, agg_result_type("sum", c.ltype))
    if s.op == "avg":
        sm = seg_sum(c.data.to(torch.float64), gid_v, ng)
        ct = live_count()
        return Column(sm / ct.clamp(min=1), ct > 0, LType.FLOAT64)
    if s.op in ("min", "max"):
        ident = torch.tensor(_minmax_identity(c, s.op == "min"), dtype=c.data.dtype,
                             device=gid.device)
        f = seg_min if s.op == "min" else seg_max
        v = f(torch.where(live, c.data, ident), gid_v, ng)
        return Column(v, live_count() > 0, c.ltype, c.dictionary)
    x = torch.where(live, c.data.to(torch.float64), 0.0)
    if s.op == "sumsq":
        return Column(seg_sum(x * x, gid_v, ng), live_count() > 0, LType.FLOAT64)
    if s.op in _STDDEV:
        sm = seg_sum(x, gid_v, ng)
        s2 = seg_sum(x * x, gid_v, ng)
        n = live_count(torch.float64)
        n1 = n.clamp(min=1.0)
        var = s2 / n1 - (sm / n1) ** 2
        denom = n1 if s.op in ("stddev", "variance") else (n - 1.0).clamp(min=1.0)
        var = (var * (n1 / denom)).clamp(min=0.0)
        v = torch.sqrt(var) if s.op.startswith("stddev") else var
        return Column(v, n > 0, LType.FLOAT64)
    raise ValueError(f"unknown aggregate {s.op}")


def _segment_distinct(c: Column, gid, ng: int, s: AggSpec) -> Column:
    """Per-group DISTINCT via a (gid, value) sort + boundary dedup; gid==ng
    marks dead and NULL lanes.  As in the JAX package, every op but COUNT
    and SUM gives the average of the distinct values."""
    order = torch.sort(c.data, stable=True).indices
    order = order[torch.sort(gid[order], stable=True).indices]
    g = gid[order]
    v = c.data[order]
    idx = torch.arange(g.shape[0], device=g.device)
    new = (idx == 0) | (g != torch.roll(g, 1)) | (v != torch.roll(v, 1))
    live = g < ng
    w = new & live
    gl = torch.where(live, g, ng)
    if s.op == "count":
        return Column(seg_sum(w.to(torch.int64), gl, ng), None, LType.INT64)
    dt = _sum_dtype(c)
    sm = seg_sum(torch.where(w, v.to(dt), torch.zeros((), dtype=dt, device=g.device)), gl, ng)
    ct = seg_sum(w.to(torch.int32), gl, ng)
    if s.op == "sum":
        return Column(sm, ct > 0, agg_result_type("sum", c.ltype))
    return Column(sm.to(torch.float64) / ct.clamp(min=1), ct > 0, LType.FLOAT64)


def group_aggregate_sorted(batch: ColumnBatch, key_names: list[str],
                           specs: list[AggSpec], max_groups: int) -> ColumnBatch:
    """General GROUP BY: lexicographic stable sort, boundary cumsum group
    ids, segment reductions into a ``max_groups``-slot table.

    ``max_groups`` must upper-bound the true group count (the planner
    supplies it from statistics or len(batch)); groups fill slots densely
    and the output carries num_rows = group count."""
    n = len(batch)
    dev = batch.device
    key_cols = [batch.column(k) for k in key_names]
    sel = batch.sel_mask()
    # canonicalize NULL lanes to 0 so all NULL keys form ONE group
    key_data = []
    for c in key_cols:
        d = c.data.to(torch.int32) if c.data.dtype is torch.bool else c.data
        if c.validity is not None:
            d = torch.where(c.validity, d, torch.zeros((), dtype=d.dtype, device=dev))
        key_data.append(d)

    def stable(x):
        return torch.argsort(x.to(torch.int8) if x.dtype is torch.bool else x, stable=True)

    perm = torch.arange(n, device=dev)
    for c, d in zip(reversed(key_cols), reversed(key_data)):
        perm = perm[stable(d[perm])]
        if c.validity is not None:
            perm = perm[stable(c.validity[perm])]     # NULLs first
    perm = perm[stable(~sel[perm])]                   # dead rows last

    sel_s = sel[perm]
    boundary = torch.arange(n, device=dev) == 0
    for c, dd in zip(key_cols, key_data):
        d = dd[perm]
        boundary = boundary | (d != torch.roll(d, 1))
        if c.validity is not None:
            v = c.validity[perm]
            boundary = boundary | (v != torch.roll(v, 1))
    flags = boundary & sel_s
    gid = torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32) - 1
    gid = torch.where(sel_s & (gid >= 0) & (gid < max_groups), gid, max_groups)
    ngroups = torch.clamp(flags.sum(), max=max_groups).to(torch.int32)

    # scatter first-occurrence key values into group slots
    out_names, out_cols = [], []
    scatter_to = torch.where(flags, gid.clamp(0, max_groups - 1), max_groups).to(torch.int64)
    for name, c in zip(key_names, key_cols):
        buf = torch.zeros(max_groups + 1, dtype=c.data.dtype, device=dev)
        buf[scatter_to] = c.data[perm]
        validity = None
        if c.validity is not None:
            validity = torch.zeros(max_groups + 1, dtype=torch.bool, device=dev)
            validity[scatter_to] = c.validity[perm]
            validity = validity[:max_groups]
        out_names.append(name)
        out_cols.append(Column(buf[:max_groups], validity, c.ltype, c.dictionary))

    sorted_batch = batch.gather(perm)
    sorted_batch.sel = sel_s
    for s in specs:
        out_names.append(s.out_name)
        out_cols.append(_segment_one(sorted_batch, s, gid, max_groups, sel_s))
    present = torch.arange(max_groups, device=dev) < ngroups
    return ColumnBatch(tuple(out_names), out_cols, present, ngroups, device=dev)
