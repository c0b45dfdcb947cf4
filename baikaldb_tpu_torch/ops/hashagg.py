"""Aggregation: scalar and dense-domain GROUP BY, in torch.

The port of ``baikaldb_tpu/ops/hashagg.py``.  When every group key has a
known dense domain (dictionary codes, small-range integers found by the
planner), the combined group id is a mixed-radix fold and each aggregate is
one segment reduction (ops/segments.py: on the card the segment kernel up
to ``onehot_max_segments`` segments).  Mid-cardinality group-bys
(``max_segments`` < groups <= 4096: above 2048 on the card, as measured on
the H100, and above the JAX package's 512 on the CPU) of
COUNT/SUM/AVG/MIN/MAX over float columns go through the hand-written kernels
of ops/group_kernels.py instead; on a CPU batch those run their plain
versions, so the same assembly code (float32 sums, int64 counts, ``nonempty``
validity, casts) runs on either device.  The ``present`` mask of a dense
group-by comes, on the card, from the segment kernel under the gate and
from K3 above it (``_present_histogram``).  On the card, a wider group-by
that K1-K3 decline takes every COUNT/SUM/AVG/MIN/MAX in one launch of the
wide kernel (``dense_group_agg``, ops/dense_agg.py), ``present`` included;
``dense_route`` names the route from the input alone.

Keys without a dense domain take the sort-based group-by.  COUNT/SUM/AVG
(DISTINCT ...) sort and count boundaries, scalar and per group.
APPROX_COUNT_DISTINCT is one segment max over ``groups x 512`` HLL register
slots; PERCENTILE (and MEDIAN, planned as percentile 0.5) sorts by (group,
value) and interpolates.  Neither reaches the group-by kernels (the gate of
``dense_kernel_cols`` admits COUNT/SUM/AVG/MIN/MAX only).

The partial-aggregate protocol (``MERGE_OP``, ``partial_specs``,
``finalize_partials``) rewrites aggregates into mergeable partials (AVG ->
SUM + COUNT, STDDEV -> SUM + SUMSQ + COUNT) and finishes them after a merge;
the streamed fold (exec/streaming.py) aggregates each chunk into partials,
merges them into its accumulator and finalizes once.

``group_aggregate_dense_lanes`` is the dense group-by over the ``[G, n]``
selection of a batched-dispatch tick (exec/lanes.py): the same routes, each
kernel launched once over all lanes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..column.batch import Column, ColumnBatch, dtype_max, dtype_min
from ..obs import trace
from ..types import LType
from ..utils.flags import FLAGS
from ..utils.hashing import GOLDEN, hash_columns, mix32
from . import dense_agg
from .compact import stable_partition
from .group_kernels import (MAX_GROUPS, filtered_group_sum, filtered_group_sum_lanes,
                            fused_group_aggregate, fused_group_aggregate_lanes,
                            partition_histogram, partition_histogram_lanes)
from .segments import (MAX_SEGMENTS, max_segments, seg_max, seg_max_lanes, seg_min,
                       seg_min_lanes, seg_sum, seg_sum_lanes)


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


# the aggregates of the group-by kernels (K1-K3, the lanes, the wide route)
LANE_AGGS = frozenset({"count_star", "count", "sum", "avg", "min", "max"})

# aggregates whose state cannot merge as a single partial lane
ROW_AGGS = {"approx_count_distinct", "percentile"}

# the reference sizes its HLL sketches at 16384 registers
# (src/common/hll_common.cpp); 512 keeps the dense [groups, m] register
# table small, at a standard error of 1.04/sqrt(512) = 4.6%
HLL_REGISTERS = 512

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
    if s.op == "approx_count_distinct":
        regs = _hll_registers(c, live, torch.zeros_like(c.data, dtype=torch.int64), 1)
        return Column(_hll_estimate(regs)[:1], None, LType.INT64)
    if s.op == "percentile":
        gid = torch.where(live, 0, 1)
        v, ok = _segment_percentile(c, gid, 1, s.param)
        return Column(v, ok, LType.FLOAT64)
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


# -- sketch aggregates --------------------------------------------------


def _hll_registers(c: Column, live, gid, ng: int) -> torch.Tensor:
    """Per-group HyperLogLog registers ``[ng, m]`` by ONE segment max over
    ``ng * m`` slots (the reference's sketches as a segment reduction).

    A row's register is its hash mod m; its rank is one plus the leading
    zeros of a second hash stream, ``32 - ceil(log2(h2 + 1))`` in the JAX
    package: that ceiling is the bit length of h2, taken here exactly from
    the float64 exponent (h2 < 2**32 is exact in a float64)."""
    m = HLL_REGISTERS
    h1 = hash_columns([c.data])
    h2 = mix32(h1 ^ GOLDEN)                   # an independent second stream
    reg = torch.remainder(h1, m)
    bit_length = torch.frexp(h2.to(torch.float64))[1].to(torch.int64)
    rho = (32 - bit_length + 1).clamp(1, 33)
    gid = gid.to(torch.int64)
    slot = torch.where(live, gid * m + reg, ng * m)
    regs = seg_max(torch.where(live, rho, 0), slot, ng * m)
    return regs.clamp(min=0).reshape(ng, m)


def _hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """[ng, m] registers -> cardinality estimates with the small-range
    correction.  The sum of 2**-reg over the registers is exact in float64
    in any order (at most 512 dyadic terms no finer than 2**-33), so the
    card, the CPU and the JAX package agree exactly."""
    m = float(HLL_REGISTERS)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    z = torch.pow(2.0, -regs.to(torch.float64)).sum(dim=1)
    e = alpha * m * m / z
    zeros = (regs == 0).sum(dim=1).to(torch.float64)
    small = m * torch.log(m / zeros.clamp(min=1.0))
    est = torch.where((e <= 2.5 * m) & (zeros > 0), small, e)
    return torch.round(est).to(torch.int64)


def _segment_percentile(c: Column, gid_v, ng: int, p: float):
    """Exact percentile per group: sort by (group, value), index into each
    group's run with linear interpolation (PERCENTILE_CONT semantics).
    ``gid_v == ng`` marks dead and NULL lanes, which sort past every group."""
    x = c.data.to(torch.float64)
    order = torch.argsort(x, stable=True)
    order = order[torch.argsort(gid_v[order], stable=True)]
    v = x[order]
    counts = seg_sum(torch.ones_like(gid_v, dtype=torch.int64), gid_v, ng)
    starts = torch.cumsum(counts, 0) - counts
    tpos = starts.to(torch.float64) + p * (counts - 1).clamp(min=0).to(torch.float64)
    lo = torch.floor(tpos)
    hi = torch.ceil(tpos)
    n = v.shape[0]
    if n == 0:
        return torch.zeros(ng, dtype=torch.float64, device=x.device), counts > 0
    vlo = v[lo.to(torch.int64).clamp(0, n - 1)]
    vhi = v[hi.to(torch.int64).clamp(0, n - 1)]
    return vlo + (vhi - vlo) * (tpos - lo), counts > 0


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
    """GROUP BY over dense-coded keys by the route of ``dense_route``: one
    segment reduction per aggregate, one kernel per value column (see
    ``dense_kernel_cols``), or one kernel for every aggregate
    (``dense_group_agg``).

    Output capacity = prod(domain+1); absent groups are masked via sel."""
    dev = batch.device
    key_cols = [batch.column(k) for k in key_names]
    ng = dense_num_groups(domains)
    gid = combined_dense_id(key_cols, domains)
    out_names, out_cols = _dense_key_columns(key_names, key_cols, domains, ng, dev)
    out_names.extend(s.out_name for s in specs)
    route = dense_route(batch, specs, ng)
    trace.annotate(route=route)
    if route == "wide":
        present, cols = dense_group_agg(gid, batch.sel, _inputs(batch, specs), specs, ng)
    else:
        sel = batch.sel_mask()
        hist = _present_histogram(gid, sel, ng)
        k123 = route == "k123"
        # under K1-K3 the plain composition gives ``present`` alone
        present, cols = dense_group_agg_plain(gid, sel, _inputs(batch, specs),
                                              [] if k123 else specs, ng, hist)
        if k123:
            cols = dense_kernel_cols(batch, specs, gid, ng, sel, hist)
    return ColumnBatch(tuple(out_names), out_cols + cols, present, None, device=dev)


def _input(batch: ColumnBatch, s: AggSpec) -> Optional[Column]:
    return None if s.op == "count_star" else batch.column(s.input)


def _inputs(batch: ColumnBatch, specs: list[AggSpec]) -> dict:
    """The columns ``specs`` read, by name."""
    return {s.input: batch.column(s.input) for s in specs if s.op != "count_star"}


# the inputs of the wide route: the logical types whose data is one of the
# kernel's four dtypes
_WIDE_TYPES = {LType.INT32: torch.int32, LType.INT64: torch.int64, LType.DATE: torch.int32,
               LType.STRING: torch.int32, LType.FLOAT32: torch.float32,
               LType.FLOAT64: torch.float64}


def dense_route(batch: ColumnBatch, specs: list[AggSpec], ng: int, device=None) -> str:
    """How a dense GROUP BY of ``ng`` slots runs on ``device`` (by default
    the batch's), from the input alone:

    - ``k123``: K1-K3 (``dense_kernel_cols``' gate; their plain versions on
      the CPU);
    - ``segment``: on CUDA, at most ``max_segments`` slots: the segment
      kernel;
    - ``wide``: on CUDA above that, every aggregate COUNT(*)/COUNT/SUM/AVG/
      MIN/MAX without DISTINCT over an INT32, INT64, DATE, dictionary-code,
      FLOAT32 or FLOAT64 column: ``dense_group_agg``, one kernel;
    - ``scatter``: the rest, one library scatter per aggregate."""
    dev = torch.device(device if device is not None else batch.device)
    if _k123_gate(batch, specs, ng, dev):
        return "k123"
    if dev.type != "cuda":
        return "scatter"
    if ng <= min(max_segments(dev), MAX_SEGMENTS):
        return "segment"
    n = len(batch)
    for s in specs:
        if s.distinct or s.op not in LANE_AGGS:
            return "scatter"
        if s.op == "count_star":
            continue
        c = batch.column(s.input)
        if _WIDE_TYPES.get(c.ltype) is not c.data.dtype or c.data.shape != (n,):
            return "scatter"
    if len(dense_agg.wide_plan(specs, _inputs(batch, specs))) > dense_agg.MAX_ACCS:
        return "scatter"
    return "wide"


def dense_group_agg(gid, sel, cols: dict, specs: list[AggSpec], ng: int):
    """Every aggregate of a dense GROUP BY in one pass: ``gid`` int32 [N]
    slot ids, ``sel`` bool [N] or None (every row live), ``cols`` the input
    columns by name -> (``present`` bool [ng], one Column per spec), as
    ``dense_group_agg_plain``.  On a CUDA tensor one launch of
    ``csrc/dense_agg.cu`` (``ops/dense_agg.py``), which raises on failure;
    on a CPU tensor the plain version."""
    if gid.device.type == "cpu":
        return dense_group_agg_plain(gid, sel, cols, specs, ng)
    accs = dense_agg.wide_plan(specs, cols)
    return wide_columns(specs, cols, accs, *dense_agg.launch(gid, sel, cols, accs, ng))


def wide_columns(specs: list[AggSpec], cols: dict, accs: list, cnt, outs):
    """The wide kernel's live counts ``cnt`` and accumulators ``outs`` (one
    per ``accs``, ``dense_agg.wide_plan``'s) -> (``present``, one Column per
    spec) in ``_segment_one``'s dtypes and validity."""
    out = dict(zip(accs, outs))
    present = cnt > 0

    def pick(kind, s):
        return out[dense_agg.Acc(kind, s.input)]

    def count(s, c):
        return cnt if c.validity is None else pick(dense_agg.COUNT, s)

    def nonempty(s, c):
        if c.validity is None:
            return present
        a = dense_agg.Acc(dense_agg.COUNT, s.input)
        return out[a] > 0 if a in out else pick(dense_agg.FLAG, s).view(torch.bool)

    result = []
    for s in specs:
        if s.op == "count_star":
            result.append(Column(cnt.to(torch.int64), None, LType.INT64))
            continue
        c = cols[s.input]
        if s.op == "count":
            result.append(Column(count(s, c).to(torch.int64), None, LType.INT64))
        elif s.op == "avg":
            ct = count(s, c)
            sm = pick(dense_agg.SUM_F64, s)
            result.append(Column(sm / ct.clamp(min=1), ct > 0, LType.FLOAT64))
        elif s.op == "sum":
            kind = dense_agg.SUM_I64 if c.ltype.is_integer else dense_agg.SUM_F64
            result.append(Column(pick(kind, s), nonempty(s, c), agg_result_type("sum", c.ltype)))
        else:
            v = pick(dense_agg.MIN if s.op == "min" else dense_agg.MAX, s)
            result.append(Column(v, nonempty(s, c), c.ltype, c.dictionary))
    return present, result


def dense_group_agg_plain(gid, sel, cols: dict, specs: list[AggSpec], ng: int, hist=None):
    """``dense_group_agg`` as the scatter and segment routes compute it:
    every dead row to the drop slot ``ng``, then one segment reduction per
    aggregate (``_segment_one``) and, unless ``hist`` gives the live rows
    per slot (``_present_histogram``), one for ``present``."""
    sel = torch.ones_like(gid, dtype=torch.bool) if sel is None else sel
    gid_live = torch.where(sel, gid, ng)  # dead rows -> dropped slot
    if hist is None:
        hist = seg_sum(torch.ones_like(gid_live), gid_live, ng)
    present = hist > 0
    return present, [_segment_one(cols.get(s.input), s, gid_live, ng, sel) for s in specs]


def _dense_key_columns(key_names, key_cols, domains, ng: int, dev):
    """The key columns of a dense group-by's ``ng`` slots, rebuilt from the
    slot index (NULL is each key's last code)."""
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
    return out_names, out_cols


def _present_histogram(gid, sel, ng: int, lanes: bool = False):
    """The live rows per slot from K3 over ``(gid, sel)``, where that is the
    card's route to ``present``: on CUDA, above the segment kernel's gate
    and within the group-by kernels' range (the same counts as the
    reference's segment count over ``gid_live``, without a scatter of every
    dead row into one drop slot).  None elsewhere: at or under the gate
    ``seg_sum`` takes the segment kernel, above ``MAX_GROUPS`` (or with
    ``pallas_group_kernels`` off) the scatter, and the CPU keeps the
    reference's segment count.  ``lanes``: ``sel`` is [G, n], one launch
    over its rows."""
    if not (gid.device.type == "cuda" and bool(FLAGS.pallas_group_kernels)
            and max_segments(gid.device) < ng <= MAX_GROUPS):
        return None
    k3 = partition_histogram_lanes if lanes else partition_histogram
    return k3(gid.contiguous(), sel.contiguous(), ng)


def dense_kernel_cols(batch, specs, gid, ng: int, sel, hist=None, lanes: bool = False):
    """Mid-cardinality dense group-by through the hand-written kernels
    (ops/group_kernels.py), under the gate of the JAX package's
    ``_pallas_dense_cols`` with the port's crossover (``max_segments``):

    - only COUNT/COUNT(*)/SUM/AVG/MIN/MAX, no DISTINCT;
    - value columns must be floats (counts are exact int64; float sums carry
      the float32 output contract's rounding); MIN/MAX need FLOAT32 columns;
    - group count in (onehot_max_segments, MAX_GROUPS];
    - FLAGS.pallas_group_kernels.

    On CUDA the kernels launch, on the CPU their plain versions run (the
    crossover is the device's).  ``hist``, K3's counts over ``(gid, sel)``
    if the caller has them, serves COUNT(*).  ``lanes``: ``sel`` is
    [G, n] and each kernel is its lane-batched entry, one launch over all
    lanes; the columns are then [G, ng].  Returns the aggregate Columns
    (spec order), or None to use segment reductions."""
    if not _k123_gate(batch, specs, ng, gid.device):
        return None
    k1, k2, k3 = ((filtered_group_sum_lanes, fused_group_aggregate_lanes,
                   partition_histogram_lanes) if lanes else
                  (filtered_group_sum, fused_group_aggregate, partition_histogram))
    gid = gid.contiguous()
    sel = sel.contiguous()
    fused: dict = {}          # input name -> (cnt, sm, mn, mx)
    star_counts = hist
    cols = []
    for s in specs:
        if s.op == "count_star":
            if star_counts is None:
                star_counts = k3(gid, sel, ng)
            cols.append(Column(star_counts, None, LType.INT64))
            continue
        c = batch.column(s.input)
        if s.input not in fused:
            live = _live(c, sel)
            values = c.data.contiguous()
            # min/max cost extra atomics per row: only the full kernel when
            # some spec on this column asks for them
            if any(x.op in ("min", "max") and x.input == s.input for x in specs):
                fused[s.input] = k2(gid, values, live, ng)
            else:
                fused[s.input] = (*k1(gid, values, live, ng), None, None)
        cnt, sm, mn, mx = fused[s.input]
        nonempty = cnt > 0
        if s.op == "count":
            cols.append(Column(cnt, None, LType.INT64))
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


def _k123_gate(batch, specs, ng: int, dev) -> bool:
    """Whether K1-K3 take the dense group-by (``dense_kernel_cols``)."""
    if not (bool(FLAGS.pallas_group_kernels) and max_segments(dev) < ng + 1 <= MAX_GROUPS):
        return False
    for s in specs:
        if s.distinct or s.op not in LANE_AGGS:
            return False
        if s.op != "count_star":
            lt = batch.column(s.input).ltype
            if lt not in (LType.FLOAT32, LType.FLOAT64):
                return False
            if s.op in ("min", "max") and lt is not LType.FLOAT32:
                return False
    return True


def _live(c: Column, sel):
    """The rows of ``c`` an aggregate reads: live and not NULL."""
    return sel if c.validity is None else (c.validity & sel).contiguous()


def _segment_one(c: Optional[Column], s: AggSpec, gid, ng: int, sel) -> Column:
    """One aggregate of the column ``c`` (None for COUNT(*)) via segment
    reduction; gid==ng is the dead-row slot."""
    if s.op == "count_star":
        return Column(seg_sum(torch.ones_like(gid, dtype=torch.int64), gid, ng),
                      None, LType.INT64)
    live = c.valid_mask() & sel
    gid_v = torch.where(live, gid, ng)
    if s.distinct:
        return _segment_distinct(c, gid_v, ng, s)
    if s.op == "approx_count_distinct":
        return Column(_hll_estimate(_hll_registers(c, live, gid_v, ng)), None, LType.INT64)
    if s.op == "percentile":
        v, ok = _segment_percentile(c, gid_v, ng, s.param)
        return Column(v, ok, LType.FLOAT64)

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
        ident = _minmax_identity(c, s.op == "min")
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


# ----------------------------------------------------------------------
# lanes: the dense group-by and its kernels over a [G, n] selection (the
# batched dispatcher's tick, exec/lanes.py)


def group_aggregate_dense_lanes(batch: ColumnBatch, key_names: list[str],
                                domains: list[int], specs: list[AggSpec], sel):
    """``group_aggregate_dense`` once per row of the bool ``sel`` [G, n]
    over shared columns, each lane's columns equal to the one-lane call's
    with that row as its ``sel``: the same routes (the segment kernel under
    the gate, K3 + K1/K2 above it, the scatter elsewhere), each one launch
    over all lanes.  Only ``LANE_AGGS`` without DISTINCT.  -> (names,
    columns, present): key columns [ng] shared, aggregates and ``present``
    [G, ng]."""
    dev = batch.device
    key_cols = [batch.column(k) for k in key_names]
    ng = dense_num_groups(domains)
    gid = combined_dense_id(key_cols, domains)
    hist = _present_histogram(gid, sel, ng, lanes=True)
    if hist is not None:
        present = hist > 0
    else:
        present = seg_sum_lanes(torch.ones_like(gid), gid, sel, ng) > 0
    out_names, out_cols = _dense_key_columns(key_names, key_cols, domains, ng, dev)
    kernel_cols = dense_kernel_cols(batch, specs, gid, ng, sel, hist, lanes=True)
    out_names.extend(s.out_name for s in specs)
    out_cols.extend(kernel_cols if kernel_cols is not None else
                    [_segment_one_lanes(batch, s, gid, ng, sel) for s in specs])
    return out_names, out_cols, present


def _segment_one_lanes(batch: ColumnBatch, s: AggSpec, gid, ng: int, sel) -> Column:
    """``_segment_one`` over the lanes of ``sel``: a lane's dead and NULL
    rows drop by its mask row instead of by the drop slot."""
    n = gid.shape[0]
    if s.op == "count_star":
        return Column(seg_sum_lanes(torch.ones(n, dtype=torch.int64, device=gid.device), gid,
                                    sel, ng), None, LType.INT64)
    c = batch.column(s.input)
    live = _live(c, sel)

    def live_count(dtype=torch.int32):
        return seg_sum_lanes(torch.ones(n, dtype=dtype, device=gid.device), gid, live, ng)

    if s.op == "count":
        return Column(live_count(torch.int64), None, LType.INT64)
    if s.op == "sum":
        v = seg_sum_lanes(c.data.to(_sum_dtype(c)), gid, live, ng)
        return Column(v, live_count() > 0, agg_result_type("sum", c.ltype))
    if s.op == "avg":
        sm = seg_sum_lanes(c.data.to(torch.float64), gid, live, ng)
        ct = live_count()
        return Column(sm / ct.clamp(min=1), ct > 0, LType.FLOAT64)
    f = seg_min_lanes if s.op == "min" else seg_max_lanes
    return Column(f(c.data, gid, live, ng), live_count() > 0, c.ltype, c.dictionary)


def group_aggregate_sorted(batch: ColumnBatch, key_names: list[str],
                           specs: list[AggSpec], max_groups: int,
                           with_overflow: bool = False, order=None):
    """General GROUP BY: lexicographic stable sort, boundary cumsum group
    ids, segment reductions into a ``max_groups``-slot table.  ``order``:
    the key order of the whole base table computed on the host (the
    session's presort, storage/column_store.py ``agg_sort_permutation``),
    so only the stable partition of live rows first stays on the device.

    ``max_groups`` must upper-bound the true group count (the planner
    supplies it from statistics or len(batch)); groups fill slots densely
    and the output carries num_rows = group count.  With ``with_overflow``
    the result is ``(batch, overflow)``, ``overflow`` a 0-d bool tensor on
    the batch's device that is true when there were more groups than
    slots (read it on the host only where the caller needs it)."""
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

    if order is not None:
        order = order.to(torch.int64)
        perm = order[stable_partition(sel[order])]    # dead rows last
    else:
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
        out_cols.append(_segment_one(_input(sorted_batch, s), s, gid, max_groups, sel_s))
    present = torch.arange(max_groups, device=dev) < ngroups
    out = ColumnBatch(tuple(out_names), out_cols, present, ngroups, device=dev)
    if with_overflow:
        return out, flags.sum() > max_groups
    return out


# ----------------------------------------------------------------------
# partial-aggregate merge protocol (the streamed fold; the mesh later)

MERGE_OP = {
    "count": "sum", "count_star": "sum", "sum": "sum", "sumsq": "sum",
    "min": "min", "max": "max",
}


def partial_specs(specs: list[AggSpec]) -> tuple[list[AggSpec], dict]:
    """Rewrite aggregates into mergeable partials (AVG -> SUM+COUNT, STDDEV ->
    SUM+SUMSQ+COUNT), the analog of the reference's AGG partial/MERGE_AGG
    split.  Returns (partial specs, finalize plan).  Raises ValueError for
    the aggregates that need each group's rows (``ROW_AGGS``)."""
    parts: list[AggSpec] = []
    finalize: dict[str, tuple] = {}
    seen = {}

    def add(op, inp, distinct=False):
        key = (op, inp, distinct)
        if key in seen:
            return seen[key]
        name = f"__p{len(parts)}_{op}"
        parts.append(AggSpec(op, inp, name, distinct))
        seen[key] = name
        return name

    for s in specs:
        if s.op in ROW_AGGS:
            raise ValueError(f"{s.op} has no scalar partial form")
        if s.op == "avg":
            finalize[s.out_name] = ("avg", add("sum", s.input, s.distinct),
                                    add("count", s.input, s.distinct))
        elif s.op in _STDDEV:
            sq = add("sumsq", s.input)
            finalize[s.out_name] = (s.op, add("sum", s.input), sq, add("count", s.input))
        elif s.distinct:
            # distinct cannot merge from partials
            finalize[s.out_name] = ("passthrough", add(s.op, s.input, True))
        else:
            finalize[s.out_name] = ("passthrough", add(s.op, s.input))
    return parts, finalize


def finalize_partials(batch: ColumnBatch, finalize: dict,
                      key_names: list[str]) -> ColumnBatch:
    """Apply the finalize plan from ``partial_specs`` to a merged-partials
    batch: the keys, then one column per user aggregate."""
    names = list(key_names)
    cols = [batch.column(k) for k in key_names]
    for out_name, plan in finalize.items():
        kind = plan[0]
        if kind == "passthrough":
            c = batch.column(plan[1])
        elif kind == "avg":
            sm, ct = batch.column(plan[1]), batch.column(plan[2])
            ctv = ct.data.to(torch.float64)
            c = Column(sm.data.to(torch.float64) / ctv.clamp(min=1), ctv > 0, LType.FLOAT64)
        else:  # stddev family from (op, sum, sumsq, count)
            op = plan[0]
            sm, sq, ct = (batch.column(n) for n in plan[1:])
            n = ct.data.to(torch.float64)
            n1 = n.clamp(min=1.0)
            var = sq.data / n1 - (sm.data.to(torch.float64) / n1) ** 2
            denom = n1 if op in ("stddev", "variance") else (n - 1.0).clamp(min=1.0)
            var = (var * (n1 / denom)).clamp(min=0.0)
            v = torch.sqrt(var) if op.startswith("stddev") else var
            c = Column(v, n > 0, LType.FLOAT64)
        names.append(out_name)
        cols.append(c)
    return ColumnBatch(tuple(names), cols, batch.sel, batch.num_rows, device=batch.device)
