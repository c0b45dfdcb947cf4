"""Column statistics: equi-depth histograms + most-common values.

The port of ``baikaldb_tpu/index/stats.py`` (numpy only, copied so the port
imports nothing of the JAX package).  The planner's join ordering and
selectivity estimates read these payloads; with equal statistics the port
plans exactly as the JAX package does.

Statistics are derived state computed lazily per table version from the
store snapshot.  A bounded sample keeps collection O(sample log sample):

- equi-depth histogram (numeric/temporal): bucket bounds at quantiles, so
  range selectivity is bucket counting + linear interpolation within the
  boundary buckets.
- most-common values (any type): exact top-k of the sample.
- ndv estimate for join fanout (distinct count of the sample).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.flags import FLAGS, define

define("histogram_stats", True,
       "planner selectivity from equi-depth histograms + MCVs instead of "
       "fixed constants")
define("histogram_buckets", 64, "equi-depth histogram bucket count")
define("histogram_mcv", 16, "most-common values kept per column")
define("histogram_sample", 200_000,
       "stats sample cap (rows) per column collection")

# the pre-histogram fixed constants, kept as the fallback
DEFAULT_EQ_SEL = 0.1
DEFAULT_RANGE_SEL = 0.3

# HLL register-index bits: 2^12 registers ≈ 1.6% standard error — plenty
# for the adaptive-agg local-vs-raw threshold (a 2x decision boundary)
_HLL_P = 12
_HLL_MULT = np.uint64(0x9E3779B97F4A7C15)


def hll_ndv(values: np.ndarray, p: int = _HLL_P) -> Optional[int]:
    """HyperLogLog distinct-count estimate over a FULL numeric value array
    (vectorized numpy, O(n) — cheap enough to run on every stats
    collection, unlike an exact unique of millions of rows).  None when
    the dtype can't be hashed vectorized (object/strings — the caller
    falls back to the sampled Chao floor)."""
    try:
        v = np.ascontiguousarray(values)
        if v.dtype.kind == "f":
            if v.dtype.itemsize not in (4, 8):
                return None     # float16 etc. would alias adjacent values
            #                     through the 32-bit view — fall back
            # canonicalize -0.0/0.0 before bit-punning so equal floats
            # hash equal
            v = v + 0.0
            v = v.view(np.uint64 if v.dtype.itemsize == 8
                       else np.uint32).astype(np.uint64)
        elif v.dtype.kind in "iub":
            v = v.astype(np.int64).view(np.uint64)
        else:
            return None
    except (TypeError, ValueError):
        return None
    with np.errstate(over="ignore"):
        h = v * _HLL_MULT
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
    m = 1 << p
    idx = (h >> np.uint64(64 - p)).astype(np.int64)
    nz = 64 - p
    rem = h & np.uint64((1 << nz) - 1)
    # rho = leading-zero count of the nz-bit word + 1; bit length == frexp
    # exponent (values < 2^52 are exactly representable, nz = 52 here), so
    # rho = nz - bitlen + 1
    _, exp = np.frexp(rem.astype(np.float64))
    rho = np.where(rem == 0, nz + 1, nz - exp + 1).astype(np.int64)
    reg = np.zeros(m, np.int64)
    np.maximum.at(reg, idx, rho)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-reg.astype(np.float64)))
    zeros = int((reg == 0).sum())
    if est <= 2.5 * m and zeros:
        est = m * np.log(m / zeros)         # small-range correction
    return max(1, int(round(est)))


def collect(values: np.ndarray, n_total: int, n_nulls: int,
            numeric: bool) -> dict:
    """Build the stats payload from a (non-null) value sample.

    The distinct-count estimate (``ndv``/``ndv_method``) feeds join fanout
    sizing and the adaptive-agg local-vs-raw decision: exact when the
    sample holds every value, HLL over the full array when sampling
    truncates a numeric column, sampled Chao floor otherwise."""
    out: dict = {"n": int(n_total), "nulls": int(n_nulls)}
    if not len(values):
        out["ndv"] = 0
        out["ndv_method"] = "exact"
        return out
    sample = values
    cap = int(FLAGS.histogram_sample)
    truncated = len(sample) > cap
    if truncated:
        idx = np.random.RandomState(0).choice(len(sample), cap,
                                              replace=False)
        sample = sample[idx]
    uniq, counts = np.unique(sample, return_counts=True)
    scale = max(len(values), 1) / len(sample)
    if not truncated:
        # the sample IS the population: the unique count is exact
        out["ndv"] = int(min(len(uniq), n_total - n_nulls)) or 1
        out["ndv_method"] = "exact"
    else:
        h = hll_ndv(values)
        if h is not None:
            out["ndv"] = int(min(h, n_total - n_nulls)) or 1
            out["ndv_method"] = "hll"
        else:
            # scale sample ndv up to the population conservatively: values
            # seen once in the sample hint at unseen ones (a Chao-style
            # floor)
            singletons = int((counts == 1).sum())
            out["ndv"] = int(min(len(uniq) + singletons * (scale - 1.0),
                                 n_total - n_nulls)) or 1
            out["ndv_method"] = "chao"
    k = int(FLAGS.histogram_mcv)
    if len(uniq) <= k:
        mcv_idx = np.argsort(-counts)
    else:
        mcv_idx = np.argpartition(-counts, k)[:k]
        mcv_idx = mcv_idx[np.argsort(-counts[mcv_idx])]
    out["mcv"] = [(uniq[i].item() if hasattr(uniq[i], "item")
                   else uniq[i], float(counts[i] * scale))
                  for i in mcv_idx]
    if numeric:
        b = int(FLAGS.histogram_buckets)
        qs = np.quantile(sample.astype(np.float64),
                         np.linspace(0.0, 1.0, b + 1))
        out["hist"] = [float(x) for x in qs]
    return out


def partition_key_ndv(payload: Optional[dict]) -> int:
    """Distinct-count estimate of a candidate partition key column for the
    keyed exchange scheduler's tie-break (plan/distribute._Scheduler):
    among equality-class signatures serving the same number of join
    levels, the higher-spread key balances shards better.  Falls through
    the same ladder as the planner's join-fanout ``distinct()``: collected
    ndv, then value span, then dictionary size; 0 = no basis (the
    tie-break treats unknown as worst)."""
    if not payload:
        return 0
    if payload.get("ndv"):
        return int(payload["ndv"])
    if payload.get("min") is not None and payload.get("max") is not None:
        try:
            return max(1, int(payload["max"]) - int(payload["min"]) + 1)
        except (TypeError, ValueError):
            return 0
    if payload.get("dict_size"):
        return int(payload["dict_size"])
    return 0


def _hist_frac_below(hist: list, v: float, inclusive: bool) -> float:
    """Fraction of non-null values < v (<= v when inclusive), by
    equi-depth bucket counting + linear interpolation."""
    b = len(hist) - 1
    if b <= 0:
        return 0.5
    if v < hist[0]:
        return 0.0
    if v > hist[-1]:
        return 1.0
    pos = float(np.searchsorted(np.asarray(hist), v, side="right") - 1)
    pos = min(pos, b - 1)
    lo, hi = hist[int(pos)], hist[int(pos) + 1]
    inner = 0.5 if hi <= lo else (v - lo) / (hi - lo)
    frac = (pos + inner) / b
    if inclusive:
        frac += 1.0 / b * 0.01      # nudge: <= includes the boundary mass
    return min(max(frac, 0.0), 1.0)


def eq_selectivity(st: dict, value) -> Optional[float]:
    if "mcv" not in st:
        return None                 # no collected payload: no basis
    n = st.get("n", 0)
    live = n - st.get("nulls", 0)
    if n <= 0 or live <= 0:
        return 0.0
    mcv = st.get("mcv") or []
    mcv_total = 0.0
    for v, cnt in mcv:
        try:
            if v == value or (isinstance(v, (int, float))
                              and isinstance(value, (int, float))
                              and float(v) == float(value)):
                return min(cnt / n, 1.0)
        except TypeError:
            pass
        mcv_total += cnt
    ndv = st.get("ndv") or 1
    rest_vals = max(ndv - len(mcv), 1)
    rest_rows = max(live - mcv_total, 0.0)
    return min(max(rest_rows / rest_vals / n, 1.0 / max(n, 1)), 1.0)


def range_selectivity(st: dict, op: str, value) -> Optional[float]:
    hist = st.get("hist")
    n = st.get("n", 0)
    if not hist or n <= 0:
        return None
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    live_frac = (n - st.get("nulls", 0)) / n
    if op == "lt":
        f = _hist_frac_below(hist, v, False)
    elif op == "le":
        f = _hist_frac_below(hist, v, True)
    elif op == "gt":
        f = 1.0 - _hist_frac_below(hist, v, True)
    elif op == "ge":
        f = 1.0 - _hist_frac_below(hist, v, False)
    else:
        return None
    return min(max(f * live_frac, 0.0), 1.0)


def _coerce_value(st: dict, value):
    """Temporal literals compare against the histogram's integer space
    (days / microseconds since epoch)."""
    kind = st.get("kind")
    if kind and isinstance(value, str):
        import datetime

        try:
            s = value.strip()
            if kind == "date" and len(s) <= 10:
                return (datetime.date.fromisoformat(s)
                        - datetime.date(1970, 1, 1)).days
            dt = datetime.datetime.fromisoformat(s.replace("T", " "))
            if kind == "date":
                return (dt.date() - datetime.date(1970, 1, 1)).days
            return int((dt - datetime.datetime(1970, 1, 1))
                       .total_seconds() * 1e6)
        except ValueError:
            return value
    return value


def selectivity_class(sel: Optional[float]) -> int:
    """Coarse log8 bucket of a combined WHERE selectivity, the unit the
    mesh plan cache keys on (exec/session): class 0 = unselective (>= 1/8
    of rows survive), each higher class is another 8x cut, -1 = no stats
    basis.  Coarse on purpose — each distinct class is another planned
    variant of the statement, so the bucketing must collapse the continuum
    of bound values into a handful of plan-relevant regimes."""
    if sel is None:
        return -1
    import math

    s = min(max(float(sel), 1e-12), 1.0)
    return min(8, int(-math.log(s, 8) + 1e-9))


def conjunct_selectivity(st: Optional[dict], op: str,
                         value) -> Optional[float]:
    """Selectivity of ``col OP literal`` under ``st``; None = no basis
    (caller falls back to the fixed defaults)."""
    if not st or not FLAGS.histogram_stats:
        return None
    if "mcv" not in st and "hist" not in st:
        return None                 # min/max-only dict (collection failed)
    value = _coerce_value(st, value)
    if op == "eq":
        return eq_selectivity(st, value)
    if op == "ne":
        s = eq_selectivity(st, value)
        return None if s is None else min(max(1.0 - s, 0.0), 1.0)
    return range_selectivity(st, op, value)
