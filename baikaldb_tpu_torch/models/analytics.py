"""Analytic queries over the TPC-H tables: window functions, the sketch
aggregates and the extended builtins.

These are not TPC-H queries.  They are the shapes analytical users send on
top of the same schema (``models/tpch.py``): per-group top-1 by
``ROW_NUMBER()``, per-customer moving averages and value-distance (RANGE)
frames, approximate distinct counts and exact percentiles per group, and
date/string/bit builtins in GROUP BY queries.  Each returns a small result
(an outer aggregate or a GROUP BY over a handful of keys), so turning rows
into dicts does not dominate the run.  ``chip_smoke.py`` and
``tests/test_torch_tpch.py`` run this set, and ``check_against_numpy``
holds three of its results to numpy.

- ``w_rank`` (lineitem): ROW_NUMBER and RANK per order, by descending price,
  filtered on ``rn = 1`` in a derived table and aggregated outside.
- ``w_rows`` (orders): per-customer moving SUM/AVG/MIN over the last three
  orders (a ROWS frame), LAG/LEAD and NTILE(4).
- ``w_range`` (orders): a RANGE frame of 365 days over ``o_orderdate`` per
  customer, DENSE_RANK, FIRST_VALUE/LAST_VALUE over the whole partition.
- ``w_slide`` (lineitem): MIN/MAX/AVG over a frame that slides at both ends
  (5 rows either side, per supplier by ship date): the sparse table of
  ``ceil(log2 n)`` levels over every row.
- ``a_sketch`` / ``a_sketch_all`` (lineitem): APPROX_COUNT_DISTINCT, MEDIAN
  and PERCENTILE per (returnflag, linestatus), and over the whole table.
- ``b_dates`` (lineitem): DAYNAME, WEEK, YEARWEEK, TIMESTAMPDIFF and
  ``DATE_ADD(... INTERVAL n MONTH)``.
- ``b_phone`` (customer, one phone per customer), ``b_part`` (part names)
  and ``b_priority`` (orders): SUBSTRING_INDEX, LPAD, LOCATE, CONCAT_WS,
  CRC32, MD5 and REGEXP_LIKE on dictionaries of moderate size.
- ``b_bits`` (lineitem): HASH, the bit operators and trigonometry over
  ``l_discount`` / ``l_tax``.
"""

from __future__ import annotations

import numpy as np

_BY_ORDER = "PARTITION BY l_orderkey ORDER BY l_extendedprice DESC, l_linenumber"
_BY_CUST = "PARTITION BY o_custkey ORDER BY o_orderdate, o_orderkey"
_LAST3 = f"({_BY_CUST} ROWS BETWEEN 2 PRECEDING AND CURRENT ROW)"
_WHOLE = (f"({_BY_CUST} ROWS BETWEEN UNBOUNDED PRECEDING AND "
          "UNBOUNDED FOLLOWING)")
_SLIDE = ("(PARTITION BY l_suppkey ORDER BY l_shipdate, l_orderkey, l_linenumber "
          "ROWS BETWEEN 5 PRECEDING AND 5 FOLLOWING)")

QUERIES = {
    "w_rank": (
        "SELECT COUNT(*) AS orders, SUM(top_price) AS sum_top, SUM(rk) AS sum_rk, "
        "SUM(l_linenumber) AS sum_line "
        "FROM (SELECT l_orderkey, l_linenumber, l_extendedprice AS top_price, "
        f"ROW_NUMBER() OVER ({_BY_ORDER}) AS rn, RANK() OVER ({_BY_ORDER}) AS rk "
        "FROM lineitem) AS ranked WHERE rn = 1"),
    "w_rows": (
        "SELECT COUNT(*) AS n, SUM(mov_sum) AS s_sum, SUM(mov_avg) AS s_avg, "
        "SUM(mov_min) AS s_min, SUM(prev_price) AS s_lag, SUM(next_price) AS s_lead, "
        "COUNT(next_price) AS n_lead, SUM(tile) AS s_tile "
        "FROM (SELECT o_custkey, "
        f"SUM(o_totalprice) OVER {_LAST3} AS mov_sum, "
        f"AVG(o_totalprice) OVER {_LAST3} AS mov_avg, "
        f"MIN(o_totalprice) OVER {_LAST3} AS mov_min, "
        f"LAG(o_totalprice, 1, 0) OVER ({_BY_CUST}) AS prev_price, "
        f"LEAD(o_totalprice) OVER ({_BY_CUST}) AS next_price, "
        f"NTILE(4) OVER ({_BY_CUST}) AS tile "
        "FROM orders) AS moving"),
    "w_range": (
        "SELECT o_orderpriority, COUNT(*) AS n, SUM(year_spend) AS s_year, "
        "MAX(drk) AS max_drk, SUM(drk) AS s_drk, SUM(first_price) AS s_first, "
        "SUM(last_price) AS s_last "
        "FROM (SELECT o_orderpriority, "
        "SUM(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate "
        "RANGE BETWEEN 365 PRECEDING AND CURRENT ROW) AS year_spend, "
        "DENSE_RANK() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS drk, "
        f"FIRST_VALUE(o_totalprice) OVER {_WHOLE} AS first_price, "
        f"LAST_VALUE(o_totalprice) OVER {_WHOLE} AS last_price "
        "FROM orders) AS spend "
        "GROUP BY o_orderpriority ORDER BY o_orderpriority"),
    "w_slide": (
        "SELECT COUNT(*) AS n, SUM(lo_qty) AS s_lo, SUM(hi_qty) AS s_hi, "
        "SUM(avg_disc) AS s_avg "
        f"FROM (SELECT MIN(l_quantity) OVER {_SLIDE} AS lo_qty, "
        f"MAX(l_quantity) OVER {_SLIDE} AS hi_qty, "
        f"AVG(l_discount) OVER {_SLIDE} AS avg_disc FROM lineitem) AS slide"),
    "a_sketch": (
        "SELECT l_returnflag, l_linestatus, COUNT(*) AS n, "
        "APPROX_COUNT_DISTINCT(l_partkey) AS ndv_part, MEDIAN(l_quantity) AS med_qty, "
        "PERCENTILE(l_extendedprice, 0.9) AS p90_price "
        "FROM lineitem GROUP BY l_returnflag, l_linestatus "
        "ORDER BY l_returnflag, l_linestatus"),
    "a_sketch_all": (
        "SELECT COUNT(*) AS n, APPROX_COUNT_DISTINCT(l_partkey) AS ndv_part, "
        "MEDIAN(l_quantity) AS med_qty, PERCENTILE(l_extendedprice, 0.9) AS p90_price "
        "FROM lineitem"),
    "b_dates": (
        "SELECT DAYNAME(l_shipdate) AS ship_day, COUNT(*) AS n, "
        "SUM(WEEK(l_shipdate)) AS s_week, SUM(YEARWEEK(l_receiptdate)) AS s_yearweek, "
        "SUM(TIMESTAMPDIFF(DAY, l_shipdate, l_receiptdate)) AS s_transit, "
        "SUM(TIMESTAMPDIFF(MONTH, l_commitdate, DATE_ADD(l_shipdate, INTERVAL 2 MONTH))) "
        "AS s_months, MAX(DATE_ADD(l_shipdate, INTERVAL 1 MONTH)) AS last_plus_month "
        "FROM lineitem GROUP BY DAYNAME(l_shipdate) ORDER BY ship_day"),
    "b_phone": (
        "SELECT SUBSTRING_INDEX(c_phone, '-', 1) AS country, COUNT(*) AS n, "
        "SUM(LOCATE('-', c_phone, 5)) AS s_locate, SUM(CRC32(c_phone)) AS s_crc, "
        "SUM(CASE WHEN REGEXP_LIKE(c_phone, '-[1-4][0-9]{2}-') THEN 1 ELSE 0 END) AS n_match "
        "FROM customer GROUP BY SUBSTRING_INDEX(c_phone, '-', 1) ORDER BY country"),
    "b_part": (
        "SELECT LPAD(SUBSTRING_INDEX(p_name, ' ', 1), 12, '.') AS color, COUNT(*) AS n, "
        "SUM(CRC32(MD5(p_name))) AS s_md5, SUM(LOCATE('e', p_name)) AS s_locate "
        "FROM part GROUP BY LPAD(SUBSTRING_INDEX(p_name, ' ', 1), 12, '.') "
        "ORDER BY n DESC, color LIMIT 10"),
    "b_priority": (
        "SELECT CONCAT_WS('/', 'prio', o_orderpriority) AS tag, COUNT(*) AS n, "
        "SUM(CRC32(o_orderpriority)) AS s_crc "
        "FROM orders GROUP BY CONCAT_WS('/', 'prio', o_orderpriority) ORDER BY tag"),
    "b_bits": (
        "SELECT l_returnflag, COUNT(*) AS n, "
        "SUM(HASH(l_orderkey, l_linenumber) % 1000) AS s_hash, "
        "SUM(BIT_AND(l_partkey, 255)) AS s_and, SUM(BIT_XOR(l_suppkey, l_partkey)) AS s_xor, "
        "SUM(BIT_COUNT(l_orderkey)) AS s_bits, SUM(RIGHT_SHIFT(l_partkey, 3)) AS s_shift, "
        "SUM(SIN(l_discount) + ATAN2(l_tax, l_discount + 0.01) + DEGREES(l_tax) "
        "+ SINH(l_discount) + COT(l_tax + 0.5)) AS s_trig "
        "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag"),
}


def _np(table, col: str) -> np.ndarray:
    return table.column(col).combine_chunks().to_numpy(zero_copy_only=False)


def _close(a: float, b: float, rtol: float = 1e-9) -> bool:
    return abs(a - b) <= rtol * abs(b)


def check_against_numpy(results: dict, lineitem) -> dict:
    """``w_rank``, ``a_sketch`` and ``a_sketch_all`` against numpy over the
    same ``lineitem`` table; raises AssertionError on a mismatch, and returns
    each APPROX_COUNT_DISTINCT's relative error against the exact count.

    - W-rank: one ``rn = 1`` row per order that has lineitems; their prices
      sum to the sum of the per-order maxima (rtol 1e-9), their line numbers
      are the first line at that maximum, and each has rank 1;
    - A-sketch: per (returnflag, linestatus) and over the whole table, the
      row count is exact, MEDIAN and PERCENTILE(0.9) equal
      ``np.quantile(..., method="linear")`` to rtol 1e-9, and
      APPROX_COUNT_DISTINCT lies within 15% of the exact distinct count
      (its standard error is 1.04 / sqrt(512) = 4.6%)."""
    okey, line = _np(lineitem, "l_orderkey"), _np(lineitem, "l_linenumber")
    price, qty = _np(lineitem, "l_extendedprice"), _np(lineitem, "l_quantity")
    part = _np(lineitem, "l_partkey")

    order = np.lexsort((line, -price, okey))
    first = np.ones(len(order), bool)
    first[1:] = okey[order][1:] != okey[order][:-1]
    top = order[first]
    (r,) = results["w_rank"]
    if r["orders"] != len(top) or r["sum_rk"] != len(top):
        raise AssertionError(f"w_rank: {r['orders']} top rows (rank sum {r['sum_rk']}), "
                             f"numpy has {len(top)} orders with lineitems")
    if not _close(r["sum_top"], float(price[top].sum())) \
            or r["sum_line"] != int(line[top].sum()):
        raise AssertionError(f"w_rank: sum of top prices {r['sum_top']} / lines "
                             f"{r['sum_line']}, numpy {float(price[top].sum())} / "
                             f"{int(line[top].sum())}")

    hll_err = {}

    def check_group(where: str, row: dict, keep) -> None:
        if row["n"] != int(keep.sum()):
            raise AssertionError(f"{where}: {row['n']} rows, numpy {int(keep.sum())}")
        for key, x, p in (("med_qty", qty, 0.5), ("p90_price", price, 0.9)):
            want = float(np.quantile(x[keep], p, method="linear"))
            if not _close(row[key], want):
                raise AssertionError(f"{where}: {key} {row[key]}, numpy {want}")
        exact = len(np.unique(part[keep]))
        hll_err[where] = row["ndv_part"] / exact - 1
        if abs(row["ndv_part"] - exact) > 0.15 * exact:
            raise AssertionError(f"{where}: APPROX_COUNT_DISTINCT {row['ndv_part']}, "
                                 f"exact {exact}")

    flag, status = _np(lineitem, "l_returnflag"), _np(lineitem, "l_linestatus")
    want_keys = sorted(set(zip(flag.tolist(), status.tolist())))
    got_keys = [(r["l_returnflag"], r["l_linestatus"]) for r in results["a_sketch"]]
    if got_keys != want_keys:
        raise AssertionError(f"a_sketch: groups {got_keys}, numpy {want_keys}")
    for r in results["a_sketch"]:
        check_group(f"a_sketch {r['l_returnflag']}{r['l_linestatus']}", r,
                    (flag == r["l_returnflag"]) & (status == r["l_linestatus"]))
    check_group("a_sketch_all", results["a_sketch_all"][0], np.ones(len(qty), bool))
    return hll_err
