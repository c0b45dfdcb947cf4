"""The Star Schema Benchmark's data at a scale factor, made from a seed by the
rules of the SSB specification (O'Neil, O'Neil, Chen, Revilak, rev. 3,
2009), and flattened into ``lineorder_flat`` as ClickHouse's documentation
builds it: ``lineorder`` joined once with ``customer``, ``supplier`` and
``part``, 38 columns.

Sizes (spec section 3): ``customer`` 30,000 x SF, ``supplier`` 2,000 x SF,
``part`` 200,000 x floor(1 + log2 SF) (200,000 x SF below SF 1), ``date``
the days 1992-01-01 to 1998-12-31, ``lineorder`` TPC-H's orders (1,500,000 x
SF, 1 to 7 lines each, about 6,000,000 x SF rows).

Every rule that shapes a predicate or a group is the spec's:

- ``c_city`` / ``s_city``: the first 9 characters of the nation's name,
  blank-padded, and a digit 0-9 (``UNITED KI1``); nation and region from
  TPC-H's 25 nations;
- ``p_mfgr`` ``MFGR#m`` (m 1-5), ``p_category`` ``MFGR#mn`` (n 1-5) within
  the part's ``p_mfgr``, ``p_brand`` ``MFGR#mnb`` (b 1-40) within its
  category; ``p_color`` one of TPC-H's 92 colours, ``p_name`` two of them;
- ``lineorder`` by TPC-H's order and line rules: sparse order keys,
  customers never a multiple of 3, order dates uniform over [1992-01-01,
  1998-12-31 - 151 days], quantity 1-50, discount 0-10, tax 0-8, commit
  date 30-90 days after the order; ``lo_extendedprice`` = quantity x the
  part's price (cents, TPC-H's retail-price formula), ``lo_revenue`` =
  ``lo_extendedprice`` x (100 - ``lo_discount``) / 100, ``lo_supplycost`` =
  6 x price / 10 and ``lo_ordtotalprice`` the order's lines with discount
  and tax, in whole cents as dbgen computes them.

The flattening is foreign-key gathers: a string column is an Arrow
dictionary array whose codes are gathered from its dimension's, never a
string a row.  Not dbgen: the random streams differ (other rows for the
same seed), and ``lo_suppkey`` is uniform over the suppliers (SSB has no
``partsupp`` to draw it from)."""

from __future__ import annotations

import datetime
import math

import numpy as np
import pyarrow as pa

from gpubench.gen.tpch import (COLORS, CONTAINER_S1, CONTAINER_S2, NATIONS, PRIORITIES,
                               REGIONS, SEGMENTS, SHIPMODES, TYPE_S1, TYPE_S2, TYPE_S3,
                               VSTRING, _pack, _strings, retail_cents)

_EPOCH = datetime.date(1970, 1, 1)


def _d(iso: str) -> int:
    y, m, d = map(int, iso.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


STARTDATE = _d("1992-01-01")
ENDDATE = _d("1998-12-31")

# the flat table's columns in ClickHouse's order
LO = ["lo_orderkey", "lo_linenumber", "lo_custkey", "lo_partkey", "lo_suppkey",
      "lo_orderdate", "lo_orderpriority", "lo_shippriority", "lo_quantity",
      "lo_extendedprice", "lo_ordtotalprice", "lo_discount", "lo_revenue",
      "lo_supplycost", "lo_tax", "lo_commitdate", "lo_shipmode"]
C = ["c_name", "c_address", "c_city", "c_nation", "c_region", "c_phone", "c_mktsegment"]
S = ["s_name", "s_address", "s_city", "s_nation", "s_region", "s_phone"]
P = ["p_name", "p_mfgr", "p_category", "p_brand", "p_color", "p_type", "p_size",
     "p_container"]
COLUMNS = LO + C + S + P


def sizes(scale: float) -> dict:
    """Rows of each dimension and the number of orders at ``scale``."""
    parts = 200_000 * math.floor(1 + math.log2(scale)) if scale >= 1 else 200_000 * scale
    return {"customer": max(30, int(30_000 * scale)), "supplier": max(10, int(2_000 * scale)),
            "part": max(40, int(parts)), "orders": max(100, int(1_500_000 * scale))}


def _dict(codes: np.ndarray, values) -> pa.DictionaryArray:
    return pa.DictionaryArray.from_arrays(pa.array(codes.astype(np.int32, copy=False)),
                                          pa.array(list(values), pa.string())
                                          if not isinstance(values, pa.Array) else values)


def _vstrings(rng, n: int, lo: int, hi: int) -> pa.Array:
    lens = rng.integers(lo, hi + 1, n)
    return _strings(_pack(VSTRING[rng.integers(0, len(VSTRING), (n, hi))], lens), lens)


def _cities() -> list:
    """City ``10 * nation + digit``: the nation's first 9 characters, blank
    padded, and the digit."""
    return [f"{name[:9]:<9}{k}" for name, _ in NATIONS for k in range(10)]


def _geography(rng, n: int, prefix: str, number_fmt: str) -> dict:
    """Name, address, city, nation, region and phone of ``n`` customers or
    suppliers -> {column: (codes a row of the dimension, dictionary)}."""
    nation = rng.integers(0, len(NATIONS), n).astype(np.int32)
    city = nation * 10 + rng.integers(0, 10, n).astype(np.int32)
    region = np.asarray([r for _, r in NATIONS], np.int32)[nation]
    a, b = rng.integers(100, 1000, (2, n))
    c = rng.integers(1000, 10000, n)
    phones = [f"{10 + k}-{x}-{y}-{z}" for k, x, y, z in
              zip(nation.tolist(), a.tolist(), b.tolist(), c.tolist())]
    own = np.arange(n, dtype=np.int32)
    return {f"{prefix}_name": (own, [number_fmt % (i + 1) for i in range(n)]),
            f"{prefix}_address": (own, _vstrings(rng, n, 10, 25)),
            f"{prefix}_city": (city, _cities()),
            f"{prefix}_nation": (nation, [name for name, _ in NATIONS]),
            f"{prefix}_region": (region, REGIONS),
            f"{prefix}_phone": (own, phones)}


def _part(rng, n: int) -> dict:
    m = rng.integers(0, 5, n).astype(np.int32)
    cat = m * 5 + rng.integers(0, 5, n).astype(np.int32)
    brand = cat * 40 + rng.integers(0, 40, n).astype(np.int32)
    first = rng.integers(0, len(COLORS), n)
    second = (first + rng.integers(1, len(COLORS), n)) % len(COLORS)
    name = (first * len(COLORS) + second).astype(np.int32)
    types = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
    conts = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
    return {
        "p_name": (name, [f"{a} {b}" for a in COLORS for b in COLORS]),
        "p_mfgr": (m, [f"MFGR#{i}" for i in range(1, 6)]),
        "p_category": (cat, [f"MFGR#{i}{j}" for i in range(1, 6) for j in range(1, 6)]),
        "p_brand": (brand, [f"MFGR#{i}{j}{k}" for i in range(1, 6) for j in range(1, 6)
                            for k in range(1, 41)]),
        "p_color": (rng.integers(0, len(COLORS), n).astype(np.int32), COLORS),
        "p_type": (rng.integers(0, len(types), n).astype(np.int32), types),
        "p_size": (rng.integers(1, 51, n).astype(np.int32), None),
        "p_container": (rng.integers(0, len(conts), n).astype(np.int32), conts),
    }


def _table(cols: dict, n: int, key: str) -> pa.Table:
    out = {key: np.arange(1, n + 1, dtype=np.int32)}
    for k, (codes, values) in cols.items():
        out[k] = codes if values is None else _dict(codes, values)
    return pa.table(out)


def _date_table() -> pa.Table:
    days = np.arange(STARTDATE, ENDDATE + 1, dtype=np.int32)
    dt = days.astype("datetime64[D]")
    y = dt.astype("datetime64[Y]").astype(np.int32) + 1970
    m = dt.astype("datetime64[M]").astype(np.int32) % 12 + 1
    d = (dt - dt.astype("datetime64[M]")).astype(np.int32) + 1
    return pa.table({"d_datekey": y * 10000 + m * 100 + d,
                     "d_date": pa.array(days).cast(pa.date32()),
                     "d_year": y, "d_yearmonthnum": y * 100 + m,
                     "d_daynuminmonth": d})


def generate(scale: float, seed: int) -> dict[str, pa.Table]:
    """-> {``customer``, ``supplier``, ``part``, ``date``,
    ``lineorder_flat``}: pyarrow tables, the same for the same seed."""
    rng = np.random.default_rng([int(seed), 0x55B])
    n = sizes(scale)
    cust = _geography(rng, n["customer"], "c", "Customer#%09d")
    cust["c_mktsegment"] = (rng.integers(0, len(SEGMENTS), n["customer"]).astype(np.int32),
                            SEGMENTS)
    supp = _geography(rng, n["supplier"], "s", "Supplier#%09d")
    part = _part(rng, n["part"])
    price = retail_cents(np.arange(1, n["part"] + 1)).astype(np.int32)

    # orders, then their lines
    n_o = n["orders"]
    i = np.arange(n_o, dtype=np.int64)
    o_key = ((i // 8) * 32 + i % 8 + 1).astype(np.int32)
    nc = n["customer"]
    j = rng.integers(0, nc - nc // 3, n_o)
    o_cust = (3 * (j // 2) + 1 + j % 2).astype(np.int32)
    o_date = rng.integers(STARTDATE, ENDDATE - 151 + 1, n_o).astype(np.int32)
    o_prio = rng.integers(0, len(PRIORITIES), n_o).astype(np.int32)
    per = rng.integers(1, 8, n_o)
    del i, j
    owner = np.repeat(np.arange(n_o, dtype=np.int32), per)
    rows = len(owner)
    starts = np.cumsum(per) - per
    linenum = (np.arange(rows, dtype=np.int32) - np.repeat(starts, per).astype(np.int32)
               + 1).astype(np.int32)
    del starts
    partkey = rng.integers(1, n["part"] + 1, rows, dtype=np.int32)
    suppkey = rng.integers(1, n["supplier"] + 1, rows, dtype=np.int32)
    qty = rng.integers(1, 51, rows, dtype=np.int32)
    disc = rng.integers(0, 11, rows, dtype=np.int32)
    tax = rng.integers(0, 9, rows, dtype=np.int32)
    commit = o_date[owner] + rng.integers(30, 91, rows, dtype=np.int32)
    pidx = partkey - 1
    p_price = price[pidx]
    ext = qty * p_price
    revenue = (ext.astype(np.int64) * (100 - disc) // 100).astype(np.int32)
    line_total = revenue.astype(np.int64) * (100 + tax) // 100
    total = np.bincount(owner, weights=line_total, minlength=n_o).astype(np.int64)
    del line_total
    custkey = o_cust[owner]

    flat = {
        "lo_orderkey": o_key[owner],
        "lo_linenumber": linenum,
        "lo_custkey": custkey,
        "lo_partkey": partkey,
        "lo_suppkey": suppkey,
        "lo_orderdate": pa.array(o_date[owner]).cast(pa.date32()),
        "lo_orderpriority": _dict(o_prio[owner], PRIORITIES),
        "lo_shippriority": np.zeros(rows, np.int32),
        "lo_quantity": qty,
        "lo_extendedprice": ext,
        "lo_ordtotalprice": total.astype(np.int32)[owner],
        "lo_discount": disc,
        "lo_revenue": revenue,
        "lo_supplycost": (6 * p_price // 10).astype(np.int32),
        "lo_tax": tax,
        "lo_commitdate": pa.array(commit).cast(pa.date32()),
        "lo_shipmode": _dict(rng.integers(0, len(SHIPMODES), rows, dtype=np.int32), SHIPMODES),
    }
    del owner, p_price, commit
    # the dimensions' columns by foreign-key gathers: codes only
    for cols, fk in ((cust, custkey - 1), (supp, suppkey - 1), (part, pidx)):
        for k, (codes, values) in cols.items():
            g = codes[fk]
            flat[k] = g if values is None else _dict(g, values)
        del fk
    return {"customer": _table(cust, n["customer"], "c_custkey"),
            "supplier": _table(supp, n["supplier"], "s_suppkey"),
            "part": _table(part, n["part"], "p_partkey").append_column(
                "p_price", pa.array(price)),
            "date": _date_table(),
            "lineorder_flat": pa.table({k: flat[k] for k in COLUMNS})}


def tables(config: dict, seed: int) -> dict[str, pa.Table]:
    return generate(float(config["scale"]), seed)
