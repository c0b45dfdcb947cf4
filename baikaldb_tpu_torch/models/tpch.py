"""TPC-H schema, data generator, and the full 22-query suite.

A copy of ``baikaldb_tpu/models/tpch.py`` (numpy + pyarrow), kept in the
port so that nothing here imports the JAX package.  It carries:

- the full 8-table TPC-H schema (CREATE TABLE statements),
- a self-contained columnar data generator (a numpy dbgen stand-in: uniform
  keys/dates/prices with the spec's categorical domains and patterned
  strings so every LIKE/phrase predicate selects meaningfully — not the
  official dbgen streams, but the same shapes/selectivities for engine
  benchmarking); the same seed gives the same tables as the JAX package's
  generator,
- all 22 queries adapted to this engine's SQL surface: date arithmetic
  resolved to literals, EXTRACT(YEAR ..) as YEAR(), views as CTEs,
- ``VARIANTS``: queries of a stock query's shape with parameters under which
  this generator's data returns rows (this file's own; the JAX package's
  copy has none).
"""

from __future__ import annotations

import datetime

import numpy as np
import pyarrow as pa

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["O", "F"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chocolate", "coral", "cornflower", "cream",
          "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
          "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green",
          "grey", "honeydew", "hot", "indian", "ivory", "khaki", "lace",
          "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
          "maroon", "medium", "metallic", "midnight", "mint", "misty",
          "moccasin", "navajo", "navy", "olive", "orange", "orchid",
          "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
          "puff", "purple", "red", "rose", "rosy", "royal", "saddle",
          "salmon", "sandy", "seashell", "sienna", "sky", "slate", "smoke",
          "snow", "spring", "steel", "tan", "thistle", "tomato", "turquoise",
          "violet", "wheat", "white", "yellow"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

_EPOCH = datetime.date(1970, 1, 1)


def _d(iso: str) -> int:
    y, m, d = map(int, iso.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


DDL = {
    "region": "CREATE TABLE region (r_regionkey INT PRIMARY KEY, "
              "r_name VARCHAR(25), r_comment VARCHAR(152))",
    "nation": "CREATE TABLE nation (n_nationkey INT PRIMARY KEY, "
              "n_name VARCHAR(25), n_regionkey INT, n_comment VARCHAR(152))",
    "part": "CREATE TABLE part (p_partkey INT PRIMARY KEY, p_name VARCHAR(55), "
            "p_mfgr VARCHAR(25), p_brand VARCHAR(10), p_type VARCHAR(25), "
            "p_size INT, p_container VARCHAR(10), p_retailprice DOUBLE, "
            "p_comment VARCHAR(23))",
    "supplier": "CREATE TABLE supplier (s_suppkey INT PRIMARY KEY, "
                "s_name VARCHAR(25), s_address VARCHAR(40), s_nationkey INT, "
                "s_phone VARCHAR(15), s_acctbal DOUBLE, s_comment VARCHAR(101))",
    "partsupp": "CREATE TABLE partsupp (ps_partkey INT, ps_suppkey INT, "
                "ps_availqty INT, ps_supplycost DOUBLE, ps_comment VARCHAR(199), "
                "PRIMARY KEY (ps_partkey, ps_suppkey))",
    "customer": "CREATE TABLE customer (c_custkey INT PRIMARY KEY, "
                "c_name VARCHAR(25), c_address VARCHAR(40), c_nationkey INT, "
                "c_phone VARCHAR(15), c_acctbal DOUBLE, "
                "c_mktsegment VARCHAR(10), c_comment VARCHAR(117))",
    "orders": "CREATE TABLE orders (o_orderkey INT PRIMARY KEY, o_custkey INT, "
              "o_orderstatus VARCHAR(1), o_totalprice DOUBLE, o_orderdate DATE, "
              "o_orderpriority VARCHAR(15), o_clerk VARCHAR(15), "
              "o_shippriority INT, o_comment VARCHAR(79))",
    "lineitem": "CREATE TABLE lineitem (l_orderkey INT, l_partkey INT, "
                "l_suppkey INT, l_linenumber INT, l_quantity DOUBLE, "
                "l_extendedprice DOUBLE, l_discount DOUBLE, l_tax DOUBLE, "
                "l_returnflag VARCHAR(1), l_linestatus VARCHAR(1), "
                "l_shipdate DATE, l_commitdate DATE, l_receiptdate DATE, "
                "l_shipinstruct VARCHAR(25), l_shipmode VARCHAR(10), "
                "l_comment VARCHAR(44))",
}


def _comments(rng, n, phrases=(), p=0.05):
    """Filler comments; `phrases` appear with probability p each (feeds the
    LIKE '%word%word%' predicates of Q13/Q16/Q19-style filters).  Fully
    vectorized: SF-scale generation must not loop per row."""
    words = np.asarray(["fluffily", "carefully", "quickly", "ideas", "deposits",
                        "packages", "accounts", "requests", "pending",
                        "regular", "express", "bold", "silent"])
    idx = rng.integers(0, len(words), (n, 3))
    out = np.char.add(np.char.add(words[idx[:, 0]], " "),
                      np.char.add(np.char.add(words[idx[:, 1]], " "),
                                  words[idx[:, 2]]))
    for ph in phrases:
        hit = rng.random(n) < p
        out = np.where(hit, np.char.add(out, " " + ph), out)
    return out


def _phones(rng, nations: np.ndarray):
    n = len(nations)
    a = rng.integers(100, 999, n)
    b = rng.integers(100, 999, n)
    c = rng.integers(1000, 9999, n)
    code = (10 + nations).astype(str)
    return np.char.add(np.char.add(np.char.add(code, "-"), a.astype(str)),
                       np.char.add(np.char.add("-", b.astype(str)),
                                   np.char.add("-", c.astype(str))))


def _tagged(prefix: str, nums: np.ndarray, width: int = 9):
    return np.char.add(prefix, np.char.zfill(nums.astype(str), width))


def generate(scale: float = 0.01, seed: int = 0) -> dict[str, pa.Table]:
    """-> table name -> pa.Table; row counts scale like dbgen (SF1 = 6M
    lineitem)."""
    rng = np.random.default_rng(seed)
    n_orders = max(100, int(1_500_000 * scale))
    n_cust = max(30, int(150_000 * scale))
    n_supp = max(10, int(10_000 * scale))
    n_part = max(40, int(200_000 * scale))

    region = pa.table({
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": REGIONS,
        "r_comment": _comments(rng, 5),
    })
    nation = pa.table({
        "n_nationkey": np.arange(len(NATIONS), dtype=np.int32),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": np.asarray([r for _, r in NATIONS], np.int32),
        "n_comment": _comments(rng, len(NATIONS)),
    })

    c1 = np.asarray(COLORS)[rng.integers(0, len(COLORS), n_part)]
    c2 = np.asarray(COLORS)[rng.integers(0, len(COLORS), n_part)]
    p_name = np.char.add(np.char.add(c1, " "), c2)
    mfgr_n = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    p_type = np.char.add(
        np.char.add(np.asarray(TYPE_S1)[rng.integers(0, len(TYPE_S1), n_part)], " "),
        np.char.add(
            np.char.add(np.asarray(TYPE_S2)[rng.integers(0, len(TYPE_S2), n_part)], " "),
            np.asarray(TYPE_S3)[rng.integers(0, len(TYPE_S3), n_part)]))
    p_container = np.char.add(
        np.char.add(np.asarray(CONTAINER_S1)[rng.integers(0, len(CONTAINER_S1), n_part)], " "),
        np.asarray(CONTAINER_S2)[rng.integers(0, len(CONTAINER_S2), n_part)])
    part = pa.table({
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int32),
        "p_name": p_name,
        "p_mfgr": np.char.add("Manufacturer#", mfgr_n.astype(str)),
        "p_brand": np.char.add("Brand#",
                               np.char.add(mfgr_n.astype(str),
                                           brand_n.astype(str))),
        "p_type": p_type,
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": p_container,
        "p_retailprice": np.round(900 + rng.uniform(0, 1000, n_part), 2),
        "p_comment": _comments(rng, n_part),
    })

    s_nat = rng.integers(0, len(NATIONS), n_supp).astype(np.int32)
    supplier = pa.table({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int32),
        "s_name": _tagged("Supplier#", np.arange(1, n_supp + 1)),
        "s_address": _comments(rng, n_supp),
        "s_nationkey": s_nat,
        "s_phone": _phones(rng, s_nat),
        "s_acctbal": np.round(rng.uniform(-999, 9999, n_supp), 2),
        "s_comment": _comments(rng, n_supp,
                               phrases=["Customer Complaints"], p=0.03),
    })

    # partsupp: each part supplied by 4 suppliers
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int32), 4)
    ps_supp = ((ps_part * 7 + np.tile(np.arange(4, dtype=np.int32) * 13,
                                      n_part)) % n_supp + 1).astype(np.int32)
    # de-dup (small n_supp can collide): keep first of each (part, supp)
    packed = ps_part.astype(np.int64) * (n_supp + 1) + ps_supp
    _, first = np.unique(packed, return_index=True)
    keep = np.zeros(len(ps_part), bool)
    keep[np.sort(first)] = True
    ps_part, ps_supp = ps_part[keep], ps_supp[keep]
    n_ps = len(ps_part)
    partsupp = pa.table({
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int32),
        "ps_supplycost": np.round(rng.uniform(1, 1000, n_ps), 2),
        "ps_comment": _comments(rng, n_ps),
    })

    c_nat = rng.integers(0, len(NATIONS), n_cust).astype(np.int32)
    customer = pa.table({
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int32),
        "c_name": _tagged("Customer#", np.arange(1, n_cust + 1)),
        "c_address": _comments(rng, n_cust),
        "c_nationkey": c_nat,
        "c_phone": _phones(rng, c_nat),
        "c_acctbal": np.round(rng.uniform(-999, 9999, n_cust), 2),
        "c_mktsegment": np.asarray(SEGMENTS)[rng.integers(0, 5, n_cust)],
        "c_comment": _comments(rng, n_cust, phrases=["special requests"],
                               p=0.1),
    })

    o_dates = rng.integers(_d("1992-01-01"), _d("1998-08-02"), n_orders)
    # like dbgen, a third of customers never order (feeds Q13's zero bucket
    # and Q22's NOT EXISTS): custkeys divisible by 3 are skipped
    o_cust = rng.integers(1, n_cust + 1, n_orders).astype(np.int32)
    o_cust = np.where(o_cust % 3 == 0, np.maximum(o_cust - 1, 1), o_cust)
    orders = pa.table({
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int32),
        "o_custkey": o_cust,
        "o_orderstatus": np.asarray(["O", "F", "P"])[rng.integers(0, 3, n_orders)],
        "o_totalprice": np.round(rng.uniform(1000, 500000, n_orders), 2),
        "o_orderdate": pa.array(o_dates.astype(np.int32), pa.int32()).cast(pa.date32()),
        "o_orderpriority": np.asarray(PRIORITIES)[rng.integers(0, 5, n_orders)],
        "o_clerk": _tagged("Clerk#", rng.integers(1, 1000, n_orders)),
        "o_shippriority": np.zeros(n_orders, np.int32),
        "o_comment": _comments(rng, n_orders, phrases=["special requests"],
                               p=0.08),
    })

    per = rng.integers(1, 8, n_orders)
    l_order = np.repeat(np.arange(1, n_orders + 1, dtype=np.int32), per)
    n_li = len(l_order)
    starts = np.cumsum(per) - per
    linenum = (np.arange(n_li) - np.repeat(starts, per) + 1).astype(np.int32)
    ship = np.repeat(o_dates, per) + rng.integers(1, 122, n_li)
    commit = np.repeat(o_dates, per) + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    lineitem = pa.table({
        "l_orderkey": l_order,
        "l_partkey": rng.integers(1, n_part + 1, n_li).astype(np.int32),
        "l_suppkey": rng.integers(1, n_supp + 1, n_li).astype(np.int32),
        "l_linenumber": linenum,
        "l_quantity": rng.integers(1, 51, n_li).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n_li), 2),
        "l_discount": np.round(rng.integers(0, 11, n_li) / 100.0, 2),
        "l_tax": np.round(rng.integers(0, 9, n_li) / 100.0, 2),
        "l_returnflag": np.asarray(RETURNFLAGS)[rng.integers(0, 3, n_li)],
        "l_linestatus": np.asarray(LINESTATUS)[rng.integers(0, 2, n_li)],
        "l_shipdate": pa.array(ship.astype(np.int32), pa.int32()).cast(pa.date32()),
        "l_commitdate": pa.array(commit.astype(np.int32), pa.int32()).cast(pa.date32()),
        "l_receiptdate": pa.array(receipt.astype(np.int32), pa.int32()).cast(pa.date32()),
        "l_shipinstruct": np.asarray(SHIPINSTRUCT)[rng.integers(0, 4, n_li)],
        "l_shipmode": np.asarray(SHIPMODES)[rng.integers(0, 7, n_li)],
        "l_comment": _comments(rng, n_li),
    })
    return {"region": region, "nation": nation, "part": part,
            "supplier": supplier, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


def load_into(session, scale: float = 0.01, seed: int = 0):
    tables = generate(scale, seed)
    for name, ddl in DDL.items():
        session.execute(ddl)
        session.load_arrow(name, tables[name])
    return tables


QUERIES = {
    # Q1: pricing summary report (date resolved: 1998-12-01 - 90 days)
    "q1": """
        SELECT l_returnflag, l_linestatus,
               SUM(l_quantity) AS sum_qty,
               SUM(l_extendedprice) AS sum_base_price,
               SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
               SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
               AVG(l_quantity) AS avg_qty,
               AVG(l_extendedprice) AS avg_price,
               AVG(l_discount) AS avg_disc,
               COUNT(*) AS count_order
        FROM lineitem
        WHERE l_shipdate <= '1998-09-02'
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus
    """,
    # Q2: minimum cost supplier (correlated MIN subquery)
    "q2": """
        SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
               s_phone, s_comment
        FROM part, supplier, partsupp, nation, region
        WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
          AND p_size = 15 AND p_type LIKE '%BRASS'
          AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
          AND r_name = 'EUROPE'
          AND ps_supplycost = (
            SELECT MIN(ps_supplycost)
            FROM partsupp, supplier, nation, region
            WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
              AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
              AND r_name = 'EUROPE')
        ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
        LIMIT 100
    """,
    # Q3: shipping priority
    "q3": """
        SELECT l_orderkey,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue,
               o_orderdate, o_shippriority
        FROM customer
        JOIN orders ON c_custkey = o_custkey
        JOIN lineitem ON l_orderkey = o_orderkey
        WHERE c_mktsegment = 'BUILDING'
          AND o_orderdate < '1995-03-15'
          AND l_shipdate > '1995-03-15'
        GROUP BY l_orderkey, o_orderdate, o_shippriority
        ORDER BY revenue DESC, o_orderdate
        LIMIT 10
    """,
    # Q4: order priority checking (correlated EXISTS)
    "q4": """
        SELECT o_orderpriority, COUNT(*) AS order_count
        FROM orders
        WHERE o_orderdate >= '1993-07-01' AND o_orderdate < '1993-10-01'
          AND EXISTS (
            SELECT 1 FROM lineitem
            WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
        GROUP BY o_orderpriority
        ORDER BY o_orderpriority
    """,
    # Q5: local supplier volume
    "q5": """
        SELECT n_name,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM customer
        JOIN orders ON c_custkey = o_custkey
        JOIN lineitem ON l_orderkey = o_orderkey
        JOIN supplier ON l_suppkey = s_suppkey AND c_nationkey = s_nationkey
        JOIN nation ON s_nationkey = n_nationkey
        JOIN region ON n_regionkey = r_regionkey
        WHERE r_name = 'ASIA'
          AND o_orderdate >= '1994-01-01' AND o_orderdate < '1995-01-01'
        GROUP BY n_name
        ORDER BY revenue DESC
    """,
    # Q6: forecasting revenue change
    "q6": """
        SELECT SUM(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'
          AND l_discount BETWEEN 0.05 AND 0.07
          AND l_quantity < 24
    """,
    # Q7: volume shipping between two nations (nation aliased twice)
    "q7": """
        SELECT supp_nation, cust_nation, l_year, SUM(volume) AS revenue
        FROM (
          SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
                 YEAR(l_shipdate) AS l_year,
                 l_extendedprice * (1 - l_discount) AS volume
          FROM supplier
          JOIN lineitem ON s_suppkey = l_suppkey
          JOIN orders ON o_orderkey = l_orderkey
          JOIN customer ON c_custkey = o_custkey
          JOIN nation n1 ON s_nationkey = n1.n_nationkey
          JOIN nation n2 ON c_nationkey = n2.n_nationkey
          WHERE ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
                 OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
            AND l_shipdate >= '1995-01-01' AND l_shipdate <= '1996-12-31'
        ) shipping
        GROUP BY supp_nation, cust_nation, l_year
        ORDER BY supp_nation, cust_nation, l_year
    """,
    # Q8: national market share
    "q8": """
        SELECT o_year,
               SUM(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0 END)
                   / SUM(volume) AS mkt_share
        FROM (
          SELECT YEAR(o_orderdate) AS o_year,
                 l_extendedprice * (1 - l_discount) AS volume,
                 n2.n_name AS nation
          FROM part
          JOIN lineitem ON p_partkey = l_partkey
          JOIN supplier ON s_suppkey = l_suppkey
          JOIN orders ON l_orderkey = o_orderkey
          JOIN customer ON o_custkey = c_custkey
          JOIN nation n1 ON c_nationkey = n1.n_nationkey
          JOIN region ON n1.n_regionkey = r_regionkey
          JOIN nation n2 ON s_nationkey = n2.n_nationkey
          WHERE r_name = 'AMERICA'
            AND o_orderdate >= '1995-01-01' AND o_orderdate <= '1996-12-31'
            AND p_type = 'ECONOMY ANODIZED STEEL'
        ) all_nations
        GROUP BY o_year
        ORDER BY o_year
    """,
    # Q9: product type profit measure
    "q9": """
        SELECT nation, o_year, SUM(amount) AS sum_profit
        FROM (
          SELECT n_name AS nation, YEAR(o_orderdate) AS o_year,
                 l_extendedprice * (1 - l_discount)
                   - ps_supplycost * l_quantity AS amount
          FROM part
          JOIN lineitem ON p_partkey = l_partkey
          JOIN supplier ON s_suppkey = l_suppkey
          JOIN partsupp ON ps_suppkey = l_suppkey AND ps_partkey = l_partkey
          JOIN orders ON o_orderkey = l_orderkey
          JOIN nation ON s_nationkey = n_nationkey
          WHERE p_name LIKE '%green%'
        ) profit
        GROUP BY nation, o_year
        ORDER BY nation, o_year DESC
    """,
    # Q10: returned item reporting (top customers)
    "q10": """
        SELECT c_custkey, c_name,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue,
               c_acctbal, n_name, c_address, c_phone, c_comment
        FROM customer
        JOIN orders ON c_custkey = o_custkey
        JOIN lineitem ON l_orderkey = o_orderkey
        JOIN nation ON c_nationkey = n_nationkey
        WHERE o_orderdate >= '1993-10-01' AND o_orderdate < '1994-01-01'
          AND l_returnflag = 'R'
        GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
                 c_comment
        ORDER BY revenue DESC
        LIMIT 20
    """,
    # Q11: important stock identification (HAVING vs scalar subquery)
    "q11": """
        SELECT ps_partkey, SUM(ps_supplycost * ps_availqty) AS value
        FROM partsupp
        JOIN supplier ON ps_suppkey = s_suppkey
        JOIN nation ON s_nationkey = n_nationkey
        WHERE n_name = 'GERMANY'
        GROUP BY ps_partkey
        HAVING SUM(ps_supplycost * ps_availqty) > (
          SELECT SUM(ps_supplycost * ps_availqty) * 0.0005
          FROM partsupp
          JOIN supplier ON ps_suppkey = s_suppkey
          JOIN nation ON s_nationkey = n_nationkey
          WHERE n_name = 'GERMANY')
        ORDER BY value DESC
    """,
    # Q12: shipping modes and order priority
    "q12": """
        SELECT l_shipmode,
               SUM(CASE WHEN o_orderpriority = '1-URGENT'
                         OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END) AS high_line_count,
               SUM(CASE WHEN o_orderpriority <> '1-URGENT'
                        AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END) AS low_line_count
        FROM orders
        JOIN lineitem ON o_orderkey = l_orderkey
        WHERE l_shipmode IN ('MAIL', 'SHIP')
          AND l_commitdate < l_receiptdate
          AND l_shipdate < l_commitdate
          AND l_receiptdate >= '1994-01-01' AND l_receiptdate < '1995-01-01'
        GROUP BY l_shipmode
        ORDER BY l_shipmode
    """,
    # Q13: customer distribution (LEFT JOIN with ON filter, count-of-counts)
    "q13": """
        SELECT c_count, COUNT(*) AS custdist
        FROM (
          SELECT c_custkey AS custkey, COUNT(o_orderkey) AS c_count
          FROM customer
          LEFT JOIN orders ON c_custkey = o_custkey
               AND o_comment NOT LIKE '%special%requests%'
          GROUP BY c_custkey
        ) c_orders
        GROUP BY c_count
        ORDER BY custdist DESC, c_count DESC
    """,
    # Q14: promotion effect
    "q14": """
        SELECT 100.00 * SUM(CASE WHEN p_type LIKE 'PROMO%'
                                 THEN l_extendedprice * (1 - l_discount)
                                 ELSE 0 END)
               / SUM(l_extendedprice * (1 - l_discount)) AS promo_revenue
        FROM lineitem
        JOIN part ON l_partkey = p_partkey
        WHERE l_shipdate >= '1995-09-01' AND l_shipdate < '1995-10-01'
    """,
    # Q15: top supplier (view as CTE + MAX scalar subquery)
    "q15": """
        WITH revenue AS (
          SELECT l_suppkey AS supplier_no,
                 SUM(l_extendedprice * (1 - l_discount)) AS total_revenue
          FROM lineitem
          WHERE l_shipdate >= '1996-01-01' AND l_shipdate < '1996-04-01'
          GROUP BY l_suppkey
        )
        SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
        FROM supplier
        JOIN revenue ON s_suppkey = supplier_no
        WHERE total_revenue = (SELECT MAX(total_revenue) FROM revenue)
        ORDER BY s_suppkey
    """,
    # Q16: parts/supplier relationship (NOT IN subquery, COUNT DISTINCT)
    "q16": """
        SELECT p_brand, p_type, p_size,
               COUNT(DISTINCT ps_suppkey) AS supplier_cnt
        FROM partsupp
        JOIN part ON p_partkey = ps_partkey
        WHERE p_brand <> 'Brand#45' AND p_type NOT LIKE 'MEDIUM POLISHED%'
          AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
          AND ps_suppkey NOT IN (
            SELECT s_suppkey FROM supplier
            WHERE s_comment LIKE '%Customer%Complaints%')
        GROUP BY p_brand, p_type, p_size
        ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
    """,
    # Q17: small-quantity-order revenue (correlated AVG subquery)
    "q17": """
        SELECT SUM(l_extendedprice) / 7.0 AS avg_yearly
        FROM lineitem
        JOIN part ON p_partkey = l_partkey
        WHERE p_brand = 'Brand#23' AND p_container = 'MED BOX'
          AND l_quantity < (
            SELECT 0.2 * AVG(l_quantity) FROM lineitem
            WHERE l_partkey = p_partkey)
    """,
    # Q18: large volume customers (IN over grouped HAVING)
    "q18": """
        SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
               SUM(l_quantity) AS total_qty
        FROM customer
        JOIN orders ON c_custkey = o_custkey
        JOIN lineitem ON o_orderkey = l_orderkey
        WHERE o_orderkey IN (
          SELECT l_orderkey FROM lineitem
          GROUP BY l_orderkey HAVING SUM(l_quantity) > 212)
        GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
        ORDER BY o_totalprice DESC, o_orderdate
        LIMIT 100
    """,
    # Q19: discounted revenue (disjunction of conjunct bundles)
    "q19": """
        SELECT SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM lineitem
        JOIN part ON p_partkey = l_partkey
        WHERE (p_brand = 'Brand#12'
               AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
               AND l_quantity >= 1 AND l_quantity <= 11
               AND p_size BETWEEN 1 AND 5
               AND l_shipmode IN ('AIR', 'REG AIR')
               AND l_shipinstruct = 'DELIVER IN PERSON')
           OR (p_brand = 'Brand#23'
               AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
               AND l_quantity >= 10 AND l_quantity <= 20
               AND p_size BETWEEN 1 AND 10
               AND l_shipmode IN ('AIR', 'REG AIR')
               AND l_shipinstruct = 'DELIVER IN PERSON')
           OR (p_brand = 'Brand#34'
               AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
               AND l_quantity >= 20 AND l_quantity <= 30
               AND p_size BETWEEN 1 AND 15
               AND l_shipmode IN ('AIR', 'REG AIR')
               AND l_shipinstruct = 'DELIVER IN PERSON')
    """,
    # Q20: potential part promotion (nested IN + correlated SUM)
    "q20": """
        SELECT s_name, s_address
        FROM supplier
        JOIN nation ON s_nationkey = n_nationkey
        WHERE n_name = 'CANADA'
          AND s_suppkey IN (
            SELECT ps_suppkey FROM partsupp
            WHERE ps_partkey IN (
                SELECT p_partkey FROM part WHERE p_name LIKE 'forest%')
              AND ps_availqty > (
                SELECT 0.5 * SUM(l_quantity) FROM lineitem
                WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
                  AND l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'))
        ORDER BY s_name
    """,
    # Q21: suppliers who kept orders waiting (EXISTS + NOT EXISTS w/ <>)
    "q21": """
        SELECT s_name, COUNT(*) AS numwait
        FROM supplier
        JOIN lineitem l1 ON s_suppkey = l1.l_suppkey
        JOIN orders ON o_orderkey = l1.l_orderkey
        JOIN nation ON s_nationkey = n_nationkey
        WHERE o_orderstatus = 'F'
          AND l1.l_receiptdate > l1.l_commitdate
          AND EXISTS (
            SELECT 1 FROM lineitem l2
            WHERE l2.l_orderkey = l1.l_orderkey
              AND l2.l_suppkey <> l1.l_suppkey)
          AND NOT EXISTS (
            SELECT 1 FROM lineitem l3
            WHERE l3.l_orderkey = l1.l_orderkey
              AND l3.l_suppkey <> l1.l_suppkey
              AND l3.l_receiptdate > l3.l_commitdate)
          AND n_name = 'SAUDI ARABIA'
        GROUP BY s_name
        ORDER BY numwait DESC, s_name
        LIMIT 100
    """,
    # Q22: global sales opportunity (SUBSTRING, NOT EXISTS, scalar AVG)
    "q22": """
        SELECT cntrycode, COUNT(*) AS numcust, SUM(acctbal) AS totacctbal
        FROM (
          SELECT SUBSTRING(c_phone, 1, 2) AS cntrycode, c_acctbal AS acctbal
          FROM customer
          WHERE SUBSTRING(c_phone, 1, 2) IN
                ('13', '31', '23', '29', '30', '18', '17')
            AND c_acctbal > (
              SELECT AVG(c_acctbal) FROM customer
              WHERE c_acctbal > 0.00 AND SUBSTRING(c_phone, 1, 2) IN
                    ('13', '31', '23', '29', '30', '18', '17'))
            AND NOT EXISTS (
              SELECT 1 FROM orders WHERE o_custkey = c_custkey)
        ) custsale
        GROUP BY cntrycode
        ORDER BY cntrycode
    """,
}

# Stock q20 returns no rows from this generator at any scale: lineitem draws
# l_partkey and l_suppkey independently, where dbgen draws the supplier from
# the part's four partsupp suppliers, so almost no partsupp pair has a sale,
# the correlated SUM is NULL and ``ps_availqty > NULL`` is never true.  This
# variant keeps q20's shape (nested IN, correlated scalar subquery on both
# keys, semi join) and widens the filters until rows come back: every
# American nation, the whole shipping history, and a factor of 200 under
# which about half of the pairs with a sale pass the comparison.
VARIANTS = {
    "q20_rows": """
        SELECT s_name, s_address
        FROM supplier
        JOIN nation ON s_nationkey = n_nationkey
        WHERE n_regionkey = 1
          AND s_suppkey IN (
            SELECT ps_suppkey FROM partsupp
            WHERE ps_partkey IN (
                SELECT p_partkey FROM part WHERE p_name LIKE 'f%')
              AND ps_availqty > (
                SELECT 200 * SUM(l_quantity) FROM lineitem
                WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
                  AND l_shipdate >= '1992-01-01' AND l_shipdate < '1999-01-01'))
        ORDER BY s_name
    """,
}
