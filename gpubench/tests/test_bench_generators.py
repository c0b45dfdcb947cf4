"""The TPC-H generator keeps the specification's rules wherever they shape
a join, a group or a predicate (clause 4.2.3), and the traffic generator
gives every seed the same statements in the same mix."""

import datetime

import numpy as np
import pyarrow.compute as pc
import pytest

from gpubench.core.traffic import client_streams
from gpubench.gen import tpch

SCALE = 0.02


@pytest.fixture(scope="module", params=[0, 2**31 + 5])
def t(request):
    return tpch.generate(SCALE, request.param)


def col(t, table, name):
    c = t[table].column(name)
    if str(c.type).startswith("date"):
        c = c.cast("int32")
    return c.to_numpy(zero_copy_only=False)


def test_the_same_seed_gives_the_same_tables():
    a, b = tpch.generate(0.005, 9), tpch.generate(0.005, 9)
    assert all(a[k].equals(b[k]) for k in a)
    assert not a["lineitem"].equals(tpch.generate(0.005, 10)["lineitem"])


def test_row_counts_scale(t):
    n = {k: v.num_rows for k, v in t.items()}
    assert (n["region"], n["nation"]) == (5, 25)
    assert n["part"] == 200_000 * SCALE and n["supplier"] == 10_000 * SCALE
    assert n["partsupp"] == 4 * n["part"] and n["customer"] == 150_000 * SCALE
    assert n["orders"] == 1_500_000 * SCALE
    assert 3.9 * n["orders"] < n["lineitem"] < 4.1 * n["orders"]


def test_keys(t):
    ok = col(t, "orders", "o_orderkey")
    i = np.arange(len(ok))
    assert np.array_equal(ok, (i // 8) * 32 + i % 8 + 1)
    cust = col(t, "orders", "o_custkey")
    assert (cust % 3 != 0).all() and cust.min() >= 1
    assert cust.max() <= t["customer"].num_rows
    # each part's 4 suppliers by the formula, and every lineitem's
    # (part, supplier) is one of them
    n_supp = t["supplier"].num_rows
    pp, ps = col(t, "partsupp", "ps_partkey"), col(t, "partsupp", "ps_suppkey")
    assert np.array_equal(ps, tpch.supplier_of(pp, np.tile(np.arange(4), len(pp) // 4), n_supp))
    pairs = set(zip(pp.tolist(), ps.tolist()))
    lp, ls = col(t, "lineitem", "l_partkey"), col(t, "lineitem", "l_suppkey")
    assert all(p in pairs for p in zip(lp.tolist(), ls.tolist()))
    assert set(col(t, "lineitem", "l_orderkey")) == set(ok)


def test_derived_columns(t):
    cur = (datetime.date(1995, 6, 17) - datetime.date(1970, 1, 1)).days
    ship, receipt = col(t, "lineitem", "l_shipdate"), col(t, "lineitem", "l_receiptdate")
    flag, status = col(t, "lineitem", "l_returnflag"), col(t, "lineitem", "l_linestatus")
    assert set(flag[receipt <= cur]) == {"R", "A"} and set(flag[receipt > cur]) == {"N"}
    assert np.array_equal(status == "O", ship > cur)
    # q1's four groups
    assert len({(a, b) for a, b in zip(flag, status)}) == 4
    pk = col(t, "part", "p_partkey")
    retail = (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)) / 100
    assert np.array_equal(col(t, "part", "p_retailprice"), retail)
    qty, ext = col(t, "lineitem", "l_quantity"), col(t, "lineitem", "l_extendedprice")
    lp = col(t, "lineitem", "l_partkey")
    assert np.allclose(ext, qty * retail[lp - 1], rtol=0, atol=1e-6)
    # an order's status and total from its lines
    lo = col(t, "lineitem", "l_orderkey")
    disc, tax = col(t, "lineitem", "l_discount"), col(t, "lineitem", "l_tax")
    ok = col(t, "orders", "o_orderkey")
    first = {k: i for i, k in enumerate(ok.tolist())}
    idx = np.asarray([first[k] for k in lo.tolist()])
    n_open = np.bincount(idx, weights=status == "O", minlength=len(ok))
    n_all = np.bincount(idx, minlength=len(ok))
    want = np.where(n_open == n_all, "O", np.where(n_open == 0, "F", "P"))
    assert np.array_equal(col(t, "orders", "o_orderstatus"), want)
    total = np.bincount(idx, weights=ext * (1 + tax) * (1 - disc), minlength=len(ok))
    # cents truncated twice a line, as dbgen does
    assert np.allclose(col(t, "orders", "o_totalprice"), total, rtol=0, atol=0.02 * 7)
    od = col(t, "orders", "o_orderdate")
    assert od.min() >= (datetime.date(1992, 1, 1) - datetime.date(1970, 1, 1)).days
    assert od.max() <= (datetime.date(1998, 8, 2) - datetime.date(1970, 1, 1)).days
    assert (ship - od[idx] >= 1).all() and (ship - od[idx] <= 121).all()
    assert (receipt - ship >= 1).all() and (receipt - ship <= 30).all()


@pytest.mark.parametrize("table, name, lo, hi", [
    ("region", "r_comment", 31, 115), ("nation", "n_comment", 31, 114),
    ("part", "p_comment", 5, 22), ("supplier", "s_comment", 25, 100),
    ("partsupp", "ps_comment", 49, 198), ("customer", "c_comment", 29, 116),
    ("orders", "o_comment", 19, 78), ("lineitem", "l_comment", 10, 43),
    ("supplier", "s_address", 10, 40), ("customer", "c_address", 10, 40)])
def test_string_lengths(t, table, name, lo, hi):
    n = pc.utf8_length(t[table].column(name)).to_numpy()
    assert n.min() >= lo and n.max() <= hi
    assert n.max() - n.min() > (hi - lo) // 2 or len(n) < 30


def test_strings(t):
    names = col(t, "part", "p_name")
    words = [n.split(" ") for n in names]
    assert all(len(w) == 5 and len(set(w)) == 5 and set(w) <= set(tpch.COLORS) for w in words)
    assert len(tpch.COLORS) == 92 == len(set(tpch.COLORS))
    # q9's '%green%' picks about 5 of 92 colours' share of the parts
    green = np.mean(["green" in n for n in names])
    assert 0.035 < green < 0.075
    sc = col(t, "supplier", "s_comment")
    k = max(1, round(5 * SCALE))
    assert sum(("Customer" in s and "Complaints" in s.split("Customer", 1)[1]) for s in sc) >= k
    assert sum(("Customer" in s and "Recommends" in s.split("Customer", 1)[1]) for s in sc) >= k
    # q13's '%special%requests%' comes from the grammar's text alone
    oc = col(t, "orders", "o_comment")
    special = np.mean([("special" in s and "requests" in s.split("special", 1)[1]) for s in oc])
    assert 0.002 < special < 0.05
    phone = col(t, "customer", "c_phone")
    nat = col(t, "customer", "c_nationkey")
    assert all(p.startswith(f"{10 + k}-") and len(p) == 15 for p, k in zip(phone, nat))


def test_text_pool_is_the_grammar():
    pool = tpch.text_pool(np.random.default_rng(1), 20_000).decode()
    vocab = {w for k in tpch._W for w in " ".join(tpch._words(k)[0]).split()} | {"the"}
    words = pool.replace(",", " ").split()
    for term in (".", ";", ":", "?", "!", "--"):
        words = [w[:-len(term)] if w.endswith(term) else w for w in words]
    assert set(words[1:-1]) <= vocab


TRAFFIC = {"clients": 3, "order": "shuffled_blocks", "statements_per_client": 12,
           "mix": {"a": 2, "b": 1},
           "literals": {"a": [{"name": "x", "normal": [0.0, 1.0], "round": 3},
                              {"name": "w", "integers": [2, 5]},
                              {"name": "hi", "expr": "w * 2 + 1"}]}}
CONFIG = {"statements": {"a": "SELECT {x}, {w}, {hi}", "b": "SELECT 1"}}


def test_traffic_is_the_seeds():
    one = client_streams(CONFIG, TRAFFIC, 2**31 + 11)
    assert one == client_streams(CONFIG, TRAFFIC, 2**31 + 11)
    assert one != client_streams(CONFIG, TRAFFIC, 12)
    for stream in one:
        names = [s.name for s in stream]
        # every block of three holds the mix: two a, one b
        assert all(sorted(names[i:i + 3]) == ["a", "a", "b"] for i in range(0, 12, 3))
        for s in stream:
            if s.name == "a":
                assert 2 <= s.args["w"] < 5 and s.args["hi"] == 2 * s.args["w"] + 1
                assert s.sql == f"SELECT {s.args['x']}, {s.args['w']}, {s.args['hi']}"


def test_an_unknown_order_is_refused():
    with pytest.raises(ValueError):
        client_streams(CONFIG, dict(TRAFFIC, order="random"), 1)
