"""The SSB generator keeps the specification's rules (cardinalities, the
cities', categories' and brands' derivations, the line rules and
``lo_revenue``'s formula), and the ``ssb_flat`` reference's comparison
bites: a whole run of ``ssb_flat_sf16-flights`` on the CPU at a small scale
reads ``correct`` false with an altered, a halved or a stale answer, true
without a fault, and its float32 control fails."""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest

from gpubench.control import control_readings
from gpubench.core.cell import run_cell
from gpubench.core.spec import load_cell
from gpubench.gen import ssb
from gpubench.gen.tpch import NATIONS, REGIONS, retail_cents
from gpubench.tests.conftest import ROOT
from gpubench.tests.test_bench_faults import fault  # noqa: F401  (a fixture)

SCALE = 0.02
CELL = "ssb_flat_sf16-flights"


@pytest.fixture(scope="module", params=[0, 2**31 + 5])
def t(request):
    return ssb.generate(SCALE, request.param)


def ints(table, name):
    c = table.column(name)
    if str(c.type).startswith("date"):
        c = c.cast("int32")
    return c.to_numpy()


def strs(table, name):
    return np.asarray(table.column(name).to_pylist(), dtype=object)


def test_the_same_seed_gives_the_same_tables():
    a, b = ssb.generate(0.005, 9), ssb.generate(0.005, 9)
    assert all(a[k].equals(b[k]) for k in a)
    assert not a["lineorder_flat"].equals(ssb.generate(0.005, 10)["lineorder_flat"])


def test_cardinalities(t):
    assert ssb.sizes(16) == {"customer": 480_000, "supplier": 32_000, "part": 1_000_000,
                             "orders": 24_000_000}
    assert ssb.sizes(100)["part"] == 1_400_000
    n = {k: v.num_rows for k, v in t.items()}
    assert n["customer"] == 30_000 * SCALE and n["supplier"] == 2_000 * SCALE
    assert n["part"] == 200_000 * SCALE and n["date"] == 2557
    orders = 1_500_000 * SCALE
    assert 3.9 * orders < n["lineorder_flat"] < 4.1 * orders
    lf = t["lineorder_flat"]
    assert lf.column_names == ssb.COLUMNS and len(ssb.COLUMNS) == 38
    assert sum(c.startswith("lo_") for c in ssb.COLUMNS) == 17
    # every string column is dictionary-encoded: codes, no string a row
    for f in lf.schema:
        assert pa.types.is_dictionary(f.type) or pa.types.is_integer(f.type) \
            or pa.types.is_date(f.type), f.name


def test_geography(t):
    lf = t["lineorder_flat"]
    region = dict(NATIONS)
    for side in ("c", "s"):
        city, nation, reg = (strs(lf, f"{side}_{k}") for k in ("city", "nation", "region"))
        for c, na, r in set(zip(city, nation, reg)):
            assert len(c) == 10 and c[:9] == f"{na[:9]:<9}" and c[9].isdigit()
            assert r == REGIONS[region[na]]
    cities = lf.column("c_city").combine_chunks().dictionary.to_pylist()
    assert len(cities) == 250 and "UNITED KI1" in cities and "INDIA    0" in cities


def test_part_hierarchy(t):
    lf = t["lineorder_flat"]
    pairs = set(zip(strs(lf, "p_mfgr"), strs(lf, "p_category"), strs(lf, "p_brand")))
    for m, c, b in pairs:
        assert m[:5] == "MFGR#" and 1 <= int(m[5:]) <= 5
        assert c[:6] == m and len(c) == 7 and 1 <= int(c[6]) <= 5
        assert b[:7] == c and 1 <= int(b[7:]) <= 40
    assert len({b for _, _, b in pairs}) > 900


def test_line_rules(t):
    lf = t["lineorder_flat"]
    qty, disc, tax = (ints(lf, k) for k in ("lo_quantity", "lo_discount", "lo_tax"))
    assert qty.min() >= 1 and qty.max() <= 50 and disc.min() >= 0 and disc.max() <= 10
    assert tax.min() >= 0 and tax.max() <= 8
    price = retail_cents(ints(lf, "lo_partkey")).astype(np.int64)
    ext = ints(lf, "lo_extendedprice").astype(np.int64)
    assert np.array_equal(ext, qty * price)
    assert np.array_equal(ints(lf, "lo_revenue"), ext * (100 - disc) // 100)
    assert np.array_equal(ints(lf, "lo_supplycost"), 6 * price // 10)
    od, cd = ints(lf, "lo_orderdate"), ints(lf, "lo_commitdate")
    assert ((cd - od) >= 30).all() and ((cd - od) <= 90).all()
    assert od.min() >= ssb.STARTDATE and od.max() <= ssb.ENDDATE - 151
    assert (ints(lf, "lo_custkey") % 3 != 0).all()
    # the order's total: its lines with discount and tax, in whole cents
    ok = ints(lf, "lo_orderkey")
    line = ext * (100 - disc) // 100 * (100 + tax) // 100
    _, inv = np.unique(ok, return_inverse=True)
    total = np.bincount(inv, weights=line)
    assert np.array_equal(ints(lf, "lo_ordtotalprice"), total[inv].astype(np.int64))
    # the flat table's dimension columns are the dimension rows' own
    cust = t["customer"]
    ck = ints(lf, "lo_custkey") - 1
    assert (strs(cust, "c_city")[ck] == strs(lf, "c_city")).all()
    assert (strs(cust, "c_name")[ck] == strs(lf, "c_name")).all()


def small():
    cell = load_cell(CELL, ROOT)
    return dataclasses.replace(cell, config={**cell.config, "scale": SCALE})


@pytest.mark.parametrize("kind", ["altered", "half_rows", "stale"])
def test_a_broken_path_is_not_correct(fault, kind):  # noqa: F811
    fault(kind)
    out, rc = run_cell(small(), 2**31 + 99, 2.0, False, "cpu")
    assert rc == 0 and out["attempted"] > 0
    assert out["correct"] is False, out["checks"]


def test_a_sound_run_is_correct():
    out, rc = run_cell(small(), 2**31 + 7, 2.0, True, "cpu")
    assert rc == 0 and out["correct"] is True and out["failed"] == 0, out["checks"]
    assert "groupby_roofline" not in out["metrics"]          # no card, no device interval


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_the_control_is_not_correct(seed):
    assert control_readings(small(), seed, "cpu")["fails"]
