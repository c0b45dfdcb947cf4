"""The plain reference answers as the port's ``Session(device="cpu")`` does
at a small size (TPC-H at SF 0.05), and its control does not."""

import json
import os

import numpy as np
import pytest

from gpubench.core.cell import rows_of
from gpubench.core.traffic import Stmt
from gpubench.gen import tpch as tpch_gen
from gpubench.refs import tpch as tpch_ref
from gpubench.tests.conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "gpubench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _session(config, tables):
    from baikaldb_tpu_torch.exec.session import Session

    s = Session(device="cpu")
    for k, v in config["flags"].items():
        s.execute(f"SET GLOBAL {k} = {v}")
    for name, ddl in config["tables"].items():
        s.execute(ddl)
        s.load_arrow(name, tables[name])
    return s


# SF 0.05: below about SF 0.41 q15's GROUP BY over l_suppkey fits the dense
# kernels' 4096 slots, whose sums are float32 by contract; at SF 0.01 q11's
# over ps_partkey does too, and its ORDER BY on that sum then reads the
# float32 rounding as an order.  At SF1 neither fits.
TPCH_SCALE = 0.05
TPCH_REL = 1e-6


@pytest.fixture(scope="module")
def tpch_setup():
    cfg = _config("tpch_sf1")
    tables = tpch_gen.tables({"scale": TPCH_SCALE}, 11)
    s = _session(cfg, tables)
    yield cfg, tpch_ref.Reference(cfg, tables, "cpu"), s
    s.execute("SET GLOBAL streaming_scan = 1")


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_tpch_reference_equals_the_port(tpch_setup, q):
    cfg, ref, s = tpch_setup
    st = Stmt(q, cfg["statements"][q])
    n = ref.compare(st, rows_of(s.execute(st.sql).arrow), ref.answer(st))
    assert n["mismatches"] == 0 and n["rel_err"] <= TPCH_REL, n


def test_tpch_control_fails(tpch_setup):
    cfg, ref, _ = tpch_setup
    bad = 0
    for q in cfg["statements"]:
        st = Stmt(q, cfg["statements"][q])
        n = ref.compare(st, ref.answer(st, control=True), ref.answer(st))
        bad += n["mismatches"] > 0 or n["rel_err"] > cfg["limits"]["rel_err"]
    assert bad >= 11


def test_like_patterns():
    import pyarrow as pa

    t = {"t": pa.table({"s": ["quickly special bold requests", "special", "requests special",
                              "PROMO BRUSHED TIN", "BRASS TIN", "x%y"]})}
    d = tpch_ref.Data(t)
    assert d.like("t", "s", "%special%requests%").tolist() == [True] + [False] * 5
    assert d.like("t", "s", "PROMO%").tolist() == [False] * 3 + [True, False, False]
    assert d.like("t", "s", "%BRASS").tolist() == [False] * 6
    assert d.like("t", "s", "_pecial").tolist() == [False, True] + [False] * 4


def test_minmax_by():
    lo, hi = tpch_ref.minmax_by(np.array([3, 1, 3, 1, 1]), np.array([5, 2, 7, 9, 4]), 5)
    assert lo[1] == 2 and hi[1] == 9 and lo[3] == 5 and hi[3] == 7 and hi[0] == -1
