"""The Star Schema Benchmark's flat table on the port's normal path, on the
CPU: the 13 statements of ``gpubench/configs/ssb_flat_sf16.json`` through
``Session(device="cpu")`` held exactly to the benchmark's plain reference
(``gpubench/refs/ssb_flat.py``), the dense GROUP BY domains the planner
gives them and the route each takes on the card, and ``WEEK(d, mode)``
against Python's ``datetime``.  The table is the benchmark's generator at a
small scale with its first rows recoded so that every city, nation, region,
manufacturer, category and brand occurs, as at scale factor 16.  No JAX
here: the CUDA test of ``tests/test_torch_cuda.py`` reuses these helpers."""

import datetime
import json
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from baikaldb_tpu_torch.exec import executor
from baikaldb_tpu_torch.exec.session import Session
from baikaldb_tpu_torch.ops import hashagg
from baikaldb_tpu_torch.utils import datetime_kernels as dtk
from baikaldb_tpu_torch.utils import metrics
from baikaldb_tpu_torch.utils.flags import FLAGS, set_flag
from gpubench.core.cell import rows_of
from gpubench.core.traffic import Stmt
from gpubench.gen import ssb
from gpubench.refs import ssb_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.01
SEED = 2**31 + 24


def config() -> dict:
    with open(os.path.join(ROOT, "gpubench", "configs", "ssb_flat_sf16.json")) as f:
        return json.load(f)


def full_domain_table(scale: float = SCALE, seed: int = SEED) -> pa.Table:
    """``lineorder_flat`` at ``scale`` whose first 1,000 rows hold every
    brand (so every category and manufacturer) and every customer and
    supplier city (so every nation and region), consistently derived."""
    t = ssb.generate(scale, seed)["lineorder_flat"]
    n = t.num_rows
    i = np.arange(n)
    head = i < 1000
    region_of = np.asarray([r for _, r in ssb.NATIONS], np.int32)
    recode = {}
    brand = np.where(head, i % 1000, t.column("p_brand").combine_chunks().indices)
    recode.update(p_brand=brand, p_category=brand // 40, p_mfgr=brand // 200)
    # customer city i % 250 beside supplier cities 0, 4, -4 and 1 further
    # on, so that Q3.3's pairs of UNITED KI1 and UNITED KI5 occur
    shift = np.asarray([0, 4, 246, 1])[np.minimum(i // 250, 3)]
    for side, c in (("c", i % 250), ("s", (i + shift) % 250)):
        city = np.where(head, c, t.column(f"{side}_city").combine_chunks().indices)
        recode.update({f"{side}_city": city, f"{side}_nation": city // 10,
                       f"{side}_region": region_of[city // 10]})
    for name, codes in recode.items():
        d = t.column(name).combine_chunks().dictionary
        t = t.set_column(t.column_names.index(name), name, pa.DictionaryArray.from_arrays(
            pa.array(codes.astype(np.int32)), d))
    return t


def session(table: pa.Table, device: str = "cpu") -> Session:
    cfg = config()
    s = Session(device=device)
    for k, v in cfg["flags"].items():
        s.execute(f"SET GLOBAL {k} = {v}")
    s.execute(cfg["tables"]["lineorder_flat"])
    s.load_arrow("lineorder_flat", table)
    return s


def check_statement(s: Session, ref, name: str) -> list:
    """The statement's rows from ``s``, asserted equal to the reference's."""
    st = Stmt(name, config()["statements"][name])
    got = rows_of(s.execute(st.sql).arrow)
    want = ref.answer(st)
    assert ref.compare(st, got, want) == {"mismatches": 0}, (name, got[:3], want[:3])
    return got


@pytest.fixture(scope="module")
def flat():
    old = FLAGS.streaming_scan
    t = full_domain_table()
    yield t, session(t), ssb_flat.Reference(config(), {"lineorder_flat": t}, "cpu")
    set_flag("streaming_scan", old)


@pytest.mark.parametrize("name", list(ssb_flat.ORDER))
def test_statement_equals_the_reference(flat, name):
    _, s, ref = flat
    rows = check_statement(s, ref, name)
    if name != "q3.4":          # one month of two cities: empty at this size
        assert rows and rows[0][0] is not None


def test_the_control_differs_from_the_reference(flat):
    _, _, ref = flat
    bad = 0
    for name, sql in config()["statements"].items():
        st = Stmt(name, sql)
        bad += ref.compare(st, ref.answer(st, control=True), ref.answer(st))["mismatches"]
    assert bad >= 9


# statement -> (dense domains, route on the card); Q1.x sum without keys
ROUTES = {
    "q2.1": ([7, 1000], "wide"), "q2.2": ([7, 1000], "wide"), "q2.3": ([7, 1000], "wide"),
    "q3.1": ([25, 25, 7], "wide"), "q3.2": ([250, 250, 7], "wide"),
    "q3.3": ([250, 250, 7], "wide"), "q3.4": ([250, 250, 7], "wide"),
    "q4.1": ([7, 25], "segment"), "q4.2": ([7, 25, 25], "wide"),
    "q4.3": ([7, 250, 1000], "wide"),
}


def test_dense_domains_and_routes(flat, monkeypatch):
    _, s, _ = flat
    seen = []
    real = executor.group_aggregate_dense

    def spy(batch, key_names, domains, specs):
        ng = hashagg.dense_num_groups(domains)
        seen.append((list(domains), hashagg.dense_route(batch, specs, ng, device="cuda")))
        return real(batch, key_names, domains, specs)

    monkeypatch.setattr(executor, "group_aggregate_dense", spy)
    for name, sql in config()["statements"].items():
        seen.clear()
        s.execute(sql)
        assert seen == ([ROUTES[name]] if name in ROUTES else []), name


def _boundary_days() -> list:
    """Dec 29 to Jan 4 around every new year from 1992 to 1999."""
    return [datetime.date(y, 12, 29) + datetime.timedelta(days=k)
            for y in range(1991, 1999) for k in range(7)]


def week_of(d: datetime.date, mode: int) -> int:
    """MySQL's WEEK(d, mode) for modes 0 and 3 from Python's calendar."""
    return int(d.strftime("%U")) if mode == 0 else d.isocalendar()[1]


@pytest.mark.parametrize("mode", [0, 3])
def test_week_kernel_matches_datetime(mode):
    epoch = datetime.date(1970, 1, 1)
    days = [datetime.date(1990, 1, 1) + datetime.timedelta(days=k) for k in range(3700)]
    got = dtk.week(torch.tensor([(d - epoch).days for d in days], dtype=torch.int32), mode)
    assert got.tolist() == [week_of(d, mode) for d in days]


def week_rows(device: str = "cpu") -> tuple[list, list]:
    """(WEEK(d, 3), WEEK(d, 0) and WEEK(d) through SQL, from datetime) over
    the year boundaries."""
    days = _boundary_days()
    s = Session(device=device)
    s.execute("CREATE TABLE wk (d DATE)")
    s.load_arrow("wk", pa.table({"d": pa.array(days, pa.date32())}))
    got = rows_of(s.execute("SELECT d, WEEK(d, 3), WEEK(d, 0), WEEK(d) FROM wk ORDER BY d").arrow)
    want = [(d, week_of(d, 3), week_of(d, 0), week_of(d, 0)) for d in days]
    return got, want


def test_week_through_sql_matches_datetime():
    got, want = week_rows()
    assert got == want


def test_a_dictionary_encoded_load_answers_as_plain_strings():
    """A string column loaded as an Arrow dictionary array (duplicate and
    unused dictionary entries, NULLs, two loads with different
    dictionaries) stays encoded in the store and answers every read and
    write as the same rows loaded as plain strings."""
    rng = np.random.default_rng(24)
    words = ["b", "a", "c", "a", "zz", "d"]            # "a" twice, "zz" unused

    def part(n, words):
        codes = pa.array(rng.integers(0, len(words) - 2, n).astype(np.int32),
                         mask=rng.random(n) < 0.1)
        return {"k": pa.DictionaryArray.from_arrays(codes, pa.array(words)),
                "v": rng.integers(-50, 50, n).astype(np.int32)}

    loads = [part(300, words), part(200, ["d", "e", "a"])]
    sessions = []
    for encoded in (True, False):
        s = Session(device="cpu")
        s.execute("CREATE TABLE t (k VARCHAR(4), v INT)")
        for p in loads:
            t = pa.table(p)
            s.load_arrow("t", t if encoded else t.cast(pa.schema([("k", pa.string()),
                                                                  ("v", pa.int32())])))
        sessions.append(s)
    store = sessions[0].db.stores[next(iter(sessions[0].db.stores))]
    assert pa.types.is_dictionary(store.regions[0].data.schema.field("k").type)
    reads = ["SELECT k, COUNT(*), SUM(v) FROM t GROUP BY k ORDER BY k",
             "SELECT COUNT(*) FROM t WHERE k = 'a'",
             "SELECT k, v FROM t WHERE k > 'b' ORDER BY v, k",
             "SELECT COUNT(DISTINCT k) FROM t", "SELECT k FROM t WHERE k IS NULL LIMIT 3"]
    writes = ["INSERT INTO t VALUES ('q', 5), (NULL, 6)", "UPDATE t SET v = v + 1 WHERE k = 'b'",
              "DELETE FROM t WHERE k = 'c'"]
    for w in [None] + writes:
        if w is not None:
            for s in sessions:
                s.execute(w)
        for q in reads:
            a, b = (rows_of(s.execute(q).arrow) for s in sessions)
            assert a == b, (w, q)
    # a streamed scan stages the regions in chunks with one dictionary
    saved = {k: getattr(FLAGS, k) for k in ("streaming_scan", "streaming_min_rows",
                                            "streaming_chunk_rows")}
    try:
        for k, v in (("streaming_scan", True), ("streaming_min_rows", 1),
                     ("streaming_chunk_rows", 64)):
            set_flag(k, v)
        q = "SELECT k, COUNT(*), SUM(v) FROM t WHERE v > -40 GROUP BY k ORDER BY k"
        chunks = metrics.stream_chunks.value
        a, b = (rows_of(s.execute(q).arrow) for s in sessions)
        assert a == b and len(a) > 3 and metrics.stream_chunks.value > chunks
    finally:
        for k, v in saved.items():
            set_flag(k, v)
