"""The port's fulltext search against the JAX package's: the copied
``index/fulltext.py`` (tokenizers, posting lists, phrases, boolean modes,
the incremental value-space index, BM25 scores, the per-dictionary cache)
and MATCH(col) AGAINST(... [IN BOOLEAN MODE]) through SQL, in WHERE, the
select list and ORDER BY, with FULLTEXT KEY declared in CREATE TABLE or
ALTER TABLE.

The module cases run the port's copy and the JAX package's module on the
same inputs and compare their outputs exactly (masks, postings) and the
float32 scores bit for bit.  The SQL cases run each statement in a JAX
``Session`` (CPU, x64) and a port ``Session(device="cpu")``: keys and row
order exact, MATCH's FLOAT relevance within rtol 1e-6.  The cases mirror
tests/test_fulltext.py.
"""

import math

import numpy as np
import pytest

from baikaldb_tpu.column.dictionary import Dictionary as JDictionary
from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.index import fulltext as jft
from baikaldb_tpu_torch.column.dictionary import Dictionary as TDictionary
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.index import fulltext as tft

DOCS = ["the quick brown fox", "quick blue hare", "lazy brown dog", "the fox is quick",
        "apple banana", "apple cherry", "banana cherry", "durian", ""]


@pytest.mark.parametrize("text", ["Hello, World! x2", "abcd", "a", "", "Ünïcode wörds 42"])
def test_tokenizers_match_jax(text):
    assert tft.tokenize_words(text) == jft.tokenize_words(text)
    for n in (1, 2, 3):
        assert tft.tokenize_ngrams(text, n) == jft.tokenize_ngrams(text, n)


def test_postings_and_phrases_match_jax():
    ti, ji = tft.InvertedIndex.build(DOCS), jft.InvertedIndex.build(DOCS)
    for term in ("quick", "missing", "fox", "cherry", "the"):
        assert ti.term_docs(term).tolist() == ji.term_docs(term).tolist()
    for phrase in (["quick", "brown"], ["brown", "fox"], ["fox", "is", "quick"], ["dog", "x"]):
        assert ti.phrase_docs(phrase).tolist() == ji.phrase_docs(phrase).tolist()


@pytest.mark.parametrize("query,boolean", [
    ("apple banana", False), ("+apple -cherry", True), ("+apple +cherry", True),
    ('"banana cherry"', True), ("quick", False), ("+quick -fox", True), ("durian", True),
    ("-apple", True), ("nothing here", False),
])
def test_boolean_query_modes_match_jax(query, boolean):
    ti, ji = tft.InvertedIndex.build(DOCS), jft.InvertedIndex.build(DOCS)
    assert ti.query_mask(query, boolean).tolist() == ji.query_mask(query, boolean).tolist()


def test_incremental_value_space_index_matches_jax():
    ti, ji = tft.IncrementalFulltext(), jft.IncrementalFulltext()
    batches = [["red apple", "green pear"], ["green pear", "red apple"],
               ["blue fig", "green pear", "red apple"]]
    for b in batches:
        arr = np.asarray(b, object)
        assert ti.ensure(arr) == ji.ensure(arr)
    for d, q in ((["blue fig", "green pear", "red apple"], "apple fig"),
                 (["green pear"], "apple")):
        arr = np.asarray(d, object)
        assert ti.query_mask(arr, q).tolist() == ji.query_mask(arr, q).tolist()


@pytest.mark.parametrize("query,boolean", [
    ("code123", False), ("host3 event", False), ("+code7 -host3", True),
    ('"event code7"', True), ("log", False),
])
def test_bm25_scores_match_jax_bit_for_bit(query, boolean):
    rng = np.random.default_rng(2)
    values = np.sort(np.asarray([f"log line {i} event code{i % 97} host{int(rng.integers(0, 31))}"
                                 for i in range(3000)], dtype=str))
    ts = tft.IncrementalFulltext().query_scores(TDictionary(values), query, boolean)
    js = jft.IncrementalFulltext().query_scores(JDictionary(values), query, boolean)
    assert ts.dtype == js.dtype == np.float32
    assert ts.tobytes() == js.tobytes()


def test_unique_corpus_queries_are_cached_not_rebuilt():
    """After the first query builds the per-dictionary state, later queries
    do postings-only work, and the state persists on the port's
    Dictionary."""
    import time

    n = 60_000
    values = np.asarray([f"log line {i} event code{i % 997} host{i % 31}" for i in range(n)],
                        dtype=str)
    ix = tft.IncrementalFulltext()
    d = TDictionary(np.sort(values))
    t0 = time.time()
    assert (ix.query_scores(d, "code123") > 0).sum() > 0
    build_s = time.time() - t0
    t0 = time.time()
    for q in ("code7", "host3", "event", "code500 host11"):
        ix.query_scores(d, q)
    assert (time.time() - t0) / 4 < max(build_s / 10, 0.25)
    assert d._ft_state is not None and d._ft_state[0] == ix.generation


# -- MATCH ... AGAINST through SQL -----------------------------------------

class Pair:
    def __init__(self):
        self.j = JSession(JDatabase())
        self.t = TSession(TDatabase("cpu"))

    def run(self, sql):
        outs = []
        for s in (self.j, self.t):
            try:
                r = s.execute(sql)
                outs.append(("rows", r.to_pylist()) if r.arrow is not None
                            else ("affected", r.affected_rows))
            except Exception as e:     # noqa: BLE001 — compared across packages
                outs.append(("error", type(e).__name__))
        (jk, jv), (tk, tv) = outs
        assert tk == jk, (sql, outs)
        if tk == "rows":
            assert len(tv) == len(jv), (sql, outs)
            for a, b in zip(tv, jv):
                assert list(a) == list(b)
                for k in b:
                    if isinstance(b[k], float) and a[k] is not None:
                        assert math.isclose(a[k], b[k], rel_tol=1e-6), (sql, a, b)
                    else:
                        assert a[k] == b[k], (sql, a, b)
        else:
            assert tv == jv, (sql, outs)
        return tv


DOCS_SQL = ("INSERT INTO docs VALUES (1, 'TPU native analytical engine'), "
            "(2, 'row store with MVCC'), (3, 'native row codec'), (4, NULL)")


@pytest.mark.parametrize("sql", [
    "SELECT id FROM docs WHERE MATCH(body) AGAINST('native') ORDER BY id",
    "SELECT id FROM docs WHERE MATCH(body) AGAINST('+native -codec' IN BOOLEAN MODE) ORDER BY id",
    "SELECT id FROM docs WHERE MATCH(body) AGAINST('\"row store\"' IN BOOLEAN MODE)",
    "SELECT id FROM docs WHERE MATCH(body) AGAINST('native') AND id > 1",
    "SELECT id, MATCH(body) AGAINST('row') s FROM docs ORDER BY s DESC, id",
    "SELECT COUNT(*) n FROM docs WHERE MATCH(body) AGAINST('native row')",
    "SELECT id FROM docs WHERE NOT MATCH(body) AGAINST('native') ORDER BY id",
    "SELECT id FROM docs WHERE MATCH(body) AGAINST(body)",
])
def test_match_against_sql_matches_jax(sql):
    p = Pair()
    p.run("CREATE TABLE docs (id BIGINT, body TEXT)")
    p.run(DOCS_SQL)
    p.run(sql)


def test_match_against_after_dictionary_growth_with_fulltext_key():
    p = Pair()
    p.run("CREATE TABLE docs (id BIGINT, body VARCHAR(64), PRIMARY KEY (id), "
          "FULLTEXT INDEX ft_b (body))")
    p.run("SHOW CREATE TABLE docs")
    p.run("SHOW INDEX FROM docs")
    p.run("INSERT INTO docs VALUES (1, 'alpha beta'), (2, 'gamma')")
    q = "SELECT id FROM docs WHERE MATCH(body) AGAINST('beta') ORDER BY id"
    assert p.run(q) == [{"id": 1}]
    before = len(tft._WORD_INDEX.values)
    p.run("INSERT INTO docs VALUES (3, 'beta delta'), (4, 'aardvark')")
    assert [r["id"] for r in p.run(q)] == [1, 3]
    assert len(tft._WORD_INDEX.values) - before <= 2     # only the new values


def test_fulltext_key_through_alter_table():
    p = Pair()
    p.run("CREATE TABLE d2 (id BIGINT, body VARCHAR(64))")
    p.run("ALTER TABLE d2 ADD FULLTEXT INDEX (body)")
    p.run("ALTER TABLE d2 ADD FULLTEXT INDEX ft_named (body)")
    p.run("ALTER TABLE d2 ADD FULLTEXT INDEX ft_named (body)")      # exists
    p.run("ALTER TABLE d2 ADD FULLTEXT INDEX ft_bad (nope)")
    p.run("SHOW CREATE TABLE d2")
    p.run("ALTER TABLE d2 DROP INDEX ft_named")
    p.run("SHOW INDEX FROM d2")


def test_match_against_scores_in_select_list():
    p = Pair()
    p.run("CREATE TABLE rk (id BIGINT, body VARCHAR(128))")
    p.run("INSERT INTO rk VALUES (1, 'tpu tpu tpu native engine'), (2, 'tpu runtime'), "
          "(3, 'a very long document about storage engines and runtimes with one tpu "
          "mention inside'), (4, 'nothing relevant here')")
    rows = p.run("SELECT id, MATCH(body) AGAINST('tpu') sc FROM rk ORDER BY sc DESC, id")
    sc = {r["id"]: r["sc"] for r in rows}
    assert sc[4] == 0.0 and sc[1] > sc[2] > sc[3] > 0
    p.run("INSERT INTO rk VALUES (5, 'tpu zephyr'), (6, 'tpu alpha')")
    rows = p.run("SELECT id, MATCH(body) AGAINST('zephyr tpu') sc FROM rk "
                 "WHERE MATCH(body) AGAINST('zephyr tpu') ORDER BY sc DESC")
    assert rows[0]["id"] == 5


def test_match_against_boolean_mode_scoring():
    p = Pair()
    p.run("CREATE TABLE rb (id BIGINT, body VARCHAR(64))")
    p.run("INSERT INTO rb VALUES (1, 'alpha beta'), (2, 'alpha'), (3, 'beta'), "
          "(4, 'alpha beta gamma')")
    rows = p.run("SELECT id, MATCH(body) AGAINST('+alpha beta' IN BOOLEAN MODE) sc "
                 "FROM rb ORDER BY id")
    sc = {r["id"]: r["sc"] for r in rows}
    assert sc[3] == 0.0 and sc[1] > sc[2] > 0 and sc[4] > sc[2]


def test_match_against_over_seeded_comments_matches_jax():
    """MATCH over a seeded comment column (the chip's MATCH phase at a
    small size): the count and the top rows by relevance."""
    rng = np.random.default_rng(9)
    words = ["special", "requests", "deposits", "furiously", "carefully", "final",
             "pending", "ironic", "packages", "accounts", "quickly", "bold"]
    p = Pair()
    p.run("CREATE TABLE orders (o_orderkey BIGINT, o_comment VARCHAR(79))")
    rows = ", ".join(f"({i}, '{' '.join(rng.choice(words, int(rng.integers(2, 9))))}')"
                     for i in range(4000))
    p.run(f"INSERT INTO orders VALUES {rows}")
    p.run("SELECT COUNT(*) FROM orders WHERE MATCH(o_comment) AGAINST('special requests')")
    p.run("SELECT o_orderkey, MATCH(o_comment) AGAINST('+special -deposits' IN BOOLEAN MODE) "
          "AS s FROM orders ORDER BY s DESC, o_orderkey LIMIT 10")
