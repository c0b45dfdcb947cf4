"""sysbench ``oltp_read_write`` over the port, with a plain replay reference.

BASELINE.json config #1 is "the 1M-row sysbench table".  The schema is
sysbench's ``oltp_common.lua`` (``sbtest1``: ``id`` primary key, ``k`` with
secondary index ``k_1``, ``c`` CHAR(120), ``pad`` CHAR(60)); ``k`` is uniform
in [1, rows], ``c`` is 10 groups and ``pad`` 5 groups of 11 random digits
joined by ``-``, all from the seed with numpy (``table``).

``Workload`` draws transactions at ``oltp_read_write``'s defaults: 10 point
selects, one simple, one SUM, one ORDER BY and one DISTINCT range of 100
ids (``RANGE_FORMS``: sysbench's ``BETWEEN`` by default), one index update
(``k = k + 1``), one non-index update (``c = ...``) and one DELETE + INSERT
of the same id, each transaction in BEGIN ... COMMIT.  ``Reference`` replays the same statements over numpy arrays (one
slot per id) and gives every SELECT's expected rows; ``Driver`` runs the
transactions through a session and checks them statement by statement.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

DDL = ("CREATE TABLE sbtest1 (id INTEGER NOT NULL, k INTEGER NOT NULL DEFAULT '0', "
       "c CHAR(120) NOT NULL DEFAULT '', pad CHAR(60) NOT NULL DEFAULT '', "
       "PRIMARY KEY (id), KEY k_1 (k))")

POINT_SELECTS = 10
RANGE_SIZE = 100
# the range predicate: sysbench's own, or the same rows as two comparisons
# (the form whose bounds a selector reads for region zone maps)
RANGE_FORMS = {"between": "id BETWEEN {} AND {}", "comparisons": "id >= {} AND id <= {}"}


def digits(rng, n: int, groups: int) -> np.ndarray:
    """n strings of ``groups`` groups of 11 random digits joined by '-'
    (sysbench's templates), as a numpy byte-string array."""
    width = groups * 12 - 1
    out = np.full((n, groups, 12), ord("-"), np.uint8)
    out[:, :, :11] = rng.integers(0, 10, (n, groups, 11), dtype=np.uint8) + ord("0")
    return np.ascontiguousarray(out.reshape(n, groups * 12)[:, :width]).view(f"S{width}").ravel()


def table(rows: int, seed: int) -> pa.Table:
    """The sbtest1 rows, ids 1..rows."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "id": np.arange(1, rows + 1, dtype=np.int32),
        "k": rng.integers(1, rows + 1, rows, dtype=np.int32),
        "c": pa.array(digits(rng, rows, 10)).cast(pa.string()),
        "pad": pa.array(digits(rng, rows, 5)).cast(pa.string()),
    })


class Reference:
    """The table as numpy arrays indexed by id, and the answer of each
    statement kind."""

    def __init__(self, t: pa.Table):
        n = t.num_rows
        self.rows = n
        self.k = np.zeros(n + 1, np.int64)
        self.k[1:] = t.column("k").to_numpy()
        self.c = np.empty(n + 1, object)
        self.c[1:] = t.column("c").to_pylist()
        self.pad = np.empty(n + 1, object)
        self.pad[1:] = t.column("pad").to_pylist()

    def span(self, lo: int) -> slice:
        return slice(lo, min(lo + RANGE_SIZE - 1, self.rows) + 1)

    def expect(self, kind: str, args: tuple):
        """The rows a SELECT must return (a sorted list where the statement
        has no ORDER BY)."""
        if kind == "point":
            return [{"c": self.c[args[0]]}]
        sl = self.span(args[0])
        if kind == "simple_range":
            return sorted(self.c[sl])
        if kind == "sum_range":
            return [{"s": int(self.k[sl].sum())}]
        if kind == "order_range":
            return [{"c": v} for v in sorted(self.c[sl])]
        if kind == "distinct_range":
            return [{"c": v} for v in sorted(set(self.c[sl]))]
        raise ValueError(kind)

    def apply(self, kind: str, args: tuple) -> None:
        if kind == "index_update":
            self.k[args[0]] += 1
        elif kind == "non_index_update":
            self.c[args[0]] = args[1]
        elif kind == "insert":
            i, k, c, pad = args
            self.k[i], self.c[i], self.pad[i] = k, c, pad


class Workload:
    """``oltp_read_write`` transactions from a seed: each is a list of
    (kind, sql, args); ``delete`` is followed by the ``insert`` of its id."""

    def __init__(self, rows: int, seed: int, range_form: str = "between"):
        self.rows = rows
        self.rng = np.random.default_rng(seed)
        self.range_form = range_form

    def _id(self) -> int:
        return int(self.rng.integers(1, self.rows + 1))

    def transaction(self) -> list[tuple]:
        out = []
        for _ in range(POINT_SELECTS):
            i = self._id()
            out.append(("point", f"SELECT c FROM sbtest1 WHERE id={i}", (i,)))
        where = RANGE_FORMS[self.range_form]
        for kind, sql in (("simple_range", "SELECT c FROM sbtest1 WHERE {}"),
                          ("sum_range", "SELECT SUM(k) s FROM sbtest1 WHERE {}"),
                          ("order_range", "SELECT c FROM sbtest1 WHERE {} ORDER BY c"),
                          ("distinct_range",
                           "SELECT DISTINCT c FROM sbtest1 WHERE {} ORDER BY c")):
            i = self._id()
            out.append((kind, sql.format(where.format(i, i + RANGE_SIZE - 1)), (i,)))
        i = self._id()
        out.append(("index_update", f"UPDATE sbtest1 SET k=k+1 WHERE id={i}", (i,)))
        i = self._id()
        c = digits(self.rng, 1, 10)[0].decode()
        out.append(("non_index_update", f"UPDATE sbtest1 SET c='{c}' WHERE id={i}", (i, c)))
        i = self._id()
        out.append(("delete", f"DELETE FROM sbtest1 WHERE id={i}", (i,)))
        k = int(self.rng.integers(1, self.rows + 1))
        c = digits(self.rng, 1, 10)[0].decode()
        pad = digits(self.rng, 1, 5)[0].decode()
        out.append(("insert", f"INSERT INTO sbtest1 (id, k, c, pad) VALUES "
                              f"({i}, {k}, '{c}', '{pad}')", (i, k, c, pad)))
        return out


def check(kind: str, got: list, want) -> None:
    """Hold one statement's rows to the reference's."""
    if kind == "simple_range":
        got = sorted(r["c"] for r in got)
    elif kind == "sum_range":
        got = [{"s": None if r["s"] is None else int(r["s"])} for r in got]
    if got != want:
        raise AssertionError(f"sysbench {kind}: {str(got)[:200]} != {str(want)[:200]}")


class Driver:
    """Transactions from ``Workload`` through a session over a loaded
    sbtest1 (built by ``table(rows, seed)``), every SELECT checked against
    the replay ``reference``.  ``run`` may be called again to continue."""

    def __init__(self, session, rows: int, seed: int, range_form: str = "between"):
        self.session = session
        self.reference = Reference(table(rows, seed))
        self.workload = Workload(rows, seed + 1, range_form)
        self.statements = 0

    def run(self, transactions: int, timer=None) -> None:
        """``timer(kind, fn)`` wraps each statement (default: call it)."""
        s, ref = self.session, self.reference
        timer = timer or (lambda kind, fn: fn())
        for _ in range(transactions):
            timer("begin", lambda: s.execute("BEGIN"))
            for kind, sql, args in self.workload.transaction():
                if kind in ("point", "simple_range", "sum_range", "order_range",
                            "distinct_range"):
                    want = ref.expect(kind, args)
                    check(kind, timer(kind, lambda: s.query(sql)), want)
                else:
                    res = timer(kind, lambda: s.execute(sql))
                    if res.affected_rows != 1:
                        raise AssertionError(f"sysbench {kind} affected "
                                             f"{res.affected_rows}: {sql}")
                    ref.apply(kind, args)
                self.statements += 1
            timer("commit", lambda: s.execute("COMMIT"))
