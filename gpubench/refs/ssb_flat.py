"""The plain reference of the ``ssb_flat`` configurations: the 13 Star
Schema Benchmark queries of ``gpubench/configs/ssb_flat_sf16.json`` written
out in numpy over the generated ``lineorder_flat``, one function a query,
with no SQL engine underneath.

pyarrow only hands the columns over: integers as numpy arrays, dates as
days since 1970-01-01, strings as their dictionary codes and values, so a
string predicate is evaluated once over the distinct values.  The calendar
functions come from Python's ``datetime`` once a distinct day (``YEAR``,
``YEAR * 100 + MONTH``, ``WEEK(d, 3)`` as ISO 8601's week).  Groups are a
mixed-radix id over the keys' value ranks; sums are exact int64, as two
float64 ``np.bincount``s over the low 24 bits and the rest.

Compared number of one execution: ``mismatches``, 1 where the row count, a
key, a sum, a string, a type or the row order differs (all exact).  Rows
tied on every ORDER BY value compare as a multiset.  The control
accumulates every sum in float32 (the step below the int64 that the
configuration states) and rounds it to an integer."""

from __future__ import annotations

import datetime
import threading

import numpy as np

from gpubench.refs.tpch import _canon

NUMBERS = {"mismatches": "sum"}
TABLE = "lineorder_flat"
_EPOCH = datetime.date(1970, 1, 1)

# statement -> ORDER BY as (output position, descending) pairs
ORDER = {
    "q1.1": [], "q1.2": [], "q1.3": [],
    "q2.1": [(1, False), (2, False)], "q2.2": [(1, False), (2, False)],
    "q2.3": [(1, False), (2, False)],
    "q3.1": [(2, False), (3, True)], "q3.2": [(2, False), (3, True)],
    "q3.3": [(2, False), (3, True)], "q3.4": [(2, False), (3, True)],
    "q4.1": [(0, False), (1, False)], "q4.2": [(0, False), (1, False), (2, False)],
    "q4.3": [(0, False), (1, False), (2, False)],
}
UK = ("UNITED KI1", "UNITED KI5")


def exact_sums(gid: np.ndarray, v: np.ndarray, ng: int) -> list:
    """Exact int64 sums of ``v`` by ``gid`` (fewer than 2^29 rows)."""
    v = v.astype(np.int64)
    lo = np.bincount(gid, weights=v & 0xFFFFFF, minlength=ng)
    hi = np.bincount(gid, weights=v >> 24, minlength=ng)
    return [int(a) + (int(b) << 24) for a, b in zip(lo.tolist(), hi.tolist())]


def float32_sums(gid: np.ndarray, v: np.ndarray, ng: int, device: str) -> list:
    """The control's sums: accumulated in float32 and rounded."""
    import torch

    acc = torch.zeros(ng, dtype=torch.float32, device=device)
    acc.index_add_(0, torch.from_numpy(gid).to(device),
                   torch.from_numpy(v.astype(np.float32)).to(device))
    return [int(round(x)) for x in acc.cpu().tolist()]


class Flat:
    """``lineorder_flat``'s columns as numpy arrays, each read once."""

    def __init__(self, table):
        self.t = table
        self._cols: dict = {}
        self._lock = threading.RLock()      # a derived column reads others

    def _once(self, key, make):
        with self._lock:
            if key not in self._cols:
                self._cols[key] = make()
            return self._cols[key]

    def ints(self, name: str) -> np.ndarray:
        def make():
            c = self.t.column(name)
            if str(c.type).startswith("date"):
                c = c.cast("int32")
            return c.to_numpy()
        return self._once(name, make)

    def strings(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """(each row's rank among the column's distinct values, the values)."""
        def make():
            c = self.t.column(name).combine_chunks()
            if not str(c.type).startswith("dictionary"):
                c = c.dictionary_encode()
            values = np.asarray(c.dictionary.to_pylist(), dtype=object)
            uniq, inv = np.unique(values.astype(str), return_inverse=True)
            codes = c.indices.to_numpy(zero_copy_only=False)
            return inv.reshape(-1).astype(np.int32)[codes], uniq.astype(object)
        return self._once(("s", name), make)

    def where(self, name: str, pred) -> np.ndarray:
        """Rows whose string satisfies ``pred`` (evaluated once a value)."""
        codes, values = self.strings(name)
        ok = np.fromiter((bool(pred(v)) for v in values), bool, len(values))
        return ok[codes]

    def calendar(self, part: str) -> np.ndarray:
        """``year``, ``yyyymm`` or ``isoweek`` of each row's ``lo_orderdate``."""
        def make():
            days = self.ints("lo_orderdate")
            lo, hi = int(days.min()), int(days.max())
            dates = [_EPOCH + datetime.timedelta(days=d) for d in range(lo, hi + 1)]
            table = np.asarray([d.year if part == "year" else
                                d.year * 100 + d.month if part == "yyyymm" else
                                d.isocalendar()[1] for d in dates], np.int32)
            return table[days - lo]
        return self._once(("cal", part), make)


class Queries:
    """One method a query -> the rows, each a tuple of Python values."""

    def __init__(self, f: Flat, sums):
        self.f = f
        self.sums = sums            # (gid, values, slots) -> a sum a slot

    def _scalar(self, m: np.ndarray) -> list:
        f = self.f
        if not m.any():
            return [(None,)]
        v = f.ints("lo_extendedprice")[m].astype(np.int64) * f.ints("lo_discount")[m]
        return [(self.sums(np.zeros(len(v), np.int64), v, 1)[0],)]

    def _between(self, name: str, lo: int, hi: int) -> np.ndarray:
        x = self.f.ints(name)
        return (x >= lo) & (x <= hi)

    def q1_1(self):
        f = self.f
        return self._scalar((f.calendar("year") == 1993) & self._between("lo_discount", 1, 3)
                            & (f.ints("lo_quantity") < 25))

    def q1_2(self):
        f = self.f
        return self._scalar((f.calendar("yyyymm") == 199401)
                            & self._between("lo_discount", 4, 6)
                            & self._between("lo_quantity", 26, 35))

    def q1_3(self):
        f = self.f
        return self._scalar((f.calendar("isoweek") == 6) & (f.calendar("year") == 1994)
                            & self._between("lo_discount", 5, 7)
                            & self._between("lo_quantity", 26, 35))

    def _group(self, m: np.ndarray, keys: list, value: np.ndarray) -> list:
        """Rows of (key values..., the group's sum) of the masked rows,
        grouped by ``keys`` (each ``year`` or a string column's name)."""
        f = self.f
        if not m.any():
            return []
        ranks, names = [], []
        for k in keys:
            if k == "year":
                y = f.calendar("year")[m]
                lo = int(y.min())
                ranks.append(y - lo)
                names.append(list(range(lo, int(y.max()) + 1)))
            else:
                codes, values = f.strings(k)
                ranks.append(codes[m])
                names.append([str(v) for v in values])
        gid = np.zeros(len(ranks[0]), np.int64)
        for r, n in zip(ranks, names):
            gid = gid * len(n) + r
        ng = int(np.prod([len(n) for n in names]))
        sums = self.sums(gid, value[m], ng)
        rows = []
        for g in np.flatnonzero(np.bincount(gid, minlength=ng)).tolist():
            key, rest = [], g
            for n in reversed(names):
                key.append(n[rest % len(n)])
                rest //= len(n)
            rows.append(tuple(reversed(key)) + (sums[g],))
        return rows

    def _revenue(self) -> np.ndarray:
        return self.f.ints("lo_revenue").astype(np.int64)

    def _profit(self) -> np.ndarray:
        return self._revenue() - self.f.ints("lo_supplycost")

    def _q2(self, m):
        # SUM(lo_revenue), year, p_brand
        return [(r[2], r[0], r[1]) for r in self._group(m, ["year", "p_brand"], self._revenue())]

    def q2_1(self):
        f = self.f
        return self._q2(f.where("p_category", lambda v: v == "MFGR#12")
                        & f.where("s_region", lambda v: v == "AMERICA"))

    def q2_2(self):
        f = self.f
        return self._q2(f.where("p_brand", lambda v: "MFGR#2221" <= v <= "MFGR#2228")
                        & f.where("s_region", lambda v: v == "ASIA"))

    def q2_3(self):
        f = self.f
        return self._q2(f.where("p_brand", lambda v: v == "MFGR#2239")
                        & f.where("s_region", lambda v: v == "EUROPE"))

    def _q3(self, m, what: str):
        # c_<what>, s_<what>, year, revenue
        return self._group(m, [f"c_{what}", f"s_{what}", "year"], self._revenue())

    def _years(self, lo: int, hi: int) -> np.ndarray:
        y = self.f.calendar("year")
        return (y >= lo) & (y <= hi)

    def q3_1(self):
        f = self.f
        return self._q3(f.where("c_region", lambda v: v == "ASIA")
                        & f.where("s_region", lambda v: v == "ASIA") & self._years(1992, 1997),
                        "nation")

    def q3_2(self):
        f = self.f
        return self._q3(f.where("c_nation", lambda v: v == "UNITED STATES")
                        & f.where("s_nation", lambda v: v == "UNITED STATES")
                        & self._years(1992, 1997), "city")

    def q3_3(self):
        f = self.f
        return self._q3(f.where("c_city", lambda v: v in UK) & f.where("s_city", lambda v: v in UK)
                        & self._years(1992, 1997), "city")

    def q3_4(self):
        f = self.f
        return self._q3(f.where("c_city", lambda v: v in UK) & f.where("s_city", lambda v: v in UK)
                        & (f.calendar("yyyymm") == 199712), "city")

    def _america(self) -> np.ndarray:
        f = self.f
        return f.where("c_region", lambda v: v == "AMERICA") \
            & f.where("s_region", lambda v: v == "AMERICA") \
            & f.where("p_mfgr", lambda v: v in ("MFGR#1", "MFGR#2"))

    def q4_1(self):
        return self._group(self._america(), ["year", "c_nation"], self._profit())

    def q4_2(self):
        return self._group(self._america() & self._years(1997, 1998),
                           ["year", "s_nation", "p_category"], self._profit())

    def q4_3(self):
        f = self.f
        m = f.where("s_nation", lambda v: v == "UNITED STATES") & self._years(1997, 1998) \
            & f.where("p_category", lambda v: v == "MFGR#14")
        return self._group(m, ["year", "s_city", "p_brand"], self._profit())


def _order_key(row: tuple, order: list) -> tuple:
    return tuple(-row[i] if desc else row[i] for i, desc in order)


def _same(a, b) -> bool:
    return type(a) is type(b) and a == b


class Reference:
    def __init__(self, config: dict, tables: dict, device: str):
        f = Flat(tables[TABLE])
        self._q = {False: Queries(f, exact_sums),
                   True: Queries(f, lambda g, v, n: float32_sums(g, v, n, device))}
        self._answers: dict = {}
        self._lock = threading.Lock()

    def answer(self, stmt, control: bool = False) -> list:
        key = (stmt.name, control)
        if key not in self._answers:
            q = getattr(self._q[control], stmt.name.replace(".", "_"))
            order = ORDER[stmt.name]
            rows = q()
            if order:
                rows = sorted(rows, key=lambda r: (_order_key(r, order), _canon(r)))
            with self._lock:
                self._answers[key] = rows
        return self._answers[key]

    def compare(self, stmt, got: list, want: list) -> dict:
        """The compared numbers of one execution, ``got`` against the
        reference's rows ``want``."""
        bad = {"mismatches": 1}
        if len(got) != len(want) or any(len(g) != len(w) for g, w in zip(got, want)):
            return bad
        if any(not all(_same(a, b) or (a is None and b is None) for a, b in zip(g, w))
               for g, w in zip(sorted(got, key=_canon), sorted(want, key=_canon))):
            return bad
        order = ORDER[stmt.name]
        # the multiset matches; the order has to match on the ORDER BY values
        if order and any(_order_key(g, order) != _order_key(w, order)
                         for g, w in zip(got, want)):
            return bad
        return {"mismatches": 0}
