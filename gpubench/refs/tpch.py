"""The plain reference of the ``tpch`` configurations: the 22 queries of
``gpubench/configs/tpch_sf1.json`` written out in numpy over the generated
tables, one function a query, with no SQL engine underneath.

pyarrow only hands the columns over: numbers and dates as numpy arrays
(dates as days since 1970-01-01), strings dictionary-encoded, so that a
string predicate is evaluated once over the distinct values.  Joins look
keys up in sorted unique keys (``np.searchsorted``), groups are
``np.unique`` over the grouping keys and ``np.bincount`` sums.

Compared numbers of one execution: ``mismatches`` (1 where the row count,
a key, a count, a string, a date or the row order differs; these are
exact) and ``rel_err``, the largest relative gap of a floating value from
the reference's float64 one.  Rows tied on every ORDER BY value compare as
a multiset, and where LIMIT cuts through a tied run only its ORDER BY
values compare (the rule of the port's ``models/parity.py``, copied).  The
control computes every DOUBLE column and expression in float32 and rounds
each result to float32 (the step below the float64 that the configuration
states)."""

from __future__ import annotations

import datetime
import math

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

NUMBERS = {"mismatches": "sum", "rel_err": "max"}
TIE_RTOL = 1e-9
_EPOCH = datetime.date(1970, 1, 1)

# query -> (output positions its ORDER BY sorts by, whether it has a LIMIT)
ORDER = {
    "q1": ([0, 1], False), "q2": ([0, 2, 1, 3], True), "q3": ([1, 2], True),
    "q4": ([0], False), "q5": ([1], False), "q6": (None, False), "q7": ([0, 1, 2], False),
    "q8": ([0], False), "q9": ([0, 1], False), "q10": ([2], True), "q11": ([1], False),
    "q12": ([0], False), "q13": ([1, 0], False), "q14": (None, False),
    "q15": ([0], False), "q16": ([3, 0, 1, 2], False), "q17": (None, False),
    "q18": ([4, 3], True), "q19": (None, False), "q20": ([0], False),
    "q21": ([1, 0], True), "q22": ([0], False),
}


def day(iso: str) -> int:
    y, m, d = map(int, iso.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


def to_date(days: int) -> datetime.date:
    return _EPOCH + datetime.timedelta(days=int(days))


def year(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970


class Data:
    """The generated tables as numpy columns; ``f`` is the float type the
    DOUBLE columns and expressions are computed in."""

    def __init__(self, tables: dict, f=np.float64):
        self.t = tables
        self.f = f
        self._cols: dict = {}
        self._sorted: dict = {}

    def n(self, table: str) -> int:
        return self.t[table].num_rows

    def col(self, table: str, name: str) -> np.ndarray:
        k = (table, name)
        if k not in self._cols:
            c = self.t[table].column(name)
            if pa.types.is_date(c.type):
                a = c.cast(pa.int32()).to_numpy()
            elif pa.types.is_floating(c.type):
                a = c.to_numpy().astype(self.f)
            elif pa.types.is_integer(c.type):
                a = c.to_numpy()
            else:
                codes, values = self._encoded(table, name)
                a = (codes, np.asarray(values.to_pylist(), dtype=object))
            self._cols[k] = a
        return self._cols[k]

    def _encoded(self, table: str, name: str) -> tuple[np.ndarray, pa.Array]:
        """A string column's codes and its distinct values (pyarrow)."""
        k = (table, name, "encoded")
        if k not in self._cols:
            d = self.t[table].column(name).combine_chunks().dictionary_encode()
            self._cols[k] = (d.indices.to_numpy(zero_copy_only=False).astype(np.int64),
                             d.dictionary)
        return self._cols[k]

    def match(self, table: str, name: str, pred) -> np.ndarray:
        """Rows whose string satisfies ``pred`` (evaluated once a value)."""
        codes, values = self.col(table, name)
        ok = np.fromiter((bool(pred(v)) for v in values), bool, len(values))
        return ok[codes]

    def eq(self, table: str, name: str, value: str) -> np.ndarray:
        return self.match(table, name, lambda v: v == value)

    def isin(self, table: str, name: str, values) -> np.ndarray:
        vs = set(values)
        return self.match(table, name, lambda v: v in vs)

    def like(self, table: str, name: str, pattern: str) -> np.ndarray:
        """SQL LIKE (``%``, ``_``, case kept), once a distinct value."""
        codes, values = self._encoded(table, name)
        return pc.match_like(values, pattern).to_numpy(zero_copy_only=False)[codes]

    def strs(self, table: str, name: str, rows: np.ndarray) -> np.ndarray:
        codes, values = self.col(table, name)
        return values[codes[rows]]

    def lookup(self, keys: np.ndarray, probe: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Row of each probe key in ``keys`` (unique; a column of this
        Data, whose sort is kept) -> (index, found).  A whole column probed
        again is answered from the first time."""
        done = self._sorted.get((id(keys), id(probe)))
        if done is not None and done[0] is keys and done[1] is probe:
            return done[2]
        hit = self._sorted.get(id(keys))
        if hit is None or hit[0] is not keys:
            order = np.argsort(keys, kind="stable")
            hit = self._sorted[id(keys)] = (keys, order, keys[order])
        _, order, sk = hit
        pos = np.searchsorted(sk, probe)
        pos_c = np.minimum(pos, len(sk) - 1)
        found = (pos < len(sk)) & (sk[pos_c] == probe)
        out = order[pos_c], found
        if any(probe is c for c in tuple(self._cols.values())):
            self._sorted[(id(keys), id(probe))] = (keys, probe, out)
        return out


def member(probe: np.ndarray, keys: np.ndarray) -> np.ndarray:
    return np.isin(probe, keys)


def groups(*keys: np.ndarray) -> tuple[np.ndarray, list]:
    """-> (group id of each row, each key column's value a group), groups in
    the order of their keys."""
    if len(keys[0]) == 0:
        return np.zeros(0, np.int64), [k[:0] for k in keys]
    uniq, codes = zip(*(np.unique(k, return_inverse=True) for k in keys))
    if len(keys) == 1:
        return codes[0].reshape(-1), [uniq[0]]
    combined = np.zeros(len(keys[0]), np.int64)
    for u, c in zip(uniq, codes):
        combined = combined * len(u) + c.reshape(-1)
    ucomb, gid = np.unique(combined, return_inverse=True)
    out = []
    for u in reversed(uniq):
        out.append(u[ucomb % len(u)])
        ucomb = ucomb // len(u)
    return gid.reshape(-1), out[::-1]


def minmax_by(keys: np.ndarray, vals: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Smallest and largest value of each key in ``[0, n)`` (a key with no
    row: the int64 extremes' sentinels, max -1)."""
    lo = np.full(n, np.iinfo(np.int64).max)
    hi = np.full(n, -1, np.int64)
    if len(keys):
        o = np.argsort(keys, kind="stable")
        k, v = keys[o], vals[o].astype(np.int64)
        starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
        lo[k[starts]] = np.minimum.reduceat(v, starts)
        hi[k[starts]] = np.maximum.reduceat(v, starts)
    return lo, hi


def gsum(gid: np.ndarray, x: np.ndarray, ng: int) -> np.ndarray:
    return np.bincount(gid, weights=x.astype(np.float64), minlength=ng)


def gcount(gid: np.ndarray, ng: int) -> np.ndarray:
    return np.bincount(gid, minlength=ng)


def top(rows: list, keys, limit: int | None = None) -> list:
    """Rows sorted by ``keys`` (a function of a row) and cut to ``limit``."""
    rows = sorted(rows, key=keys)
    return rows if limit is None else rows[:limit]


class Queries:
    """One method a query -> the rows, each a tuple of Python values."""

    def __init__(self, d: Data, out):
        self.d = d
        self.out = out          # the float a result holds (float32 in the control)

    def _revenue(self, rows=None):
        d = self.d
        ext, disc = d.col("lineitem", "l_extendedprice"), d.col("lineitem", "l_discount")
        if rows is None:
            return ext * (d.f(1) - disc)
        return ext[rows] * (d.f(1) - disc[rows])

    def _nation_region(self) -> tuple[np.ndarray, np.ndarray]:
        d = self.d
        rname = d.strs("region", "r_name", np.arange(d.n("region")))
        rkey = d.col("region", "r_regionkey")
        nreg = d.col("nation", "n_regionkey")
        idx, _ = d.lookup(rkey, nreg)
        return d.col("nation", "n_nationkey"), rname[idx]

    def _nation_names(self) -> tuple[np.ndarray, np.ndarray]:
        d = self.d
        return d.col("nation", "n_nationkey"), d.strs("nation", "n_name", np.arange(d.n("nation")))

    def q1(self):
        d = self.d
        li = "lineitem"
        m = d.col(li, "l_shipdate") <= day("1998-09-02")
        rf, rfv = d.col(li, "l_returnflag")
        ls, lsv = d.col(li, "l_linestatus")
        gid, (kr, kl) = groups(rf[m], ls[m])
        kr, kl = rfv[kr], lsv[kl]
        ng = len(kr)
        qty = d.col(li, "l_quantity")[m]
        ext = d.col(li, "l_extendedprice")[m]
        disc = d.col(li, "l_discount")[m]
        tax = d.col(li, "l_tax")[m]
        one = d.f(1)
        dp = ext * (one - disc)
        ch = ext * (one - disc) * (one + tax)
        cnt = gcount(gid, ng)
        s = [gsum(gid, x, ng) for x in (qty, ext, dp, ch, disc)]
        rows = [(str(kr[i]), str(kl[i]), self.out(s[0][i]), self.out(s[1][i]),
                 self.out(s[2][i]), self.out(s[3][i]), self.out(s[0][i] / cnt[i]),
                 self.out(s[1][i] / cnt[i]), self.out(s[4][i] / cnt[i]), int(cnt[i]))
                for i in range(ng)]
        return top(rows, lambda r: (r[0], r[1]))

    def q2(self):
        d = self.d
        nk, rn = self._nation_region()
        eu_nations = nk[rn == "EUROPE"]
        s_eu = member(d.col("supplier", "s_nationkey"), eu_nations)
        ps_part, ps_supp = d.col("partsupp", "ps_partkey"), d.col("partsupp", "ps_suppkey")
        cost = d.col("partsupp", "ps_supplycost")
        sidx, sfound = d.lookup(d.col("supplier", "s_suppkey"), ps_supp)
        eu = sfound & s_eu[sidx]
        # the correlated MIN over the part's European suppliers
        gid, (parts,) = groups(ps_part[eu])
        mins = np.full(len(parts), np.inf)
        np.minimum.at(mins, gid, cost[eu].astype(np.float64))
        pkeys = d.col("part", "p_partkey")
        pok = (d.col("part", "p_size") == 15) & d.like("part", "p_type", "%BRASS")
        pidx, pfound = d.lookup(pkeys, ps_part)
        cand = np.nonzero(eu & pfound & pok[np.where(pfound, pidx, 0)])[0]
        midx, _ = d.lookup(parts, ps_part[cand])
        cand = cand[cost[cand].astype(np.float64) == mins[midx]]
        si = sidx[cand]
        pi = pidx[cand]
        nkeys, nnames = self._nation_names()
        ni, _ = d.lookup(nkeys, d.col("supplier", "s_nationkey")[si])
        rows = list(zip((self.out(x) for x in d.col("supplier", "s_acctbal")[si]),
                        d.strs("supplier", "s_name", si), nnames[ni],
                        (int(x) for x in pkeys[pi]), d.strs("part", "p_mfgr", pi),
                        d.strs("supplier", "s_address", si), d.strs("supplier", "s_phone", si),
                        d.strs("supplier", "s_comment", si)))
        return top(rows, lambda r: (-r[0], r[2], r[1], r[3]), 100)

    def q3(self):
        d = self.d
        cust_ok = d.eq("customer", "c_mktsegment", "BUILDING")
        ck = d.col("customer", "c_custkey")
        od = d.col("orders", "o_orderdate")
        ci, cf = d.lookup(ck, d.col("orders", "o_custkey"))
        o_ok = cf & cust_ok[ci] & (od < day("1995-03-15"))
        oi, of = d.lookup(d.col("orders", "o_orderkey"), d.col("lineitem", "l_orderkey"))
        m = of & o_ok[oi] & (d.col("lineitem", "l_shipdate") > day("1995-03-15"))
        rows_i = np.nonzero(m)[0]
        gid, (keys,) = groups(d.col("lineitem", "l_orderkey")[rows_i])
        rev = gsum(gid, self._revenue(rows_i), len(keys))
        oidx, _ = d.lookup(d.col("orders", "o_orderkey"), keys)
        rows = [(int(keys[i]), self.out(rev[i]), to_date(od[oidx[i]]),
                 int(d.col("orders", "o_shippriority")[oidx[i]])) for i in range(len(keys))]
        return top(rows, lambda r: (-r[1], r[2]), 10)

    def q4(self):
        d = self.d
        late = d.col("lineitem", "l_commitdate") < d.col("lineitem", "l_receiptdate")
        has = np.unique(d.col("lineitem", "l_orderkey")[late])
        od = d.col("orders", "o_orderdate")
        m = (od >= day("1993-07-01")) & (od < day("1993-10-01")) \
            & member(d.col("orders", "o_orderkey"), has)
        pc, pv = d.col("orders", "o_orderpriority")
        gid, (keys,) = groups(pv[pc[m]].astype(str))
        cnt = gcount(gid, len(keys))
        return top([(str(keys[i]), int(cnt[i])) for i in range(len(keys))], lambda r: r[0])

    def q5(self):
        d = self.d
        nk, rn = self._nation_region()
        asia = nk[rn == "ASIA"]
        od = d.col("orders", "o_orderdate")
        o_ok = (od >= day("1994-01-01")) & (od < day("1995-01-01"))
        li_o, li_of = d.lookup(d.col("orders", "o_orderkey"), d.col("lineitem", "l_orderkey"))
        ci, cf = d.lookup(d.col("customer", "c_custkey"), d.col("orders", "o_custkey"))
        o_cnat = np.where(cf, d.col("customer", "c_nationkey")[ci], -1)
        si, sf = d.lookup(d.col("supplier", "s_suppkey"), d.col("lineitem", "l_suppkey"))
        s_nat = np.where(sf, d.col("supplier", "s_nationkey")[si], -2)
        m = li_of & o_ok[li_o] & (o_cnat[li_o] == s_nat) & member(s_nat, asia)
        rows_i = np.nonzero(m)[0]
        nkeys, nnames = self._nation_names()
        ni, _ = d.lookup(nkeys, s_nat[rows_i])
        gid, (keys,) = groups(nnames[ni].astype(str))
        rev = gsum(gid, self._revenue(rows_i), len(keys))
        return top([(str(keys[i]), self.out(rev[i])) for i in range(len(keys))],
                   lambda r: -r[1])

    def q6(self):
        d = self.d
        li = "lineitem"
        sd, disc, qty = d.col(li, "l_shipdate"), d.col(li, "l_discount"), d.col(li, "l_quantity")
        m = (sd >= day("1994-01-01")) & (sd < day("1995-01-01")) \
            & (disc >= d.f(0.05)) & (disc <= d.f(0.07)) & (qty < 24)
        if not m.any():
            return [(None,)]
        x = d.col(li, "l_extendedprice")[m] * disc[m]
        return [(self.out(np.sum(x.astype(np.float64))),)]

    def _supp_cust_nations(self, rows_i):
        """Supplier's and customer's nation keys of the lineitem rows."""
        d = self.d
        si, _ = d.lookup(d.col("supplier", "s_suppkey"), d.col("lineitem", "l_suppkey")[rows_i])
        oi, _ = d.lookup(d.col("orders", "o_orderkey"), d.col("lineitem", "l_orderkey")[rows_i])
        ci, _ = d.lookup(d.col("customer", "c_custkey"), d.col("orders", "o_custkey")[oi])
        return d.col("supplier", "s_nationkey")[si], d.col("customer", "c_nationkey")[ci], oi

    def q7(self):
        d = self.d
        sd = d.col("lineitem", "l_shipdate")
        rows_i = np.nonzero((sd >= day("1995-01-01")) & (sd <= day("1996-12-31")))[0]
        sn, cn, _ = self._supp_cust_nations(rows_i)
        nkeys, nnames = self._nation_names()
        fr, de = nkeys[nnames == "FRANCE"][0], nkeys[nnames == "GERMANY"][0]
        m = ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))
        rows_i, sn, cn = rows_i[m], sn[m], cn[m]
        si, _ = d.lookup(nkeys, sn)
        ci, _ = d.lookup(nkeys, cn)
        gid, (a, b, y) = groups(nnames[si].astype(str), nnames[ci].astype(str), year(sd[rows_i]))
        rev = gsum(gid, self._revenue(rows_i), len(a))
        rows = [(str(a[i]), str(b[i]), int(y[i]), self.out(rev[i])) for i in range(len(a))]
        return top(rows, lambda r: r[:3])

    def q8(self):
        d = self.d
        pok = d.eq("part", "p_type", "ECONOMY ANODIZED STEEL")
        pi, pf = d.lookup(d.col("part", "p_partkey"), d.col("lineitem", "l_partkey"))
        rows_i = np.nonzero(pf & pok[np.where(pf, pi, 0)])[0]
        sn, cn, oi = self._supp_cust_nations(rows_i)
        od = d.col("orders", "o_orderdate")[oi]
        nk, rn = self._nation_region()
        amer = nk[rn == "AMERICA"]
        m = (od >= day("1995-01-01")) & (od <= day("1996-12-31")) & member(cn, amer)
        rows_i, sn, od = rows_i[m], sn[m], od[m]
        nkeys, nnames = self._nation_names()
        vol = self._revenue(rows_i)
        brazil = sn == nkeys[nnames == "BRAZIL"][0]
        gid, (y,) = groups(year(od))
        num = gsum(gid, np.where(brazil, vol, d.f(0)), len(y))
        den = gsum(gid, vol, len(y))
        return [(int(y[i]), self.out(num[i] / den[i])) for i in range(len(y))]

    def q9(self):
        d = self.d
        pok = d.like("part", "p_name", "%green%")
        pi, pf = d.lookup(d.col("part", "p_partkey"), d.col("lineitem", "l_partkey"))
        rows_i = np.nonzero(pf & pok[np.where(pf, pi, 0)])[0]
        lp = d.col("lineitem", "l_partkey")[rows_i].astype(np.int64)
        ls = d.col("lineitem", "l_suppkey")[rows_i].astype(np.int64)
        span = int(max(d.col("partsupp", "ps_suppkey").max(), ls.max())) + 1
        pk = d.col("partsupp", "ps_partkey").astype(np.int64) * span \
            + d.col("partsupp", "ps_suppkey")
        psi, psf = d.lookup(pk, lp * span + ls)
        rows_i, psi = rows_i[psf], psi[psf]
        sn, _, oi = self._supp_cust_nations(rows_i)
        amount = self._revenue(rows_i) - d.col("partsupp", "ps_supplycost")[psi] \
            * d.col("lineitem", "l_quantity")[rows_i]
        nkeys, nnames = self._nation_names()
        ni, _ = d.lookup(nkeys, sn)
        gid, (nat, y) = groups(nnames[ni].astype(str), year(d.col("orders", "o_orderdate")[oi]))
        s = gsum(gid, amount, len(nat))
        rows = [(str(nat[i]), int(y[i]), self.out(s[i])) for i in range(len(nat))]
        return top(rows, lambda r: (r[0], -r[1]))

    def q10(self):
        d = self.d
        od = d.col("orders", "o_orderdate")
        o_ok = (od >= day("1993-10-01")) & (od < day("1994-01-01"))
        oi, of = d.lookup(d.col("orders", "o_orderkey"), d.col("lineitem", "l_orderkey"))
        m = of & o_ok[np.where(of, oi, 0)] & d.eq("lineitem", "l_returnflag", "R")
        rows_i = np.nonzero(m)[0]
        cust = d.col("orders", "o_custkey")[oi[rows_i]]
        gid, (keys,) = groups(cust)
        rev = gsum(gid, self._revenue(rows_i), len(keys))
        ci, _ = d.lookup(d.col("customer", "c_custkey"), keys)
        nkeys, nnames = self._nation_names()
        ni, _ = d.lookup(nkeys, d.col("customer", "c_nationkey")[ci])
        names = d.strs("customer", "c_name", ci)
        addr = d.strs("customer", "c_address", ci)
        phone = d.strs("customer", "c_phone", ci)
        comm = d.strs("customer", "c_comment", ci)
        bal = d.col("customer", "c_acctbal")[ci]
        rows = [(int(keys[i]), names[i], self.out(rev[i]), self.out(bal[i]), nnames[ni[i]],
                 addr[i], phone[i], comm[i]) for i in range(len(keys))]
        return top(rows, lambda r: -r[2], 20)

    def q11(self):
        d = self.d
        nkeys, nnames = self._nation_names()
        de = nkeys[nnames == "GERMANY"][0]
        si, sf = d.lookup(d.col("supplier", "s_suppkey"), d.col("partsupp", "ps_suppkey"))
        m = sf & (d.col("supplier", "s_nationkey")[np.where(sf, si, 0)] == de)
        val = d.col("partsupp", "ps_supplycost")[m] * d.col("partsupp", "ps_availqty")[m]
        gid, (keys,) = groups(d.col("partsupp", "ps_partkey")[m])
        s = gsum(gid, val, len(keys))
        thr = np.sum(val.astype(np.float64)) * d.f(0.0001)
        rows = [(int(keys[i]), self.out(s[i])) for i in range(len(keys)) if s[i] > thr]
        return top(rows, lambda r: -r[1])

    def q12(self):
        d = self.d
        li = "lineitem"
        rd, cd, sd = (d.col(li, c) for c in ("l_receiptdate", "l_commitdate", "l_shipdate"))
        m = d.isin(li, "l_shipmode", ("MAIL", "SHIP")) & (cd < rd) & (sd < cd) \
            & (rd >= day("1994-01-01")) & (rd < day("1995-01-01"))
        rows_i = np.nonzero(m)[0]
        oi, _ = d.lookup(d.col("orders", "o_orderkey"), d.col(li, "l_orderkey")[rows_i])
        high = d.isin("orders", "o_orderpriority", ("1-URGENT", "2-HIGH"))[oi]
        mc, mv = d.col(li, "l_shipmode")
        gid, (keys,) = groups(mv[mc[rows_i]].astype(str))
        h = np.bincount(gid, weights=high, minlength=len(keys))
        lo = np.bincount(gid, weights=~high, minlength=len(keys))
        return top([(str(keys[i]), int(h[i]), int(lo[i])) for i in range(len(keys))],
                   lambda r: r[0])

    def q13(self):
        d = self.d
        keep = ~d.like("orders", "o_comment", "%special%requests%")
        ck = d.col("customer", "c_custkey")
        ci, cf = d.lookup(ck, d.col("orders", "o_custkey"))
        per = np.bincount(ci[keep & cf], minlength=len(ck))
        gid, (cc,) = groups(per)
        dist = gcount(gid, len(cc))
        rows = [(int(cc[i]), int(dist[i])) for i in range(len(cc))]
        return top(rows, lambda r: (-r[1], -r[0]))

    def q14(self):
        d = self.d
        sd = d.col("lineitem", "l_shipdate")
        m = (sd >= day("1995-09-01")) & (sd < day("1995-10-01"))
        pi, pf = d.lookup(d.col("part", "p_partkey"), d.col("lineitem", "l_partkey"))
        rows_i = np.nonzero(m & pf)[0]
        promo = d.like("part", "p_type", "PROMO%")[pi[rows_i]]
        rev = self._revenue(rows_i)
        num = np.sum(np.where(promo, rev, d.f(0)).astype(np.float64))
        den = np.sum(rev.astype(np.float64))
        return [(self.out(d.f(100.00) * num / den) if den else None,)]

    def q15(self):
        d = self.d
        sd = d.col("lineitem", "l_shipdate")
        rows_i = np.nonzero((sd >= day("1996-01-01")) & (sd < day("1996-04-01")))[0]
        gid, (keys,) = groups(d.col("lineitem", "l_suppkey")[rows_i])
        tot = gsum(gid, self._revenue(rows_i), len(keys)).astype(d.f)
        best = tot.max()
        si, sf = d.lookup(d.col("supplier", "s_suppkey"), keys)
        rows = []
        for i in np.nonzero(sf & (tot == best))[0]:
            s = si[i]
            rows.append((int(keys[i]), d.strs("supplier", "s_name", [s])[0],
                         d.strs("supplier", "s_address", [s])[0],
                         d.strs("supplier", "s_phone", [s])[0], self.out(tot[i])))
        return top(rows, lambda r: r[0])

    def q16(self):
        d = self.d
        bad_s = d.col("supplier", "s_suppkey")[d.like("supplier", "s_comment",
                                                      "%Customer%Complaints%")]
        pok = ~d.eq("part", "p_brand", "Brand#45") \
            & ~d.like("part", "p_type", "MEDIUM POLISHED%") \
            & member(d.col("part", "p_size"), [49, 14, 23, 45, 19, 3, 36, 9])
        pi, pf = d.lookup(d.col("part", "p_partkey"), d.col("partsupp", "ps_partkey"))
        ps_supp = d.col("partsupp", "ps_suppkey")
        m = pf & pok[np.where(pf, pi, 0)] & ~member(ps_supp, bad_s)
        pi, supp = pi[m], ps_supp[m]
        bc, bv = d.col("part", "p_brand")
        tc, tv = d.col("part", "p_type")
        size = d.col("part", "p_size")[pi]
        # COUNT(DISTINCT ps_suppkey): distinct (group, supplier) pairs a group
        gid, (b, t, s) = groups(bc[pi], tc[pi], size)
        pair = np.unique(gid.astype(np.int64) * (int(supp.max()) + 1) + supp)
        cnt = np.bincount(pair // (int(supp.max()) + 1), minlength=len(b))
        rows = [(str(bv[b[i]]), str(tv[t[i]]), int(s[i]), int(cnt[i])) for i in range(len(b))]
        return top(rows, lambda r: (-r[3], r[0], r[1], r[2]))

    def _part_avg_qty(self):
        """part key -> (sum, count) of l_quantity over all its lineitems."""
        d = self.d
        lp = d.col("lineitem", "l_partkey")
        gid, (keys,) = groups(lp)
        return keys, gsum(gid, d.col("lineitem", "l_quantity"), len(keys)), \
            gcount(gid, len(keys)), gid

    def q17(self):
        d = self.d
        pok = d.eq("part", "p_brand", "Brand#23") & d.eq("part", "p_container", "MED BOX")
        pi, pf = d.lookup(d.col("part", "p_partkey"), d.col("lineitem", "l_partkey"))
        keys, s, c, gid = self._part_avg_qty()
        avg = (s / c).astype(d.f)
        qty = d.col("lineitem", "l_quantity")
        m = pf & pok[np.where(pf, pi, 0)] & (qty < d.f(0.2) * avg[gid])
        if not m.any():
            return [(None,)]
        tot = np.sum(d.col("lineitem", "l_extendedprice")[m].astype(np.float64))
        return [(self.out(tot / 7.0),)]

    def q18(self):
        d = self.d
        lo = d.col("lineitem", "l_orderkey")
        gid, (keys,) = groups(lo)
        q = gsum(gid, d.col("lineitem", "l_quantity"), len(keys))
        big = keys[q > 300]
        oi, _ = d.lookup(d.col("orders", "o_orderkey"), big)
        ci, _ = d.lookup(d.col("customer", "c_custkey"), d.col("orders", "o_custkey")[oi])
        bi, _ = d.lookup(keys, big)
        rows = list(zip(d.strs("customer", "c_name", ci),
                        (int(x) for x in d.col("customer", "c_custkey")[ci]),
                        (int(x) for x in big),
                        (to_date(x) for x in d.col("orders", "o_orderdate")[oi]),
                        (self.out(x) for x in d.col("orders", "o_totalprice")[oi]),
                        (self.out(x) for x in q[bi])))
        return top(rows, lambda r: (-r[4], r[3]), 100)

    def q19(self):
        d = self.d
        pi, pf = d.lookup(d.col("part", "p_partkey"), d.col("lineitem", "l_partkey"))
        pi = np.where(pf, pi, 0)
        qty = d.col("lineitem", "l_quantity")
        size = d.col("part", "p_size")[pi]
        ship = d.isin("lineitem", "l_shipmode", ("AIR", "REG AIR")) \
            & d.eq("lineitem", "l_shipinstruct", "DELIVER IN PERSON")
        m = np.zeros(len(qty), bool)
        for brand, conts, qlo, qhi, smax in (
                ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11, 5),
                ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 20, 10),
                ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15)):
            pk = d.eq("part", "p_brand", brand) & d.isin("part", "p_container", conts)
            m |= pk[pi] & (qty >= qlo) & (qty <= qhi) & (size >= 1) & (size <= smax) & ship
        m &= pf
        if not m.any():
            return [(None,)]
        return [(self.out(np.sum(self._revenue(np.nonzero(m)[0]).astype(np.float64))),)]

    def q20(self):
        d = self.d
        parts = d.col("part", "p_partkey")[d.like("part", "p_name", "forest%")]
        sd = d.col("lineitem", "l_shipdate")
        lm = (sd >= day("1994-01-01")) & (sd < day("1995-01-01"))
        span = int(max(d.col("partsupp", "ps_suppkey").max(),
                       d.col("lineitem", "l_suppkey").max())) + 1
        lk = d.col("lineitem", "l_partkey")[lm].astype(np.int64) * span \
            + d.col("lineitem", "l_suppkey")[lm]
        gid, (keys,) = groups(lk)
        sq = gsum(gid, d.col("lineitem", "l_quantity")[lm], len(keys))
        pk = d.col("partsupp", "ps_partkey").astype(np.int64) * span \
            + d.col("partsupp", "ps_suppkey")
        ki, kf = d.lookup(keys, pk)
        avail = d.col("partsupp", "ps_availqty")
        # a pair with no sale has a NULL sum: the comparison is never true
        m = member(d.col("partsupp", "ps_partkey"), parts) & kf \
            & (avail > d.f(0.5) * sq[np.where(kf, ki, 0)].astype(d.f))
        supps = np.unique(d.col("partsupp", "ps_suppkey")[m])
        nkeys, nnames = self._nation_names()
        ca = nkeys[nnames == "CANADA"][0]
        sm = (d.col("supplier", "s_nationkey") == ca) & member(d.col("supplier", "s_suppkey"),
                                                                supps)
        si = np.nonzero(sm)[0]
        rows = list(zip(d.strs("supplier", "s_name", si), d.strs("supplier", "s_address", si)))
        return top(rows, lambda r: r[0])

    def q21(self):
        d = self.d
        li = "lineitem"
        lo, ls = d.col(li, "l_orderkey"), d.col(li, "l_suppkey")
        late = d.col(li, "l_receiptdate") > d.col(li, "l_commitdate")
        n_o = int(lo.max()) + 1
        # per order: the smallest and largest supplier of all its lines and
        # of its late lines
        smin, smax = minmax_by(lo, ls, n_o)
        lmin, lmax = minmax_by(lo[late], ls[late], n_o)
        other = (smin[lo] != ls) | (smax[lo] != ls)
        other_late = (lmax[lo] >= 0) & ((lmin[lo] != ls) | (lmax[lo] != ls))
        oi, of = d.lookup(d.col("orders", "o_orderkey"), lo)
        fstat = d.eq("orders", "o_orderstatus", "F")
        nkeys, nnames = self._nation_names()
        sa = nkeys[nnames == "SAUDI ARABIA"][0]
        si, sf = d.lookup(d.col("supplier", "s_suppkey"), ls)
        m = late & other & ~other_late & of & fstat[np.where(of, oi, 0)] & sf \
            & (d.col("supplier", "s_nationkey")[np.where(sf, si, 0)] == sa)
        gid, (names,) = groups(d.strs("supplier", "s_name", si[m]).astype(str))
        cnt = gcount(gid, len(names))
        rows = [(str(names[i]), int(cnt[i])) for i in range(len(names))]
        return top(rows, lambda r: (-r[1], r[0]), 100)

    def q22(self):
        d = self.d
        codes = ("13", "31", "23", "29", "30", "18", "17")
        pc, pv = d.col("customer", "c_phone")
        cc_of = np.asarray([v[:2] for v in pv], dtype=object)
        cc = cc_of[pc]
        inset = np.isin(cc.astype(str), codes)
        bal = d.col("customer", "c_acctbal")
        pos = inset & (bal > d.f(0.00))
        if not pos.any():
            return []
        avg = d.f(np.sum(bal[pos].astype(np.float64)) / pos.sum())
        no_orders = ~member(d.col("customer", "c_custkey"), d.col("orders", "o_custkey"))
        m = inset & (bal > avg) & no_orders
        gid, (keys,) = groups(cc[m].astype(str))
        cnt = gcount(gid, len(keys))
        s = gsum(gid, bal[m], len(keys))
        return top([(str(keys[i]), int(cnt[i]), self.out(s[i])) for i in range(len(keys))],
                   lambda r: r[0])


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _close(a, b, rtol: float) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if not (_num(a) and _num(b)):
            return False
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=rtol, abs_tol=1e-6)
    return a == b


def _canon(row: tuple):
    """Sort key for a multiset comparison: NULL first, then the value."""
    return tuple((v is not None, v if v is not None else 0) for v in row)


class Reference:
    def __init__(self, config: dict, tables: dict, device: str):
        self._tables = tables
        self._q = {False: Queries(Data(tables), float), True: None}
        self._answers: dict = {}

    def answer(self, stmt, control: bool = False) -> list:
        key = (stmt.name, control)
        if key not in self._answers:
            if control and self._q[True] is None:
                self._q[True] = Queries(Data(self._tables, np.float32),
                                        lambda x: float(np.float32(x)))
            self._answers[key] = getattr(self._q[control], stmt.name.replace("-", "_"))()
        return self._answers[key]

    def compare(self, stmt, got: list, want: list) -> dict:
        """The compared numbers of one execution, ``got`` against the
        reference's rows ``want``."""
        bad = {"mismatches": 1, "rel_err": 0.0}
        if len(got) != len(want) or any(len(g) != len(w) for g, w in zip(got, want)):
            return bad
        order, has_limit = ORDER[stmt.name]
        pairs: list = []
        if not order:
            pairs = list(zip(sorted(got, key=_canon), sorted(want, key=_canon)))
        else:
            start = 0
            while start < len(want):
                end = start + 1
                while end < len(want) and all(_close(want[end][i], want[start][i], TIE_RTOL)
                                              for i in order):
                    end += 1
                for i in range(start, end):
                    if not all(_close(got[i][k], want[i][k], TIE_RTOL) for k in order):
                        return bad
                if has_limit and end == len(want):
                    pairs += [(tuple(got[i][k] for k in order), tuple(want[i][k] for k in order))
                              for i in range(start, end)]
                else:
                    pairs += list(zip(sorted(got[start:end], key=_canon),
                                      sorted(want[start:end], key=_canon)))
                start = end
        err = 0.0
        for g, w in pairs:
            for a, b in zip(g, w):
                if isinstance(a, float) or isinstance(b, float):
                    if not (_num(a) and _num(b)):
                        return bad
                    if math.isnan(a) or math.isnan(b):
                        if not (math.isnan(a) and math.isnan(b)):
                            return bad
                        continue
                    err = max(err, abs(a - b) / max(abs(b), 1e-300) if a != b else 0.0)
                elif a != b:
                    return bad
        return {"mismatches": 0, "rel_err": err}
