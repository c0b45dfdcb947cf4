"""TPC-H data at a scale factor, made from a seed by the rules of the TPC-H
specification (v3.0.1, clause 4.2.3) in numpy, handed over as pyarrow tables.

Every rule that shapes a join, a group or a predicate is the spec's:

- keys: ``o_orderkey`` sparse (the first 8 of every 32), ``o_custkey`` never
  a multiple of 3, each part's 4 suppliers by the spec's formula, and
  ``l_suppkey`` one of its part's 4 by the same formula;
- derived columns: ``p_retailprice`` from the part key, ``l_extendedprice``
  = quantity x retail price, ``o_totalprice`` from the order's lines,
  ``l_returnflag`` / ``l_linestatus`` from the receipt and ship dates against
  CURRENTDATE 1995-06-17, ``o_orderstatus`` from the lines' statuses;
- strings: ``p_name`` 5 distinct words of the 92 colours, comments
  substrings of a text pool made by the spec's pseudo-text grammar at the
  spec's lengths, ``Customer%Complaints`` and ``Customer%Recommends`` in SF x
  5 suppliers' comments each, addresses random strings of 10 to 40 of 64
  symbols.

Not dbgen: the random streams differ, so the same seed gives other rows than
dbgen would, and the grammar's pool is drawn from the seed (dbgen's is one
fixed 300 MB pool).  The word lists and weights follow dbgen's
``dists.dss``."""

from __future__ import annotations

import datetime
import re

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
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "burnished", "chartreuse", "chiffon", "chocolate", "coral",
          "cornflower", "cornsilk", "cream", "cyan", "dark", "deep", "dim",
          "dodger", "drab", "firebrick", "floral", "forest", "frosted",
          "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
          "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
          "lemon", "light", "lime", "linen", "magenta", "maroon", "medium",
          "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
          "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
          "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
          "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
          "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
          "thistle", "tomato", "turquoise", "violet", "wheat", "white",
          "yellow"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

# the pseudo-text grammar's word lists, as "word:weight"
_W = {
    "noun": "foxes:50 ideas:50 theodolites:50 pinto beans:25 instructions:25 "
            "dependencies:25 excuses:25 platelets:10 asymptotes:10 courts:5 dolphins:5 "
            "multipliers:1 sauternes:1 warthogs:1 frets:1 dinos:1 attainments:1 somas:1 "
            "Tiresias:1 patterns:1 forges:1 braids:1 frays:1 warhorses:1 dugouts:1 "
            "notornis:1 epitaphs:1 pearls:1 tithes:1 waters:1 orbits:1 gifts:1 sheaves:1 "
            "depths:1 sentiments:1 decoys:1 realms:1 pains:1 grouches:1 escapades:1 "
            "hockey players:1 packages:40 requests:40 accounts:40 deposits:40",
    "verb": "sleep:20 wake:20 are:20 cajole:20 haggle:20 nag:10 use:10 boost:10 affix:5 "
            "detect:5 integrate:5 maintain:1 nod:1 was:1 lose:1 sublate:1 solve:1 thrash:1 "
            "promise:1 engage:1 hinder:1 print:1 x-ray:1 breach:1 eat:1 grow:1 impress:1 "
            "mold:1 poach:1 serve:1 run:1 dazzle:1 snooze:1 doze:1 unwind:1 kindle:1 "
            "play:1 hang:1 believe:1 doubt:1",
    "adjective": "special:20 pending:20 unusual:20 express:20 furious:1 sly:1 careful:1 "
                 "blithe:1 quick:1 fluffy:1 slow:1 quiet:1 ruthless:1 thin:1 close:1 "
                 "dogged:1 daring:1 brave:1 stealthy:1 permanent:1 enticing:1 idle:1 "
                 "busy:1 regular:50 final:40 ironic:40 even:30 bold:20 silent:10",
    "adverb": "sometimes:1 always:1 never:1 furiously:50 slyly:50 carefully:50 "
              "blithely:40 quickly:30 fluffily:20 slowly:1 quietly:1 ruthlessly:1 "
              "thinly:1 closely:1 doggedly:1 daringly:1 bravely:1 stealthily:1 "
              "permanently:1 enticingly:1 idly:1 busily:1 regularly:1 finally:1 "
              "ironically:1 evenly:1 boldly:1 silently:1",
    "preposition": "about:50 above:50 according to:50 across:50 after:50 against:40 "
                   "along:40 alongside of:30 among:30 around:20 at:10 atop:1 before:1 "
                   "behind:1 beneath:1 beside:1 besides:1 between:1 beyond:1 by:1 "
                   "despite:1 during:1 except:1 for:1 from:1 in place of:1 inside:1 "
                   "instead of:1 into:1 near:1 of:1 on:1 outside:1 over:1 past:1 "
                   "since:1 through:1 throughout:1 to:1 toward:1 under:1 until:1 up:1 "
                   "upon:1 without:1 with:1 within:1",
    "auxiliary": "do:1 may:1 might:1 shall:1 will:1 would:1 can:1 could:1 should:1 "
                 "ought to:1 must:1 will have to:1 shall have to:1 could have to:1 "
                 "should have to:1 must have to:1 need to:1 try to:1",
    "terminator": ".:50 ;:1 ::1 ?:1 !:1 --:1",
}
# sentence, noun-phrase and verb-phrase forms with their weights
_SENTENCES = [("N V T", 3), ("N V P T", 3), ("N V N T", 3), ("N P V N T", 1),
              ("N P V P T", 1)]
_NOUN_PHRASES = [("noun", 10), ("adjective noun", 20), ("adjective, adjective noun", 10),
                 ("adverb adjective noun", 50)]
_VERB_PHRASES = [("verb", 30), ("auxiliary verb", 1), ("verb adverb", 40),
                 ("auxiliary verb adverb", 1)]
POOL_CHARS = 1 << 21
VSTRING = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyz"
                        b"ABCDEFGHIJKLMNOPQRSTUVWXYZ, ", np.uint8)

_EPOCH = datetime.date(1970, 1, 1)


def _d(iso: str) -> int:
    y, m, d = map(int, iso.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


CURRENTDATE = _d("1995-06-17")
STARTDATE = _d("1992-01-01")
ENDDATE = _d("1998-12-31")


def _words(kind: str) -> tuple[list, np.ndarray]:
    pairs = re.findall(r"(.+?):(\d+)(?: |$)", _W[kind])
    p = np.asarray([float(k) for _, k in pairs])
    return [w for w, _ in pairs], p / p.sum()


class _Draw:
    """Weighted draws of one word class, many at a time."""

    def __init__(self, rng, choices: list, p: np.ndarray):
        self.rng, self.choices, self.p = rng, choices, p
        self.buf: list = []

    def __call__(self):
        if not self.buf:
            self.buf = [self.choices[i] for i in
                        self.rng.choice(len(self.choices), 4096, p=self.p)[::-1]]
        return self.buf.pop()


def text_pool(rng, n_chars: int = POOL_CHARS) -> bytes:
    """``n_chars`` of the spec's pseudo text: sentences of the grammar
    (clause 4.2.2.14) joined by spaces."""
    def weighted(forms):
        return _Draw(rng, [f for f, _ in forms],
                     np.asarray([w for _, w in forms], float) / sum(w for _, w in forms))

    word = {k: _Draw(rng, *_words(k)) for k in _W}
    sentence, nphrase, vphrase = (weighted(f) for f in (_SENTENCES, _NOUN_PHRASES,
                                                        _VERB_PHRASES))

    def noun_phrase():
        f = nphrase()
        if f == "adjective, adjective noun":
            return f"{word['adjective']()}, {word['adjective']()} {word['noun']()}"
        return " ".join(word[k]() for k in f.split())

    def verb_phrase():
        return " ".join(word[k]() for k in vphrase().split())

    part = {"N": noun_phrase, "V": verb_phrase,
            "P": lambda: f"{word['preposition']()} the {noun_phrase()}"}
    out, size = [], 0
    while size < n_chars:
        s = ""
        for sym in sentence().split():
            if sym == "T":
                s += word["terminator"]()
            else:
                s += (" " if s else "") + part[sym]()
        out.append(s)
        size += len(s) + 1
    return " ".join(out).encode()[:n_chars]


def _strings(data: np.ndarray, lens: np.ndarray) -> pa.Array:
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1] >= 2**31:
        raise ValueError("a string column over 2 GiB")
    return pa.StringArray.from_buffers(len(lens), pa.py_buffer(offsets.astype(np.int32)),
                                       pa.py_buffer(data))


def _pack(rows: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The first ``lens[i]`` bytes of each row of ``rows``, end to end."""
    return rows[np.arange(rows.shape[1]) < lens[:, None]]


def text(rng, pool: np.ndarray, n: int, lo: int, hi: int) -> pa.Array:
    """``n`` text strings [lo, hi]: substrings of the pool at random offsets,
    of a length uniform in [lo, hi]."""
    lens = rng.integers(lo, hi + 1, n)
    offs = rng.integers(0, len(pool) - hi, n)
    win = np.lib.stride_tricks.sliding_window_view(pool, hi)
    step = 1 << 20
    data = np.concatenate([_pack(win[offs[i:i + step]], lens[i:i + step])
                           for i in range(0, n, step)] or [np.zeros(0, np.uint8)])
    return _strings(data, lens)


def vstring(rng, n: int, lo: int = 10, hi: int = 40) -> pa.Array:
    """``n`` random v-strings [lo, hi] over 64 symbols."""
    lens = rng.integers(lo, hi + 1, n)
    rows = VSTRING[rng.integers(0, len(VSTRING), (n, hi))]
    return _strings(_pack(rows, lens), lens)


def _insert(rng, comments: pa.Array, rows: np.ndarray, first: str, last: str) -> list:
    """``comments`` with ``first``%``last`` written over each of ``rows`` at a
    random position, the length kept."""
    out = comments.to_pylist()
    for r in rows:
        s = out[r]
        room = len(s) - len(first) - len(last)
        gap = int(rng.integers(0, room + 1))
        at = int(rng.integers(0, room - gap + 1))
        mid = s[at + len(first):at + len(first) + gap]
        out[r] = s[:at] + first + mid + last + s[at + len(first) + gap + len(last):]
    return out


def _phones(rng, nations: np.ndarray) -> list:
    n = len(nations)
    a, b = rng.integers(100, 1000, (2, n))
    c = rng.integers(1000, 10000, n)
    return [f"{10 + k}-{x}-{y}-{z}" for k, x, y, z in
            zip(nations.tolist(), a.tolist(), b.tolist(), c.tolist())]


def _tagged(prefix: str, nums) -> list:
    return [f"{prefix}{int(k):09d}" for k in nums]


def _pick(rng, values, n) -> pa.Array:
    """``n`` of ``values`` drawn uniformly, as a plain string column."""
    return _decode(rng.integers(0, len(values), n), values)


def _decode(codes: np.ndarray, values) -> pa.Array:
    return pa.DictionaryArray.from_arrays(pa.array(codes.astype(np.int32)),
                                          pa.array(list(values), pa.string())).cast(pa.string())


def _dates(days: np.ndarray) -> pa.Array:
    return pa.array(days.astype(np.int32), pa.int32()).cast(pa.date32())


def supplier_of(partkey: np.ndarray, i, n_supp: int) -> np.ndarray:
    """The spec's ``i``-th supplier (0..3) of each part."""
    pk = partkey.astype(np.int64)
    return ((pk + i * (n_supp // 4 + (pk - 1) // n_supp)) % n_supp + 1).astype(np.int32)


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    pk = partkey.astype(np.int64)
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def generate(scale: float = 0.01, seed: int = 0) -> dict[str, pa.Table]:
    """-> table name -> pa.Table; row counts scale as the spec's (SF1: 1.5M
    orders, about 6M lineitem rows)."""
    rng = np.random.default_rng(seed)
    n_orders = max(100, int(1_500_000 * scale))
    n_cust = max(30, int(150_000 * scale))
    n_supp = max(10, int(10_000 * scale))
    n_part = max(40, int(200_000 * scale))
    n_clerk = max(1, int(1000 * scale))
    pool = np.frombuffer(text_pool(rng), np.uint8)

    region = pa.table({
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": REGIONS,
        "r_comment": text(rng, pool, 5, 31, 115),
    })
    nation = pa.table({
        "n_nationkey": np.arange(len(NATIONS), dtype=np.int32),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": np.asarray([r for _, r in NATIONS], np.int32),
        "n_comment": text(rng, pool, len(NATIONS), 31, 114),
    })

    # p_name: 5 distinct colours a part
    words = rng.integers(0, len(COLORS), (n_part, 5))
    while True:
        srt = np.sort(words, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup.any():
            break
        words[dup] = rng.integers(0, len(COLORS), (int(dup.sum()), 5))
    colors = np.asarray(COLORS, dtype=object)[words]
    p_name = [" ".join(r) for r in colors]
    pkeys = np.arange(1, n_part + 1, dtype=np.int32)
    mfgr_n = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    types = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
    t1, t2, t3 = (rng.integers(0, len(v), n_part) for v in (TYPE_S1, TYPE_S2, TYPE_S3))
    p_type = _decode((t1 * len(TYPE_S2) + t2) * len(TYPE_S3) + t3, types)
    conts = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
    c1, c2 = (rng.integers(0, len(v), n_part) for v in (CONTAINER_S1, CONTAINER_S2))
    p_container = _decode(c1 * len(CONTAINER_S2) + c2, conts)
    part = pa.table({
        "p_partkey": pkeys,
        "p_name": p_name,
        "p_mfgr": _decode(mfgr_n - 1, [f"Manufacturer#{m}" for m in range(1, 6)]),
        "p_brand": _decode((mfgr_n - 1) * 5 + brand_n - 1,
                           [f"Brand#{m}{b}" for m in range(1, 6) for b in range(1, 6)]),
        "p_type": p_type,
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": p_container,
        "p_retailprice": retail_cents(pkeys) / 100.0,
        "p_comment": text(rng, pool, n_part, 5, 22),
    })

    s_nat = rng.integers(0, len(NATIONS), n_supp).astype(np.int32)
    s_comment = text(rng, pool, n_supp, 25, 100)
    k = max(1, int(round(5 * scale)))
    marked = rng.choice(n_supp, 2 * k, replace=False)
    s_comment = _insert(rng, s_comment, marked[:k], "Customer", "Complaints")
    s_comment = _insert(rng, pa.array(s_comment), marked[k:], "Customer", "Recommends")
    supplier = pa.table({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int32),
        "s_name": _tagged("Supplier#", np.arange(1, n_supp + 1)),
        "s_address": vstring(rng, n_supp),
        "s_nationkey": s_nat,
        "s_phone": _phones(rng, s_nat),
        "s_acctbal": rng.integers(-99999, 1_000_000, n_supp) / 100.0,
        "s_comment": s_comment,
    })

    # partsupp: each part's 4 suppliers by the spec's formula; a small scale
    # can repeat one, and the repeat is dropped
    ps_part = np.repeat(pkeys, 4)
    ps_supp = supplier_of(ps_part, np.tile(np.arange(4), n_part), n_supp)
    packed = ps_part.astype(np.int64) * (n_supp + 1) + ps_supp
    _, first = np.unique(packed, return_index=True)
    keep = np.zeros(len(ps_part), bool)
    keep[first] = True
    ps_part, ps_supp = ps_part[keep], ps_supp[keep]
    n_ps = len(ps_part)
    partsupp = pa.table({
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int32),
        "ps_supplycost": rng.integers(100, 100_001, n_ps) / 100.0,
        "ps_comment": text(rng, pool, n_ps, 49, 198),
    })

    c_nat = rng.integers(0, len(NATIONS), n_cust).astype(np.int32)
    customer = pa.table({
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int32),
        "c_name": _tagged("Customer#", np.arange(1, n_cust + 1)),
        "c_address": vstring(rng, n_cust),
        "c_nationkey": c_nat,
        "c_phone": _phones(rng, c_nat),
        "c_acctbal": rng.integers(-99999, 1_000_000, n_cust) / 100.0,
        "c_mktsegment": _pick(rng, SEGMENTS, n_cust),
        "c_comment": text(rng, pool, n_cust, 29, 116),
    })

    # orders: keys sparse (the first 8 of every 32), customers uniform over
    # the keys that are not multiples of 3 (a third never order)
    i = np.arange(n_orders, dtype=np.int64)
    o_key = ((i // 8) * 32 + i % 8 + 1).astype(np.int32)
    j = rng.integers(0, n_cust - n_cust // 3, n_orders)
    o_cust = (3 * (j // 2) + 1 + j % 2).astype(np.int32)
    o_dates = rng.integers(STARTDATE, ENDDATE - 151 + 1, n_orders)

    per = rng.integers(1, 8, n_orders)
    l_order = np.repeat(o_key, per)
    n_li = len(l_order)
    starts = np.cumsum(per) - per
    linenum = (np.arange(n_li) - np.repeat(starts, per) + 1).astype(np.int32)
    l_part = rng.integers(1, n_part + 1, n_li).astype(np.int32)
    l_supp = supplier_of(l_part, rng.integers(0, 4, n_li), n_supp)
    qty = rng.integers(1, 51, n_li)
    ext_c = qty * retail_cents(l_part)
    disc = rng.integers(0, 11, n_li)
    tax = rng.integers(0, 9, n_li)
    odate = np.repeat(o_dates, per)
    ship = odate + rng.integers(1, 122, n_li)
    commit = odate + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    returned = rng.integers(0, 2, n_li)
    rflag = _decode(np.where(receipt <= CURRENTDATE, returned, 2), ["A", "R", "N"])
    open_ = ship > CURRENTDATE
    # the order's status and total price from its lines (cents, as dbgen)
    owner = np.repeat(np.arange(n_orders), per)
    n_open = np.bincount(owner, weights=open_, minlength=n_orders)
    ostatus = _decode(np.where(n_open == per, 0, np.where(n_open == 0, 1, 2)), ["O", "F", "P"])
    line_c = ext_c * (100 - disc) // 100 * (100 + tax) // 100
    total_c = np.bincount(owner, weights=line_c, minlength=n_orders)

    orders = pa.table({
        "o_orderkey": o_key,
        "o_custkey": o_cust,
        "o_orderstatus": ostatus,
        "o_totalprice": np.round(total_c) / 100.0,
        "o_orderdate": _dates(o_dates),
        "o_orderpriority": _pick(rng, PRIORITIES, n_orders),
        "o_clerk": _decode(rng.integers(0, n_clerk, n_orders),
                           _tagged("Clerk#", range(1, n_clerk + 1))),
        "o_shippriority": np.zeros(n_orders, np.int32),
        "o_comment": text(rng, pool, n_orders, 19, 78),
    })
    lineitem = pa.table({
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_linenumber": linenum,
        "l_quantity": qty.astype(np.float64),
        "l_extendedprice": ext_c / 100.0,
        "l_discount": disc / 100.0,
        "l_tax": tax / 100.0,
        "l_returnflag": rflag,
        "l_linestatus": _decode(open_.astype(np.int32), ["F", "O"]),
        "l_shipdate": _dates(ship),
        "l_commitdate": _dates(commit),
        "l_receiptdate": _dates(receipt),
        "l_shipinstruct": _pick(rng, SHIPINSTRUCT, n_li),
        "l_shipmode": _pick(rng, SHIPMODES, n_li),
        "l_comment": text(rng, pool, n_li, 10, 43),
    })
    return {"region": region, "nation": nation, "part": part,
            "supplier": supplier, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


def tables(config: dict, seed: int) -> dict[str, pa.Table]:
    return generate(float(config["scale"]), seed)
