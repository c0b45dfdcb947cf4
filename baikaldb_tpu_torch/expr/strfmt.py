"""MySQL string-formatting kernels shared by every host-side plane.

DATE_FORMAT / FORMAT / HEX / BIN / OCT produce data-dependent strings over
numeric inputs — the one shape the in-jit compiler cannot lower (a device
string column needs a static dictionary at trace time; expr/builtins_ext2
module docstring).  The reference implements them row-wise in
src/expr/internal_functions.cpp (date_format at the datetime section,
format/hex/bin in the numeric-string section); here they are plain Python
evaluated at the three host stages that can run them:

- result egress (exec/egress.py rewrites select-list occurrences),
- the store-daemon fragment interpreter (expr/roweval.py),
- WHERE via inversion (exec/egress.py turns comparisons on monotone
  DATE_FORMAT outputs / injective HEX/BIN/OCT outputs back into native
  predicates the kernel executes).
"""

from __future__ import annotations

import datetime
from typing import Optional

_ABBR_MON = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug",
             "Sep", "Oct", "Nov", "Dec"]
_FULL_MON = ["January", "February", "March", "April", "May", "June",
             "July", "August", "September", "October", "November",
             "December"]
_ABBR_DAY = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
_FULL_DAY = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]


def _ordinal(n: int) -> str:
    if 11 <= n % 100 <= 13:
        return f"{n}th"
    return f"{n}{ {1: 'st', 2: 'nd', 3: 'rd'}.get(n % 10, 'th') }"


def mysql_date_format(v, fmt: str) -> Optional[str]:
    """DATE_FORMAT(v, fmt) — the reference's specifier table
    (internal_functions.cpp date_format).  ``v``: date or datetime (a str
    is parsed first).  Unknown specifiers emit the literal character, like
    MySQL."""
    if v is None or fmt is None:
        return None
    if isinstance(v, str):
        s = v.strip()
        try:
            v = (datetime.date.fromisoformat(s) if len(s) <= 10
                 else datetime.datetime.fromisoformat(s.replace("T", " ")))
        except ValueError:
            return None
    if isinstance(v, datetime.datetime):
        d, t = v.date(), v.time()
    elif isinstance(v, datetime.date):
        d, t = v, datetime.time(0, 0, 0)
    else:
        return None
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch != "%" or i + 1 >= len(fmt):
            out.append(ch)
            i += 1
            continue
        c = fmt[i + 1]
        i += 2
        if c == "Y":
            out.append(f"{d.year:04d}")
        elif c == "y":
            out.append(f"{d.year % 100:02d}")
        elif c == "m":
            out.append(f"{d.month:02d}")
        elif c == "c":
            out.append(str(d.month))
        elif c == "d":
            out.append(f"{d.day:02d}")
        elif c == "e":
            out.append(str(d.day))
        elif c == "D":
            out.append(_ordinal(d.day))
        elif c == "H":
            out.append(f"{t.hour:02d}")
        elif c == "k":
            out.append(str(t.hour))
        elif c in ("h", "I"):
            out.append(f"{(t.hour % 12) or 12:02d}")
        elif c == "l":
            out.append(str((t.hour % 12) or 12))
        elif c == "i":
            out.append(f"{t.minute:02d}")
        elif c in ("s", "S"):
            out.append(f"{t.second:02d}")
        elif c == "f":
            out.append(f"{t.microsecond:06d}")
        elif c == "p":
            out.append("AM" if t.hour < 12 else "PM")
        elif c == "r":
            out.append(f"{(t.hour % 12) or 12:02d}:{t.minute:02d}:"
                       f"{t.second:02d} {'AM' if t.hour < 12 else 'PM'}")
        elif c == "T":
            out.append(f"{t.hour:02d}:{t.minute:02d}:{t.second:02d}")
        elif c == "M":
            out.append(_FULL_MON[d.month - 1])
        elif c == "b":
            out.append(_ABBR_MON[d.month - 1])
        elif c == "W":
            out.append(_FULL_DAY[d.weekday()])
        elif c == "a":
            out.append(_ABBR_DAY[d.weekday()])
        elif c == "j":
            out.append(f"{d.timetuple().tm_yday:03d}")
        elif c == "w":
            out.append(str(d.isoweekday() % 7))
        elif c == "%":
            out.append("%")
        else:
            out.append(c)           # MySQL: unknown specifier -> literal
    return "".join(out)


def mysql_format(n, dec) -> Optional[str]:
    """FORMAT(n, d): round half away from zero at d decimals, thousands
    commas.  Rounds through Decimal(str(n)) — scaling the binary float
    directly printed FORMAT(0.145, 2) as 0.14, because 0.145 stores as
    0.14499... and the +0.5 trick truncates it."""
    if n is None or dec is None:
        return None
    if isinstance(n, str):
        from .roweval import _str_num
        n = _str_num(n)
    d = min(max(int(dec), 0), 30)   # MySQL clamps FORMAT decimals at 30
    from decimal import ROUND_HALF_UP, Decimal, localcontext
    with localcontext() as ctx:
        x = Decimal(str(n))
        # quantize needs room for every integer digit plus d fractionals,
        # or it raises InvalidOperation instead of returning the result
        ctx.prec = max(1, x.adjusted() + 1) + d + 5
        q = x.quantize(Decimal(1).scaleb(-d), rounding=ROUND_HALF_UP)
        neg = q < 0
        if neg:
            q = -q
        whole = int(q)
        frac = int((q - whole).scaleb(d)) if d else 0
    s = f"{whole:,d}"
    if d:
        s += f".{frac:0{d}d}"
    return ("-" if neg and q != 0 else "") + s


_I64_MASK = (1 << 64) - 1


def mysql_hex(v) -> Optional[str]:
    """HEX(int) = uppercase hex of the 64-bit two's-complement value;
    HEX(str) = hex of the utf-8 bytes (both MySQL)."""
    if v is None:
        return None
    if isinstance(v, str):
        return v.encode().hex().upper()
    return f"{int(v) & _I64_MASK:X}"


def mysql_bin(v) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, str):
        from .roweval import _str_num
        v = int(_str_num(v))
    return f"{int(v) & _I64_MASK:b}"


def mysql_oct(v) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, str):
        from .roweval import _str_num
        v = int(_str_num(v))
    return f"{int(v) & _I64_MASK:o}"


# -- WHERE inversion helpers ------------------------------------------------

# formats whose output order equals chronological order, with the bucket
# width they expose — the everyday analytics idioms
_MONOTONE = {
    "%Y": "year",
    "%Y-%m": "month", "%Y%m": "month",
    "%Y-%m-%d": "day", "%Y%m%d": "day",
    "%Y-%m-%d %H:%i:%s": "second", "%Y-%m-%dT%H:%i:%s": "second",
}


def monotone_granularity(fmt: str) -> Optional[str]:
    return _MONOTONE.get(fmt)


def bucket_range(fmt: str, lit: str):
    """[start, end) of the bucket a formatted literal denotes, as ISO
    strings the temporal-literal parser accepts; None when ``lit`` is not
    a CANONICAL output of ``fmt`` ('2024-1' never equals the zero-padded
    '%Y-%m' output, so the equality can never match)."""
    gran = _MONOTONE.get(fmt)
    if gran is None:
        return None
    try:
        if gran == "year":
            y = int(lit)
            start = datetime.date(y, 1, 1)
            end = f"{y + 1:04d}-01-01"
        elif gran == "month":
            ys, ms = (lit.split("-") if "-" in lit
                      else (lit[:4], lit[4:]))
            y, m = int(ys), int(ms)
            start = datetime.date(y, m, 1)
            ny, nm = (y + 1, 1) if m == 12 else (y, m + 1)
            end = f"{ny:04d}-{nm:02d}-01"
        elif gran == "day":
            start = (datetime.date.fromisoformat(lit) if "-" in lit else
                     datetime.date(int(lit[:4]), int(lit[4:6]),
                                   int(lit[6:])))
            end = (start + datetime.timedelta(days=1)).isoformat()
        else:                       # second granularity
            start = datetime.datetime.fromisoformat(lit.replace("T", " "))
            end = (start + datetime.timedelta(seconds=1)) \
                .strftime("%Y-%m-%d %H:%M:%S")
    except (ValueError, IndexError):
        return None
    # canonical round-trip: the engine compares strings with binary
    # collation, so only the exact formatter output matches
    if mysql_date_format(start, fmt) != lit:
        return None
    if isinstance(start, datetime.datetime):
        return start.strftime("%Y-%m-%d %H:%M:%S"), end
    return start.isoformat(), end


def boundary_bucket_start(fmt: str, lit: str, strict: bool):
    """The start of the SMALLEST bucket whose formatted output is > lit
    (strict) or >= lit (not strict) — lexicographic comparison against an
    ARBITRARY literal, resolved by host-side binary search over days (or
    seconds) since fmt is monotone.  Returns an ISO string, or None when
    every bucket's output satisfies the comparison ('' < everything), or
    "" when none does (lit sorts above every output)."""
    gran = _MONOTONE.get(fmt)
    if gran is None:
        return None
    if gran == "second":
        lo, hi = 0, 253402300800          # [1970, year 10000) in seconds
        def fmt_of(k):
            return mysql_date_format(
                datetime.datetime(1970, 1, 1)
                + datetime.timedelta(seconds=k), fmt)
        def start_of(k):
            return (datetime.datetime(1970, 1, 1)
                    + datetime.timedelta(seconds=k)) \
                .strftime("%Y-%m-%d %H:%M:%S")
    else:
        d0 = datetime.date(1, 1, 1).toordinal()
        lo, hi = d0, datetime.date(9999, 12, 31).toordinal() + 1
        def fmt_of(k):
            return mysql_date_format(datetime.date.fromordinal(k), fmt)
        def start_of(k):
            return datetime.date.fromordinal(k).isoformat()

    def above(k):
        v = fmt_of(k)
        return v > lit if strict else v >= lit
    if above(lo):
        return None                      # all outputs satisfy
    if not above(hi - 1):
        return ""                        # no output satisfies
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if above(mid):
            hi = mid
        else:
            lo = mid
    return start_of(hi)


def parse_radix_literal(s: str, base: int) -> Optional[int]:
    """The int an (in)equality against HEX/BIN/OCT output denotes, or None
    when the literal is not a valid digit string (can never match)."""
    try:
        v = int(s.strip(), base)
    except (ValueError, AttributeError):
        return None
    if v >> 64:
        return None
    # outputs above 2^63-1 print as the two's-complement of a negative
    return v - (1 << 64) if v >= 1 << 63 else v
