"""Second builtin batch: the remaining user-facing MySQL surface (the port of
``baikaldb_tpu/expr/builtins_ext2.py``).

Same disciplines as builtins_ext (which imports this module last):
numeric/temporal work is torch elementwise on the batch's device; string
work evaluates once per DISTINCT dictionary value on the host and is kept
per dictionary.  STR_TO_DATE goes the feasible direction (string ->
temporal).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json as _json
import re

import numpy as np
import torch

from ..column.batch import Column, torch_dtype
from ..types import LType
from ..utils import datetime_kernels as dtk
from .ast import Lit
from .builtins_ext import _code_string, _epoch_us, _lit_str
from .compile import (ExprError, HostStr, _TYPE_RULES, _as_days, _const, _dict_scalar,
                      _dict_transform, _eval, _raw, _reg, _str_fn, _take,
                      _temporal_hoststr)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


# -- bit operations ---------------------------------------------------------

def _int2(fn):
    def h(a: Column, b: Column) -> Column:
        return Column(fn(a.data.to(torch.int64), b.data.to(torch.int64)), None, LType.INT64)
    return h


def _shift(x: torch.Tensor, n: torch.Tensor, left: bool) -> torch.Tensor:
    """XLA's shifts of int64: a count outside [0, 64) gives 0 for a left
    shift and the sign fill for an (arithmetic) right shift."""
    wide = (n < 0) | (n >= 64)
    k = torch.where(wide, torch.zeros_like(n), n)
    if left:
        return torch.where(wide, torch.zeros_like(x), torch.bitwise_left_shift(x, k))
    fill = torch.where(x < 0, torch.full_like(x, -1), torch.zeros_like(x))
    return torch.where(wide, fill, torch.bitwise_right_shift(x, k))


_reg("bit_and", _int2(torch.bitwise_and), LType.INT64)
_reg("bit_or", _int2(torch.bitwise_or), LType.INT64)
_reg("bit_xor", _int2(torch.bitwise_xor), LType.INT64)
_reg("left_shift", _int2(lambda x, n: _shift(x, n, True)), LType.INT64)
_reg("right_shift", _int2(lambda x, n: _shift(x, n, False)), LType.INT64)
_reg("bit_not", lambda a: Column(~a.data.to(torch.int64), None, LType.INT64), LType.INT64)


@_raw("bit_length")
def _bit_length(e, batch):
    a = _eval(e.args[0], batch)
    if isinstance(a, HostStr):
        return Column(_const(8 * len(str(a).encode()), torch.int64, batch), None, LType.INT64)
    return _dict_scalar(a, lambda s: 8 * len(s.encode()), LType.INT64, ("bit_length",))


# -- temporal arithmetic ----------------------------------------------------

def _tcol(a, batch):
    """Coerce a date-shaped string literal to a temporal Column (raw handlers
    bypass the ``_SIMPLE`` wrapper's implicit cast)."""
    if isinstance(a, HostStr):
        c = _temporal_hoststr(a, batch)
        if c is None:
            raise ExprError(f"not a temporal literal: {a!r}")
        return c
    return a


def _to_us(a: Column):
    if a.ltype is LType.DATE:
        return a.data.to(torch.int64) * dtk.US_PER_DAY
    return a.data.to(torch.int64)


def _date_add_months(a: Column, n: Column) -> Column:
    if a.ltype is LType.DATE:
        return Column(dtk.shift_months(a.data.to(torch.int32), n.data), None, LType.DATE)
    days = dtk.dt_days(a.data)
    tod = dtk.dt_time_of_day_us(a.data)
    nd = dtk.shift_months(days, n.data)
    return Column(nd.to(torch.int64) * dtk.US_PER_DAY + tod, None, a.ltype)


_reg("date_add_months", _date_add_months, lambda ts: ts[0])
_reg("date_sub_months", lambda a, n: _date_add_months(a, Column(-n.data, None, n.ltype)),
     lambda ts: ts[0])


def _date_add_us(a: Column, n: Column) -> Column:
    """Add microseconds; a DATE input becomes a DATETIME (MySQL)."""
    return Column(_to_us(a) + n.data.to(torch.int64), None,
                  LType.DATETIME if a.ltype is LType.DATE else a.ltype)


_reg("date_add_us", _date_add_us,
     lambda ts: LType.DATETIME if ts[0] is LType.DATE else ts[0])
_reg("microsecond", lambda a: Column(
    torch.remainder(dtk.dt_time_of_day_us(_to_us(a)), dtk.US_PER_SEC), None, LType.INT64),
    LType.INT64)
_reg("to_seconds", lambda a: Column(
    _fdiv(_to_us(a), dtk.US_PER_SEC) + 62167219200, None, LType.INT64),
    LType.INT64)   # MySQL: seconds since year 0
_reg("timestampdiff_seconds", lambda a, b: Column(
    _fdiv(_to_us(b) - _to_us(a), dtk.US_PER_SEC), None, LType.INT64), LType.INT64)


@_raw("timestampdiff")
def _timestampdiff(e, batch):
    """TIMESTAMPDIFF(unit, a, b) — the unit arrives as a string literal from
    the parser."""
    unit = _lit_str(e, 0, "timestampdiff")
    a = _tcol(_eval(e.args[1], batch), batch)
    b = _tcol(_eval(e.args[2], batch), batch)
    ua, ub = _to_us(a), _to_us(b)
    per = {"second": dtk.US_PER_SEC, "minute": dtk.US_PER_MIN,
           "hour": dtk.US_PER_HOUR, "day": dtk.US_PER_DAY,
           "week": dtk.US_PER_DAY * 7}
    # as in the JAX package, the result carries no validity: a NULL operand
    # gives the difference of its filler value (ROADMAP, faults)
    if unit in per:
        return Column(_fdiv(ub - ua, per[unit]), None, LType.INT64)
    if unit in ("month", "quarter", "year"):
        da, db = dtk.dt_days(ua), dtk.dt_days(ub)
        ya, ma, _ = dtk.civil_from_days(da)
        yb, mb, _ = dtk.civil_from_days(db)
        months = (yb - ya) * 12 + (mb - ma)
        # partial months don't count (MySQL): back the end off by the month
        # delta and compare the remainder
        rolled = dtk.shift_months(da, months)
        toda = ua - da.to(torch.int64) * dtk.US_PER_DAY
        shifted = rolled.to(torch.int64) * dtk.US_PER_DAY + toda
        # a + months must not overshoot b in either direction (MySQL counts
        # only complete periods)
        months = months - ((months > 0) & (shifted > ub)).to(months.dtype) \
            + ((months < 0) & (shifted < ub)).to(months.dtype)
        div = {"month": 1, "quarter": 3, "year": 12}[unit]
        return Column(_fdiv(months, div).to(torch.int64), None, LType.INT64)
    raise ExprError(f"TIMESTAMPDIFF unit {unit!r} unsupported")


_MYSQL_TO_PYFMT = {
    "Y": "%Y", "y": "%y", "m": "%m", "c": "%m", "d": "%d", "e": "%d",
    "H": "%H", "k": "%H", "h": "%I", "I": "%I", "i": "%M", "s": "%S",
    "S": "%S", "p": "%p", "M": "%B", "b": "%b", "j": "%j", "a": "%a",
    "W": "%A", "T": "%H:%M:%S", "r": "%I:%M:%S %p", "f": "%f", "%": "%%",
}


def _mysql_fmt_to_py(fmt: str) -> str:
    """MySQL DATE_FORMAT/STR_TO_DATE specifiers -> strptime ones (%i is
    minutes, %s seconds, %M the month NAME — all different from Python)."""
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            py = _MYSQL_TO_PYFMT.get(fmt[i + 1])
            if py is None:
                raise ExprError(f"unsupported format specifier %{fmt[i + 1]}")
            out.append(py)
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


@_raw("str_to_date")
def _str_to_date(e, batch):
    """STR_TO_DATE(str_col, fmt) — the feasible (string -> temporal)
    direction; evaluated per distinct dictionary value."""
    fmt = _lit_str(e, 1, "str_to_date")
    a = _eval(e.args[0], batch)
    has_time = any(x in fmt for x in ("%H", "%k", "%h", "%I", "%i", "%s",
                                      "%S", "%T", "%r"))
    pyfmt = _mysql_fmt_to_py(fmt)

    def f(s: str):
        try:
            t = _dt.datetime.strptime(s, pyfmt)
        except ValueError:
            return None
        if has_time:
            return _epoch_us(t)
        return (t.date() - _dt.date(1970, 1, 1)).days

    lt = LType.DATETIME if has_time else LType.DATE
    if isinstance(a, HostStr):
        v = f(str(a))
        if v is None:
            return Column(_const(0, torch_dtype(lt), batch), _const(False, torch.bool, batch),
                          lt)
        return Column(_const(v, torch_dtype(lt), batch), None, lt)

    def build():
        vals = [f(s) for s in a.dictionary.values]
        return (np.asarray([0 if v is None else v for v in vals], lt.np_dtype),
                np.asarray([v is not None for v in vals], bool))

    table, ok = a.dictionary.memo(("str_to_date", fmt), build)
    if len(table) == 0:
        return Column(torch.zeros(a.data.shape, dtype=torch_dtype(lt), device=a.data.device),
                      torch.zeros(a.data.shape, dtype=torch.bool, device=a.data.device), lt)
    good = _take(ok, a.data)
    return Column(_take(table, a.data), good if a.validity is None else a.validity & good,
                  lt)


# -- string functions -------------------------------------------------------

def _unhex(s: str) -> str:
    if len(s) % 2 == 0 and all(c in "0123456789abcdefABCDEF" for c in s):
        return bytes.fromhex(s).decode("utf-8", "replace")
    return ""


_str_fn("quote", lambda s: "'" + s.replace("\\", "\\\\").replace("'", "\\'") + "'")
_str_fn("unhex", _unhex)
_str_fn("sha", lambda s: hashlib.sha1(s.encode()).hexdigest())
_str_fn("sha2", lambda s: hashlib.sha256(s.encode()).hexdigest())


def _soundex(s: str) -> str:
    if not s:
        return ""
    codes = {**dict.fromkeys("bfpv", "1"), **dict.fromkeys("cgjkqsxz", "2"),
             **dict.fromkeys("dt", "3"), "l": "4",
             **dict.fromkeys("mn", "5"), "r": "6"}
    s2 = [c for c in s.lower() if c.isalpha()]
    if not s2:
        return ""
    out = s2[0].upper()
    prev = codes.get(s2[0], "")
    for c in s2[1:]:
        d = codes.get(c, "")
        if d and d != prev:
            out += d
        if c not in "hw":
            prev = d
    return (out + "000")[:4] if len(out) < 4 else out


_str_fn("soundex", _soundex)


def _lit_int(e, i, name):
    a = e.args[i]
    if not isinstance(a, Lit) or isinstance(a.value, str):
        raise ExprError(f"{name} argument {i + 1} must be an integer literal")
    return int(a.value)


def _str_map(e, batch, f, key):
    a = _eval(e.args[0], batch)
    if isinstance(a, HostStr):
        return HostStr(f(str(a)))
    return _dict_transform(a, f, key)


@_raw("split_part")
def _split_part(e, batch):
    delim = _lit_str(e, 1, "split_part")
    n = _lit_int(e, 2, "split_part")

    def f(s: str) -> str:
        if n < 1:
            return ""
        parts = s.split(delim)
        return parts[n - 1] if n <= len(parts) else ""

    return _str_map(e, batch, f, ("split_part", delim, n))


@_raw("insert")
def _insert_fn(e, batch):
    """INSERT(str, pos, len, newstr) with literal pos/len/newstr."""
    pos = _lit_int(e, 1, "insert")
    ln = _lit_int(e, 2, "insert")
    new = _lit_str(e, 3, "insert")

    def f(s: str) -> str:
        if pos < 1 or pos > len(s):
            return s
        return s[:pos - 1] + new + s[pos - 1 + ln:]

    return _str_map(e, batch, f, ("insert", pos, ln, new))


@_raw("regexp_replace")
def _regexp_replace(e, batch):
    pat = _lit_str(e, 1, "regexp_replace")
    rx = re.compile(pat)
    repl = _lit_str(e, 2, "regexp_replace")
    return _str_map(e, batch, lambda s: rx.sub(repl, s), ("regexp_replace", pat, repl))


@_raw("elt")
def _elt(e, batch):
    """ELT(n, s1, s2, ...) with literal strings: a static dictionary of the
    choices, device select by n."""
    n = _eval(e.args[0], batch)
    choices = [_lit_str(e, i, "elt") for i in range(1, len(e.args))]
    idx = n.data.to(torch.int32) - 1
    good = (idx >= 0) & (idx < len(choices))
    validity = good if n.validity is None else (n.validity & good)
    return _code_string(idx.clamp(0, len(choices) - 1), np.asarray(choices, dtype=object),
                        validity)


@_raw("space")
def _space(e, batch):
    return HostStr(" " * _lit_int(e, 0, "space"))


# -- JSON -------------------------------------------------------------------

def _json_parse(s: str):
    try:
        return _json.loads(s), True
    except (ValueError, TypeError):
        return None, False


@_raw("json_valid")
def _json_valid(e, batch):
    a = _eval(e.args[0], batch)

    def f(s):
        return 1 if _json_parse(s)[1] else 0

    if isinstance(a, HostStr):
        return Column(_const(bool(f(str(a))), torch.bool, batch), None, LType.BOOL)
    c = _dict_scalar(a, f, LType.INT8, ("json_valid",))
    return Column(c.data.to(torch.bool), c.validity, LType.BOOL)


def _json_type_of(s: str) -> str:
    v, ok = _json_parse(s)
    if not ok:
        return "INVALID"
    return {dict: "OBJECT", list: "ARRAY", str: "STRING", bool: "BOOLEAN",
            int: "INTEGER", float: "DOUBLE", type(None): "NULL"}[type(v)]


@_raw("json_type")
def _json_type(e, batch):
    return _str_map(e, batch, _json_type_of, ("json_type",))


def _json_path_get(v, path: str):
    """Subset of MySQL JSON paths: $.a.b[0].c"""
    if not path.startswith("$"):
        return None
    cur = v
    for key, idx in re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]", path[1:]):
        if key:
            if not isinstance(cur, dict) or key not in cur:
                return None
            cur = cur[key]
        else:
            i = int(idx)
            if not isinstance(cur, list) or i >= len(cur):
                return None
            cur = cur[i]
    return cur


@_raw("json_extract")
def _json_extract(e, batch):
    path = _lit_str(e, 1, "json_extract")

    def f(s: str) -> str:
        v, ok = _json_parse(s)
        if not ok:
            return ""
        got = _json_path_get(v, path)
        return "" if got is None else _json.dumps(got)

    return _str_map(e, batch, f, ("json_extract", path))


def _json_unquote_of(s: str) -> str:
    v, ok = _json_parse(s)
    return v if ok and isinstance(v, str) else s


@_raw("json_unquote")
def _json_unquote(e, batch):
    return _str_map(e, batch, _json_unquote_of, ("json_unquote",))


# -- collation (utf8mb4_general_ci comparisons) -----------------------------

@_raw("__collate_ci")
def _collate_ci(e, batch):
    """Case-insensitive collation marker: fold the value; the parser wraps
    BOTH sides of a comparison when either carries COLLATE *_ci, so
    comparisons/sorts against the folded dictionary are CI."""
    return _str_map(e, batch, str.casefold, ("__collate_ci",))


_reg("weekofyear", lambda a: Column(dtk.iso_week(_as_days(a)), None, LType.INT32),
     LType.INT32)


@_raw("utc_timestamp")
def _utc_timestamp(e, batch):
    t = _dt.datetime.now(_dt.timezone.utc).replace(tzinfo=None)
    return Column(_const(_epoch_us(t), torch.int64, batch), None, LType.DATETIME)


def _period_to_months(p):
    """MySQL period YYYYMM (or YYMM) -> absolute months."""
    y = _fdiv(p, 100)
    y = torch.where(y < 70, y + 2000, torch.where(y < 100, y + 1900, y))
    return y * 12 + torch.remainder(p, 100) - 1


def _months_to_period(m):
    return _fdiv(m, 12) * 100 + torch.remainder(m, 12) + 1


_reg("period_add", lambda p, n: Column(
    _months_to_period(_period_to_months(p.data.to(torch.int64)) + n.data.to(torch.int64)),
    None, LType.INT64), LType.INT64)
_reg("period_diff", lambda a, b: Column(
    _period_to_months(a.data.to(torch.int64)) - _period_to_months(b.data.to(torch.int64)),
    None, LType.INT64), LType.INT64)


@_raw("make_set")
def _make_set(e, batch):
    """MAKE_SET(bits, s1, s2, ...) with literal strings: the 2**k possible
    outputs form a static dictionary, the bits column selects."""
    bits = _eval(e.args[0], batch)
    # a SQL NULL literal is skipped, as MySQL's MAKE_SET does; numeric
    # literals become strings
    strs = [_lit_str(e, i, "make_set") for i in range(1, len(e.args))]
    strs = [None if v is None else str(v) for v in strs]
    if len(strs) > 16:
        raise ExprError("MAKE_SET supports up to 16 literal strings")
    combos = np.asarray([",".join(s for j, s in enumerate(strs)
                                  if (m >> j & 1) and s is not None)
                         for m in range(1 << len(strs))], dtype=object)
    idx = (bits.data.to(torch.int64) & ((1 << len(strs)) - 1)).to(torch.int32)
    return _code_string(idx, combos, bits.validity)


@_raw("export_set")
def _export_set(e, batch):
    """EXPORT_SET(bits, on, off [, sep [, n_bits]]) with literals."""
    bits = _eval(e.args[0], batch)
    on = _lit_str(e, 1, "export_set")
    off = _lit_str(e, 2, "export_set")
    sep = _lit_str(e, 3, "export_set") if len(e.args) > 3 else ","
    nb = _lit_int(e, 4, "export_set") if len(e.args) > 4 else 64
    if not 1 <= nb <= 16:
        raise ExprError("EXPORT_SET supports 1..16 bits (a wider set would need a "
                        "2^n-entry static dictionary)")
    combos = np.asarray([sep.join(on if m >> j & 1 else off for j in range(nb))
                         for m in range(1 << nb)], dtype=object)
    idx = (bits.data.to(torch.int64) & ((1 << nb) - 1)).to(torch.int32)
    return _code_string(idx, combos, bits.validity)


@_raw("convert_tz")
def _convert_tz(e, batch):
    """CONVERT_TZ(dt, from, to) with literal '+HH:MM' offsets."""
    def off_us(s: str) -> int:
        s = s.strip()
        sign = -1 if s.startswith("-") else 1
        hh, mm = s.lstrip("+-").split(":")
        return sign * (int(hh) * 3600 + int(mm) * 60) * dtk.US_PER_SEC

    a = _tcol(_eval(e.args[0], batch), batch)
    frm = _lit_str(e, 1, "convert_tz")
    to = _lit_str(e, 2, "convert_tz")
    try:
        delta = off_us(to) - off_us(frm)
    except (ValueError, IndexError):
        raise ExprError("CONVERT_TZ supports literal '+HH:MM' offsets")
    return Column(_to_us(a) + delta, a.validity,
                  LType.DATETIME if a.ltype is LType.DATE else a.ltype)


# -- misc -------------------------------------------------------------------

@_raw("version")
def _version(e, batch):
    return HostStr("8.0.0-baikaldb-tpu")


@_raw("connection_id")
def _connection_id(e, batch):
    return Column(_const(0, torch.int64, batch), None, LType.INT64)


_TYPE_RULES.update({
    "bit_and": LType.INT64, "bit_or": LType.INT64, "bit_xor": LType.INT64,
    "bit_not": LType.INT64, "left_shift": LType.INT64,
    "right_shift": LType.INT64, "bit_length": LType.INT64,
    "microsecond": LType.INT64, "to_seconds": LType.INT64,
    "timestampdiff": LType.INT64, "str_to_date": LType.DATE,
    "quote": LType.STRING, "unhex": LType.STRING, "sha": LType.STRING,
    "sha2": LType.STRING, "soundex": LType.STRING,
    "split_part": LType.STRING, "insert": LType.STRING,
    "regexp_replace": LType.STRING, "elt": LType.STRING,
    "space": LType.STRING, "json_valid": LType.BOOL,
    "json_type": LType.STRING, "json_extract": LType.STRING,
    "json_unquote": LType.STRING, "__collate_ci": LType.STRING,
    "version": LType.STRING, "connection_id": LType.INT64,
    "weekofyear": LType.INT32, "utc_timestamp": LType.DATETIME,
    "period_add": LType.INT64, "period_diff": LType.INT64,
    "make_set": LType.STRING, "export_set": LType.STRING,
    "convert_tz": lambda ts: (LType.DATETIME if not ts or
                              ts[0] in (LType.DATE, LType.STRING)
                              else ts[0]),
    "date_add_months": lambda ts: ts[0],
    "date_sub_months": lambda ts: ts[0],
    "date_add_us": lambda ts: (LType.DATETIME if ts[0] is LType.DATE
                               else ts[0]),
})
