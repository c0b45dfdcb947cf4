"""Extended MySQL builtin library (the port of
``baikaldb_tpu/expr/builtins_ext.py``).

Registers scalar builtins into the expression compiler's tables
(expr/compile.py imports this module last).  Implementation styles, as in
the JAX package:

- numeric/temporal: torch elementwise on the batch's device (null
  propagation handled by the ``_SIMPLE`` wrapper);
- string->string / string->scalar: evaluated once per DISTINCT dictionary
  value on the host, then a device gather by code — O(|dict|) host work
  instead of O(rows); each table is kept per dictionary under a key naming
  the function and its literal arguments (``Dictionary.memo``);
- value constants (PI, CURDATE, NOW): read when the query runs.

Functions whose OUTPUT is a data-dependent string set over numbers (HEX of
an integer, BIN, DATE_FORMAT) evaluate at egress in the JAX package and are
not here.
"""

from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import math
import re
import zlib

import numpy as np
import torch

from ..column.batch import Column, to_tensor, torch_dtype
from ..column.dictionary import NULL_CODE, Dictionary, merge
from ..types import LType
from ..utils import datetime_kernels as dtk
from ..utils.hashing import split64
from .ast import Lit
from .compile import (ExprError, HostStr, _TYPE_RULES, _as_days, _const, _dict_scalar,
                      _dict_transform, _eval, _num, _raw, _reg, _str_fn, _take)


# ---------------------------------------------------------------------------
# math

def _unary(fn, domain=None):
    def h(a: Column) -> Column:
        x = _num(a, LType.FLOAT64)
        return Column(fn(x), None if domain is None else domain(x), LType.FLOAT64)
    return h


_reg("asin", _unary(torch.arcsin, domain=lambda x: torch.abs(x) <= 1), LType.FLOAT64)
_reg("acos", _unary(torch.arccos, domain=lambda x: torch.abs(x) <= 1), LType.FLOAT64)
_reg("atan", _unary(torch.arctan), LType.FLOAT64)
_reg("atan2", lambda a, b: Column(torch.arctan2(_num(a, LType.FLOAT64),
                                                _num(b, LType.FLOAT64)),
                                  None, LType.FLOAT64), LType.FLOAT64)
_reg("cot", _unary(lambda x: 1.0 / torch.tan(x)), LType.FLOAT64)
_reg("degrees", _unary(torch.rad2deg), LType.FLOAT64)
_reg("radians", _unary(torch.deg2rad), LType.FLOAT64)
_reg("sinh", _unary(torch.sinh), LType.FLOAT64)
_reg("cosh", _unary(torch.cosh), LType.FLOAT64)
_reg("tanh", _unary(torch.tanh), LType.FLOAT64)


@_raw("pi")
def _pi(e, batch):
    return Column(_const(math.pi, torch.float64, batch), None, LType.FLOAT64)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values held in int64 (the SWAR popcount; torch has
    no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    lo, hi = split64(x)
    return (_popcount32(lo) + _popcount32(hi)).to(torch.int32)


_reg("bit_count", lambda a: Column(_popcount64(_num(a, LType.INT64)), None, LType.INT32),
     LType.INT32)


# LOG with MySQL's two arities: LOG(x) = ln, LOG(b, x) = log_b(x)
@_raw("log")
def _log(e, batch):
    a = _eval(e.args[0], batch)
    if len(e.args) == 1:
        x = _num(a, LType.FLOAT64)
        return Column(torch.log(x), (x > 0) if a.validity is None
                      else a.validity & (x > 0), LType.FLOAT64)
    b = _eval(e.args[1], batch)
    xb = _num(a, LType.FLOAT64)
    xx = _num(b, LType.FLOAT64)
    ok = (xb > 0) & (xb != 1) & (xx > 0)
    v = ok if a.validity is None else a.validity & ok
    if b.validity is not None:
        v = v & b.validity
    return Column(torch.log(xx) / torch.log(xb), v, LType.FLOAT64)


# ---------------------------------------------------------------------------
# string -> string (host over distinct values, device gather)

def _b64d(s: str) -> str:
    try:
        return base64.b64decode(s.encode()).decode("utf-8", "replace")
    except Exception:
        return ""


_str_fn("soundex_lite", lambda s: s[:1].upper() + s[1:4].lower())
_str_fn("md5", lambda s: hashlib.md5(s.encode()).hexdigest())
_str_fn("sha1", lambda s: hashlib.sha1(s.encode()).hexdigest())
_str_fn("hex_str", lambda s: s.encode().hex().upper())
_str_fn("to_base64", lambda s: base64.b64encode(s.encode()).decode())
_str_fn("from_base64", _b64d)


def _lit_str(e, i, name, default=None):
    if i >= len(e.args):
        if default is not None:
            return default
        raise ExprError(f"{name} missing argument {i}")
    a = e.args[i]
    if not isinstance(a, Lit):
        raise ExprError(f"{name} argument {i + 1} must be a literal")
    return a.value


def _str_fn2(name, make):
    """String fn with literal extra args: make(*lits) -> str->str."""
    @_raw(name)
    def h(e, batch, make=make, name=name):
        a = _eval(e.args[0], batch)
        lits = [e.args[i].value if isinstance(e.args[i], Lit) else None
                for i in range(1, len(e.args))]
        if any(x is None for x in lits):
            raise ExprError(f"{name} extra arguments must be literals")
        fn = make(*lits)
        if isinstance(a, HostStr):
            return HostStr(fn(str(a)))
        return _dict_transform(a, fn, (name, *lits))
    return h


def _pad(s: str, n: int, pad: str, left: bool) -> str:
    if len(s) >= n:
        return s[:n]
    if not pad:
        return ""
    fill = (pad * n)[:n - len(s)]
    return fill + s if left else s + fill


def _substring_index(s: str, delim: str, cnt: int) -> str:
    if not delim or cnt == 0:
        return ""
    parts = s.split(delim)
    if cnt > 0:
        return delim.join(parts[:cnt])
    return delim.join(parts[cnt:])


_str_fn2("left", lambda n: lambda s: s[:int(n)] if int(n) > 0 else "")
_str_fn2("right", lambda n: lambda s: s[-int(n):] if int(n) > 0 else "")
_str_fn2("repeat", lambda n: lambda s: s * max(0, int(n)))
_str_fn2("lpad", lambda n, pad: lambda s: _pad(s, int(n), str(pad), True))
_str_fn2("rpad", lambda n, pad: lambda s: _pad(s, int(n), str(pad), False))
_str_fn2("replace", lambda old, new: lambda s: s.replace(str(old), str(new)))
_str_fn2("substring_index",
         lambda delim, cnt: lambda s: _substring_index(s, str(delim), int(cnt)))


@_raw("concat_ws")
def _concat_ws(e, batch):
    """CONCAT_WS skips NULL arguments (it is NULL only for a NULL separator):
    a NULL column lane yields the remaining parts joined, not NULL."""
    sep = str(_lit_str(e, 0, "CONCAT_WS"))
    parts = [_eval(a, batch) for a in e.args[1:]]
    cols = [i for i, p in enumerate(parts) if isinstance(p, Column)]
    if not cols:
        return HostStr(sep.join(str(p) for p in parts))
    if len(cols) > 1:
        raise ExprError("CONCAT_WS of multiple columns is egress-only")
    i = cols[0]
    c = parts[i]
    if c.dictionary is None:
        raise ExprError("CONCAT_WS requires a string column")
    pre = [str(p) for p in parts[:i]]
    post = [str(p) for p in parts[i + 1:]]

    def build():
        with_col = [sep.join(pre + [v] + post) for v in c.dictionary.values]
        without = sep.join(pre + post)      # the column lane was NULL: skipped
        uniq, inv = np.unique(np.asarray(with_col + [without], dtype=str),
                              return_inverse=True)
        return inv.astype(np.int32), Dictionary(uniq)

    inv, d = c.dictionary.memo(("concat_ws", sep, tuple(pre), tuple(post)), build)
    codes = _take(inv[:-1] if len(inv) > 1 else inv, c.data)
    null_sub = int(inv[-1])
    lane_null = ~c.valid_mask() | (c.data == int(NULL_CODE))
    data = torch.where(lane_null, torch.full_like(codes, null_sub), codes)
    return Column(data, None, LType.STRING, d)


# ---------------------------------------------------------------------------
# string -> scalar

def _first_char_code(a: HostStr) -> int:
    return ord(a[0]) if a else 0


@_raw("ascii")
def _ascii(e, batch):
    a = _eval(e.args[0], batch)
    if isinstance(a, HostStr):
        return Column(_const(_first_char_code(a), torch.int64, batch), None, LType.INT64)
    return _dict_scalar(a, lambda s: (s.encode()[0] if s else 0), LType.INT64, ("ascii",))


@_raw("ord")
def _ord(e, batch):
    a = _eval(e.args[0], batch)
    if isinstance(a, HostStr):
        return Column(_const(_first_char_code(a), torch.int64, batch), None, LType.INT64)
    return _dict_scalar(a, lambda s: (ord(s[0]) if s else 0), LType.INT64, ("ord",))


def _scalar_of_str(name, fn, lt=LType.INT64):
    """A raw string->scalar builtin over one string argument."""
    @_raw(name)
    def h(e, batch):
        a = _eval(e.args[0], batch)
        if isinstance(a, HostStr):
            return Column(_const(fn(str(a)), torch_dtype(lt), batch), None, lt)
        return _dict_scalar(a, fn, lt, (name,))
    return h


_scalar_of_str("crc32", lambda s: zlib.crc32(s.encode()))


@_raw("instr")
def _instr(e, batch):
    a = _eval(e.args[0], batch)
    sub = str(_lit_str(e, 1, "INSTR"))
    if isinstance(a, HostStr):
        return Column(_const(str(a).find(sub) + 1, torch.int64, batch), None, LType.INT64)
    return _dict_scalar(a, lambda s: s.find(sub) + 1, LType.INT64, ("instr", sub))


@_raw("locate")
def _locate(e, batch):
    # LOCATE(substr, str [, pos])
    sub = str(_lit_str(e, 0, "LOCATE"))
    a = _eval(e.args[1], batch)
    pos = int(_lit_str(e, 2, "LOCATE", default=1))
    if isinstance(a, HostStr):
        return Column(_const(str(a).find(sub, pos - 1) + 1, torch.int64, batch), None,
                      LType.INT64)
    return _dict_scalar(a, lambda s: s.find(sub, pos - 1) + 1, LType.INT64,
                        ("locate", sub, pos))


def _position_in(items: list):
    def f(s: str) -> int:
        try:
            return items.index(s) + 1
        except ValueError:
            return 0
    return f


@_raw("find_in_set")
def _find_in_set(e, batch):
    a = _eval(e.args[0], batch)
    lst = str(_lit_str(e, 1, "FIND_IN_SET"))
    f = _position_in(lst.split(","))
    if isinstance(a, HostStr):
        return Column(_const(f(str(a)), torch.int64, batch), None, LType.INT64)
    return _dict_scalar(a, f, LType.INT64, ("find_in_set", lst))


@_raw("field")
def _field(e, batch):
    a = _eval(e.args[0], batch)
    items = [str(_lit_str(e, i, "FIELD")) for i in range(1, len(e.args))]
    f = _position_in(items)
    if isinstance(a, HostStr):
        return Column(_const(f(str(a)), torch.int64, batch), None, LType.INT64)
    return _dict_scalar(a, f, LType.INT64, ("field", *items))


def _cmp3(s: str, t: str) -> int:
    return (s > t) - (s < t)


@_raw("strcmp")
def _strcmp(e, batch):
    a = _eval(e.args[0], batch)
    b = _eval(e.args[1], batch)
    if isinstance(a, HostStr) and isinstance(b, HostStr):
        return Column(_const(_cmp3(str(a), str(b)), torch.int32, batch), None, LType.INT32)
    if isinstance(b, HostStr):
        t = str(b)
        return _dict_scalar(a, lambda s: _cmp3(s, t), LType.INT32, ("strcmp", t, 0))
    if isinstance(a, HostStr):
        t = str(a)
        return _dict_scalar(b, lambda s: _cmp3(t, s), LType.INT32, ("strcmp", t, 1))
    if a.dictionary is None or b.dictionary is None:
        raise ExprError("STRCMP requires string columns")
    # align both sides on a merged dictionary: code order == string order
    _, ra, rb = merge(a.dictionary, b.dictionary)
    ca = _take(ra, a.data)
    cb = _take(rb, b.data)
    validity = a.validity
    if b.validity is not None:
        validity = b.validity if validity is None else validity & b.validity
    return Column(torch.sign(ca - cb).to(torch.int32), validity, LType.INT32)


@_raw("regexp_like")
def _regexp_like(e, batch):
    a = _eval(e.args[0], batch)
    pat = str(_lit_str(e, 1, "REGEXP"))
    rx = re.compile(pat)
    if isinstance(a, HostStr):
        return Column(_const(bool(rx.search(str(a))), torch.bool, batch), None, LType.BOOL)
    mask = a.dictionary.memo(("regexp_like", pat), lambda: a.dictionary.match_mask(
        lambda s: rx.search(s) is not None))
    if len(mask) == 0:
        hit = torch.zeros(a.data.shape, dtype=torch.bool, device=a.data.device)
    else:
        hit = _take(mask, a.data)
    return Column(hit, a.validity, LType.BOOL)


def _inet_aton_of(s: str) -> int:
    try:
        parts = [int(x) for x in s.split(".")]
        if len(parts) != 4 or any(p < 0 or p > 255 for p in parts):
            return 0
        return (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
    except ValueError:
        return 0


_scalar_of_str("inet_aton", _inet_aton_of)


# ---------------------------------------------------------------------------
# temporal

_DAYNAMES = np.asarray(["Monday", "Tuesday", "Wednesday", "Thursday",
                        "Friday", "Saturday", "Sunday"])
_MONTHNAMES = np.asarray(["January", "February", "March", "April", "May",
                          "June", "July", "August", "September", "October",
                          "November", "December"])


def _code_string(codes: torch.Tensor, names: np.ndarray, validity) -> Column:
    """Int codes -> a STRING column over a FIXED dictionary (sorted + remap)."""
    order = np.argsort(names, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    remap = to_tensor(rank.astype(np.int32), codes.device)
    return Column(remap[codes.to(torch.int64).clamp(0, len(names) - 1)], validity,
                  LType.STRING, Dictionary(names[order].astype(str)))


@_raw("dayname")
def _dayname(e, batch):
    a = _eval(e.args[0], batch)
    return _code_string(dtk.weekday(_as_days(a)), _DAYNAMES, a.validity)   # 0=Monday


@_raw("monthname")
def _monthname(e, batch):
    a = _eval(e.args[0], batch)
    return _code_string(dtk.month_of_days(_as_days(a)) - 1, _MONTHNAMES, a.validity)


def _week(a: Column, mode: Column | None = None) -> Column:
    """WEEK(d) (mode 0, MySQL's default_week_format) and WEEK(d, mode)."""
    if mode is None:
        return Column(dtk.week_mode0(_as_days(a)), None, LType.INT32)
    return Column(dtk.week(_as_days(a), _num(mode, LType.INT32)), None, LType.INT32)


_reg("week", _week, LType.INT32)
_reg("yearweek", lambda a: Column(
    dtk.year_of_days(_as_days(a)) * 100 + dtk.week_mode0(_as_days(a)), None, LType.INT32),
    LType.INT32)


def _makedate(y: Column, d: Column) -> Column:
    yy = _num(y, LType.INT32)
    one = torch.ones_like(yy)
    days = dtk.days_from_civil(yy, one, one) + _num(d, LType.INT32) - 1
    return Column(days.to(torch.int32), None, LType.DATE)


_reg("makedate", _makedate, LType.DATE)
_reg("time_to_sec", lambda a: Column(
    torch.div(dtk.dt_time_of_day_us(a.data.to(torch.int64)), dtk.US_PER_SEC,
              rounding_mode="floor"), None, LType.INT64), LType.INT64)


def _epoch_days(d: _dt.date) -> int:
    return (d - _dt.date(1970, 1, 1)).days


def _epoch_us(t: _dt.datetime) -> int:
    return int((t - _dt.datetime(1970, 1, 1)).total_seconds() * 1e6)


@_raw("curdate")
def _curdate(e, batch):
    return Column(_const(_epoch_days(_dt.date.today()), torch.int32, batch), None, LType.DATE)


@_raw("now")
def _now(e, batch):
    return Column(_const(_epoch_us(_dt.datetime.now()), torch.int64, batch), None,
                  LType.DATETIME)


@_raw("utc_date")
def _utc_date(e, batch):
    d = _dt.datetime.now(_dt.timezone.utc).date()
    return Column(_const(_epoch_days(d), torch.int32, batch), None, LType.DATE)


# ---------------------------------------------------------------------------
# type rules for everything above

_TYPE_RULES.update({
    "asin": LType.FLOAT64, "acos": LType.FLOAT64, "atan": LType.FLOAT64,
    "atan2": LType.FLOAT64, "cot": LType.FLOAT64, "degrees": LType.FLOAT64,
    "radians": LType.FLOAT64, "sinh": LType.FLOAT64, "cosh": LType.FLOAT64,
    "tanh": LType.FLOAT64, "pi": LType.FLOAT64, "log": LType.FLOAT64,
    "bit_count": LType.INT32,
    "md5": LType.STRING, "sha1": LType.STRING, "hex_str": LType.STRING,
    "to_base64": LType.STRING, "from_base64": LType.STRING,
    "soundex_lite": LType.STRING,
    "left": LType.STRING, "right": LType.STRING, "repeat": LType.STRING,
    "lpad": LType.STRING, "rpad": LType.STRING, "replace": LType.STRING,
    "substring_index": LType.STRING, "concat_ws": LType.STRING,
    "ascii": LType.INT64, "ord": LType.INT64, "crc32": LType.INT64,
    "instr": LType.INT64, "locate": LType.INT64, "find_in_set": LType.INT64,
    "field": LType.INT64, "strcmp": LType.INT32, "regexp_like": LType.BOOL,
    "inet_aton": LType.INT64,
    "dayname": LType.STRING, "monthname": LType.STRING,
    "week": LType.INT32, "yearweek": LType.INT32, "makedate": LType.DATE,
    "time_to_sec": LType.INT64, "curdate": LType.DATE, "now": LType.DATETIME,
    "utc_date": LType.DATE,
})

# the second batch registers the remaining user-facing MySQL surface
from . import builtins_ext2  # noqa: E402,F401  (import for side effects)
