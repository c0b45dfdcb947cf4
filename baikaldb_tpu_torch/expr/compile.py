"""Expression -> torch lowering (the port of ``baikaldb_tpu/expr/compile.py``).

``eval_expr`` walks an expression tree over a :class:`ColumnBatch` and
returns a :class:`Column` of tensors on the batch's device.  Semantics follow
the JAX compiler exactly:

- MySQL NULL semantics: values are (data, validity) pairs; the default rule
  makes a result row NULL if any input is NULL, with Kleene logic for
  AND/OR and explicit handlers for IS NULL / COALESCE / CASE / IFNULL.
- Type promotion is the compiler's own (``types.promote``): every operand is
  cast to the promoted type's physical dtype before the operation, so torch's
  default promotion never decides a result type.  ``v * 2 + 1`` over a FLOAT
  column is float32 arithmetic compared in float64, as in the JAX package.
- String ops run on dictionary codes: comparisons against literals become
  integer range tests; per-value functions are host-side maps over the
  distinct values, gathered by code on the device, and each such table is
  kept per dictionary (``Dictionary.memo``).

The extended builtin library (``builtins_ext.py``, ``builtins_ext2.py``)
registers itself into the tables below.  ``MATCH ... AGAINST`` (full-text
search) is not ported: it raises :class:`NotPortedError`.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..column.batch import Column, ColumnBatch, to_tensor, torch_dtype
from ..column.dictionary import NULL_CODE, Dictionary, merge as dict_merge
from ..errors import NotPortedError
from ..types import LType, promote
from ..utils import datetime_kernels as dtk
from .ast import AggCall, Call, ColRef, Expr, Lit, Param
from .params import ParamStrBounds, current_param


class HostStr(str):
    """A string literal travelling through the compiler (host-side value)."""


class ExprError(ValueError):
    pass


# ----------------------------------------------------------------------
# entry points


def eval_expr(e: Expr, batch: ColumnBatch) -> Column:
    """Lower expression to torch ops over `batch`; returns a Column (data may
    be 0-d for constant expressions)."""
    r = _eval(e, batch)
    if isinstance(r, HostStr):
        raise ExprError(f"string-valued expression {e!r} must be consumed by a "
                        "string-aware operator (comparison/LIKE/IN) or egress")
    if isinstance(r, ParamStrBounds):
        raise ExprError(f"string param in {e!r} is only valid as a direct "
                        "comparison operand")
    return r


def eval_output(e: Expr, batch: ColumnBatch) -> Column:
    """Like eval_expr, but a string-literal result becomes a constant
    dictionary column (for SELECT 'x' projections / egress)."""
    r = _eval(e, batch)
    if isinstance(r, HostStr):
        d = Dictionary(np.asarray([str(r)], dtype=str))
        return Column(_const(0, torch.int32, batch), None, LType.STRING, d)
    return r


def eval_predicate(e: Expr, batch: ColumnBatch) -> torch.Tensor:
    """Lower a predicate to a bool mask; NULL -> False (MySQL WHERE)."""
    c = eval_expr(e, batch)
    m = c.data.to(torch.bool)
    if c.validity is not None:
        m = m & c.validity
    if m.ndim == 0:
        m = m.expand(len(batch))
    return m


def infer_type(e: Expr, schema) -> LType:
    """Static result type of e against a Schema (no device work)."""
    if isinstance(e, ColRef):
        return schema.field(e.name).ltype
    if isinstance(e, Lit):
        return _lit_type(e)
    if isinstance(e, Param):
        if e.ltype is None:
            raise ExprError(f"untyped param {e!r}")
        return e.ltype
    if isinstance(e, AggCall):
        from ..ops.hashagg import agg_result_type
        at = infer_type(e.args[0], schema) if e.args else LType.INT64
        return agg_result_type(e.op, at)
    if isinstance(e, Call):
        if e.op == "cast":
            t = e.args[1]
            if not isinstance(t, Lit):
                raise ExprError("CAST target must be a type literal")
            return t.value if isinstance(t.value, LType) else LType(t.value)
        rule = _TYPE_RULES.get(e.op)
        argts = [infer_type(a, schema) for a in e.args]
        if rule is None:
            return _default_type_rule(e.op, argts)
        return rule(argts) if callable(rule) else rule
    raise ExprError(f"cannot infer type of {e!r}")


# ----------------------------------------------------------------------
# internals


def _const(v, dtype, batch: ColumnBatch) -> torch.Tensor:
    """A 0-d constant on the batch's device."""
    if batch.device is None:
        raise ExprError("batch has no device for a constant")
    return torch.tensor(v, dtype=dtype, device=batch.device)


def _take(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """Gather a host per-code table by (clipped) device codes."""
    t = to_tensor(table, codes.device)
    return t[codes.to(torch.int64).clamp(0, max(len(table) - 1, 0))]


def _lit_type(e: Lit) -> LType:
    if e.ltype is not None:
        return e.ltype
    v = e.value
    if v is None:
        return LType.NULL
    if isinstance(v, bool):
        return LType.BOOL
    if isinstance(v, int):
        return LType.INT64
    if isinstance(v, float):
        return LType.FLOAT64
    if isinstance(v, str):
        return LType.STRING
    raise ExprError(f"unsupported literal {v!r}")


def _eval(e: Expr, batch: ColumnBatch):
    if isinstance(e, ColRef):
        return batch.column(e.name)
    if isinstance(e, Lit):
        lt = _lit_type(e)
        if lt is LType.NULL:
            return Column(_const(0, torch.int32, batch),
                          _const(False, torch.bool, batch), LType.NULL)
        if lt is LType.STRING:
            return HostStr(e.value)
        return Column(_const(e.value, torch_dtype(lt), batch), None, lt)
    if isinstance(e, Param):
        v = current_param(e.index)
        if e.kind == "strcmp":
            # [2] for one query, [G, 2] for a lane-batched tick
            if v.ndim == 1:
                return ParamStrBounds(v[0], v[1])
            return ParamStrBounds(v[:, 0:1], v[:, 1:2])
        return Column(v, None, e.ltype)
    if isinstance(e, AggCall):
        raise ExprError(f"aggregate {e!r} must be hoisted by the planner")
    if isinstance(e, Call):
        h = _RAW.get(e.op)
        if h is not None:
            return h(e, batch)
        h = _SIMPLE.get(e.op)
        if h is None and e.op in _EGRESS_ONLY:
            raise ExprError(f"no type rule for {e.op!r}")
        if h is None:
            raise NotPortedError(f"builtin function {e.op!r}")
        args = [_eval(a, batch) for a in e.args]
        args = [_devalue_hoststr(a, e.op, batch) for a in args]
        return _with_null_prop(h, args)
    raise ExprError(f"cannot evaluate {e!r}")


# functions whose arguments MySQL implicitly casts string->temporal
_TEMPORAL_ARG_FNS = {
    "year", "month", "day", "dayofmonth", "quarter", "dayofweek", "weekday",
    "dayofyear", "last_day", "week", "yearweek", "weekofyear", "datediff",
    "date", "to_days", "unix_timestamp", "time_to_sec", "date_add_days",
    "date_sub_days", "date_add_months", "date_sub_months", "date_add_us",
    "microsecond", "to_seconds", "greatest", "least",
}


def _devalue_hoststr(a, op, batch):
    if isinstance(a, ParamStrBounds):
        raise ExprError(f"string param not supported as argument of {op!r}; "
                        "valid only as a direct comparison operand")
    if isinstance(a, HostStr):
        if op in _TEMPORAL_ARG_FNS:
            c = _temporal_hoststr(a, batch)
            if c is not None:
                return c    # MySQL implicit string->temporal cast
        raise ExprError(f"string literal not supported as argument of {op!r} "
                        "(device path); handled only in comparisons/LIKE/IN")
    return a


def _temporal_hoststr(a, batch) -> Optional[Column]:
    """A date/datetime-shaped string literal as a temporal scalar Column."""
    s = str(a).strip()
    lt = LType.DATE if len(s) <= 10 else LType.DATETIME
    try:
        v = parse_temporal(s, lt)
    except (ValueError, ExprError):
        return None
    return Column(_const(v, torch_dtype(lt), batch), None, lt)


def _with_null_prop(h, args: list[Column]) -> Column:
    out = h(*args)
    vs = [a.validity for a in args if a.validity is not None]
    if out.validity is not None:
        vs.append(out.validity)
    validity = None
    for v in vs:
        validity = v if validity is None else validity & v
    return replace(out, validity=validity)


def _num(c: Column, lt: LType) -> torch.Tensor:
    """Cast data to the physical dtype of lt."""
    return c.data.to(torch_dtype(lt))


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def cast_column(c: Column, lt: LType) -> Column:
    """Implicit/explicit cast."""
    if c.ltype == lt:
        return c
    if c.ltype is LType.STRING:
        if lt.is_numeric:
            if c.dictionary is None:
                raise ExprError("cast string->numeric requires a dictionary")
            table = c.dictionary.map_values(_mysql_str_to_num, lt.np_dtype)
            # NULL codes clip to 0 but validity already marks them invalid
            return Column(_take(table, c.data), c.validity, lt)
        raise ExprError(f"unsupported cast string->{lt}")
    if lt is LType.STRING:
        raise ExprError("cast ->string is egress-only (host)")
    if c.ltype is LType.DATE and lt in (LType.DATETIME, LType.TIMESTAMP):
        return Column(c.data.to(torch.int64) * dtk.US_PER_DAY, c.validity, lt)
    if c.ltype in (LType.DATETIME, LType.TIMESTAMP) and lt is LType.DATE:
        return Column(dtk.dt_days(c.data), c.validity, lt)
    return Column(_num(c, lt), c.validity, lt)


def _mysql_str_to_num(s: str):
    """MySQL-style leading-numeric parse ('12abc' -> 12, 'x' -> 0)."""
    m = re.match(r"\s*[-+]?\d*\.?\d+(e[-+]?\d+)?", s, re.I)
    return float(m.group(0)) if m and m.group(0).strip() else 0.0


def parse_temporal(s: str, lt: LType) -> int:
    """'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' -> epoch days (DATE) or micros."""
    import datetime as _dt

    s = s.strip()
    try:
        if len(s) <= 10:
            d = _dt.date.fromisoformat(s)
            t = _dt.datetime(d.year, d.month, d.day)
        else:
            t = _dt.datetime.fromisoformat(s.replace("/", "-"))
    except ValueError as exc:
        raise ExprError(f"cannot parse temporal literal {s!r}") from exc
    days = (t.date() - _dt.date(1970, 1, 1)).days
    if lt is LType.DATE:
        return days
    return days * dtk.US_PER_DAY + (t.hour * 3600 + t.minute * 60 + t.second) \
        * dtk.US_PER_SEC + t.microsecond


# ----------------------------------------------------------------------
# simple (null-propagating) builtins


def _ranked(lt):
    return lt in (LType.INT8, LType.INT16, LType.INT32, LType.BOOL)


def _binary_arith(op_name, fn):
    def h(a: Column, b: Column) -> Column:
        lt = promote(a.ltype, b.ltype)
        if op_name in ("add", "sub", "mul") and lt.is_integer and lt is not LType.UINT64:
            lt = LType.INT64 if _ranked(lt) else lt
        return Column(fn(_num(a, lt), _num(b, lt)), None, lt)
    return h


def _div(a: Column, b: Column) -> Column:
    y = _num(b, LType.FLOAT64)
    x = _num(a, LType.FLOAT64)
    nz = y != 0
    return Column(x / torch.where(nz, y, torch.ones_like(y)), nz, LType.FLOAT64)


def _int_div(a: Column, b: Column) -> Column:
    lt = LType.INT64
    x, y = _num(a, lt), _num(b, lt)
    nz = y != 0
    return Column(_fdiv(x, torch.where(nz, y, torch.ones_like(y))), nz, lt)


def _mod(a: Column, b: Column) -> Column:
    """MySQL MOD: C fmod semantics — result takes the dividend's sign."""
    lt = promote(a.ltype, b.ltype)
    if lt.is_integer:
        lt = LType.INT64
    x, y = _num(a, lt), _num(b, lt)
    nz = y != 0
    safe = torch.where(nz, y, torch.ones_like(y))
    if lt.is_float:
        q = torch.trunc(x / safe)
    else:
        q = torch.sign(x) * torch.sign(safe) * _fdiv(torch.abs(x), torch.abs(safe))
    return Column(x - q * safe, nz, lt)


def _unary_math(fn, out=LType.FLOAT64, domain=None):
    def h(a: Column) -> Column:
        x = _num(a, out if out.is_float else a.ltype)
        ok = domain(x) if domain is not None else None
        if ok is not None:
            x = torch.where(ok, x, torch.ones_like(x))
        return Column(fn(x), ok, out)
    return h


def _round_half_away(x, d):
    s = 10.0 ** d
    y = x * s
    return torch.trunc(y + torch.sign(y) * 0.5) / s


_SIMPLE = {}
_TYPE_RULES = {}


def _reg(name, h, trule=None):
    _SIMPLE[name] = h
    if trule is not None:
        _TYPE_RULES[name] = trule


def _neg(a: Column) -> Column:
    if a.ltype.is_float:
        return Column(-a.data, None, a.ltype)
    return Column(-_num(a, LType.INT64), None, LType.INT64)


def _int_of_float(fn):
    return lambda a: Column(fn(_num(a, LType.FLOAT64)).to(torch.int64), None, LType.INT64)


_reg("add", _binary_arith("add", torch.add))
_reg("sub", _binary_arith("sub", torch.sub))
_reg("mul", _binary_arith("mul", torch.mul))
_reg("div", _div, LType.FLOAT64)
_reg("int_div", _int_div, LType.INT64)
_reg("mod", _mod)
_reg("neg", _neg)
_reg("abs", lambda a: Column(torch.abs(a.data), None, a.ltype))
_reg("ceil", _int_of_float(torch.ceil), LType.INT64)
_reg("floor", _int_of_float(torch.floor), LType.INT64)
_reg("sqrt", _unary_math(torch.sqrt, domain=lambda x: x >= 0), LType.FLOAT64)
_reg("exp", _unary_math(torch.exp), LType.FLOAT64)
_reg("ln", _unary_math(torch.log, domain=lambda x: x > 0), LType.FLOAT64)
_reg("log10", _unary_math(torch.log10, domain=lambda x: x > 0), LType.FLOAT64)
_reg("log2", _unary_math(torch.log2, domain=lambda x: x > 0), LType.FLOAT64)
_reg("sin", _unary_math(torch.sin), LType.FLOAT64)
_reg("cos", _unary_math(torch.cos), LType.FLOAT64)
_reg("tan", _unary_math(torch.tan), LType.FLOAT64)
_reg("sign", lambda a: Column(torch.sign(_num(a, LType.FLOAT64)).to(torch.int32),
                              None, LType.INT32), LType.INT32)
_reg("pow", lambda a, b: Column(torch.pow(_num(a, LType.FLOAT64), _num(b, LType.FLOAT64)),
                                None, LType.FLOAT64), LType.FLOAT64)


def _round(a: Column, d: Column | None = None) -> Column:
    if a.ltype.is_integer:
        if d is None:
            return Column(a.data, None, a.ltype)
        # ROUND(int, -n) buckets to powers of ten (MySQL: ROUND(15,-1)=20)
        r = _round_half_away(_num(a, LType.FLOAT64), d.data.to(torch.float64))
        return Column(r.to(torch.int64), None, LType.INT64)
    nd = d.data.to(torch.float64) if d is not None else 0
    return Column(_round_half_away(_num(a, LType.FLOAT64), nd), None, LType.FLOAT64)


def _truncate(a: Column, d: Column) -> Column:
    s = 10.0 ** d.data.to(torch.float64)
    x = _num(a, LType.FLOAT64)
    return Column(torch.trunc(x * s) / s, None, LType.FLOAT64)


def _varargs_minmax(cs, fn):
    lt = cs[0].ltype
    for c in cs[1:]:
        lt = promote(lt, c.ltype)
    out = _num(cs[0], lt)
    for c in cs[1:]:
        out = fn(out, _num(c, lt))
    return Column(out, None, lt)


_reg("round", _round)
_reg("truncate", _truncate, LType.FLOAT64)
_reg("greatest", lambda *cs: _varargs_minmax(cs, torch.maximum))
_reg("least", lambda *cs: _varargs_minmax(cs, torch.minimum))


# temporal ---------------------------------------------------------------


def _as_days(c: Column):
    if c.ltype is LType.DATE:
        return c.data.to(torch.int32)
    if c.ltype in (LType.DATETIME, LType.TIMESTAMP):
        return dtk.dt_days(c.data)
    raise ExprError(f"temporal function on non-temporal {c.ltype}")


def _dt_part(fn):
    return lambda a: Column(fn(_as_days(a)), None, LType.INT32)


_reg("year", _dt_part(dtk.year_of_days), LType.INT32)
_reg("month", _dt_part(dtk.month_of_days), LType.INT32)
_reg("day", _dt_part(dtk.day_of_days), LType.INT32)
_reg("dayofmonth", _dt_part(dtk.day_of_days), LType.INT32)
_reg("quarter", _dt_part(dtk.quarter_of_days), LType.INT32)
_reg("dayofweek", _dt_part(dtk.day_of_week), LType.INT32)
_reg("weekday", _dt_part(dtk.weekday), LType.INT32)
_reg("dayofyear", _dt_part(dtk.day_of_year), LType.INT32)
_reg("last_day", lambda a: Column(dtk.last_day(_as_days(a)), None, LType.DATE), LType.DATE)
_reg("to_days", lambda a: Column(_as_days(a).to(torch.int64) + 719528, None, LType.INT64),
     LType.INT64)
_reg("date", lambda a: Column(_as_days(a), None, LType.DATE), LType.DATE)
_reg("datediff", lambda a, b: Column((_as_days(a) - _as_days(b)).to(torch.int64), None,
                                     LType.INT64), LType.INT64)


def _time_part(unit, modulo):
    def h(a):
        v = _fdiv(dtk.dt_time_of_day_us(a.data), unit)
        if modulo:
            v = torch.remainder(v, modulo)
        return Column(v.to(torch.int32), None, LType.INT32)
    return h


_reg("hour", _time_part(dtk.US_PER_HOUR, 0), LType.INT32)
_reg("minute", _time_part(dtk.US_PER_MIN, 60), LType.INT32)
_reg("second", _time_part(dtk.US_PER_SEC, 60), LType.INT32)


def _date_shift(sign):
    def h(a: Column, n: Column) -> Column:
        if a.ltype is LType.DATE:
            return Column(a.data + sign * n.data.to(torch.int32), None, LType.DATE)
        return Column(a.data + sign * n.data.to(torch.int64) * dtk.US_PER_DAY, None, a.ltype)
    return h


def _unix_timestamp(a: Column) -> Column:
    us = a.data.to(torch.int64) * dtk.US_PER_DAY if a.ltype is LType.DATE else a.data
    return Column(_fdiv(us, dtk.US_PER_SEC), None, LType.INT64)


_reg("date_add_days", _date_shift(1))
_reg("date_sub_days", _date_shift(-1))
_reg("unix_timestamp", _unix_timestamp, LType.INT64)
_reg("from_unixtime", lambda a: Column(_num(a, LType.INT64) * dtk.US_PER_SEC, None,
                                       LType.DATETIME), LType.DATETIME)

_TYPE_RULES.update({
    "div": LType.FLOAT64, "int_div": LType.INT64,
    "add": lambda ts: promote(ts[0], ts[1]),
    "sub": lambda ts: promote(ts[0], ts[1]),
    "mul": lambda ts: promote(ts[0], ts[1]),
    "mod": lambda ts: promote(ts[0], ts[1]),
    "neg": lambda ts: ts[0] if ts[0].is_float else LType.INT64,
    "abs": lambda ts: ts[0],
    "round": lambda ts: ts[0] if ts[0].is_integer else LType.FLOAT64,
    "greatest": lambda ts: _fold_promote(ts), "least": lambda ts: _fold_promote(ts),
    "date_add_days": lambda ts: ts[0], "date_sub_days": lambda ts: ts[0],
})


def _fold_promote(ts):
    lt = ts[0]
    for t in ts[1:]:
        lt = promote(lt, t)
    return lt


def _default_type_rule(op, argts):
    rules = {
        "eq": LType.BOOL, "ne": LType.BOOL, "lt": LType.BOOL, "le": LType.BOOL,
        "gt": LType.BOOL, "ge": LType.BOOL, "and": LType.BOOL, "or": LType.BOOL,
        "not": LType.BOOL, "xor": LType.BOOL, "is_null": LType.BOOL,
        "is_not_null": LType.BOOL, "like": LType.BOOL, "not_like": LType.BOOL,
        "__row_index": LType.INT64,
        "in": LType.BOOL, "not_in": LType.BOOL, "between": LType.BOOL,
        "match_against": LType.FLOAT32,
        "case_when": argts[1] if len(argts) > 1 else LType.NULL,
        "if": argts[1] if len(argts) > 1 else LType.NULL,
        "ifnull": argts[0] if argts else LType.NULL,
        "nullif": argts[0] if argts else LType.NULL,
        "coalesce": argts[0] if argts else LType.NULL,
        "length": LType.INT64, "char_length": LType.INT64,
        "upper": LType.STRING, "lower": LType.STRING, "trim": LType.STRING,
        "ltrim": LType.STRING, "rtrim": LType.STRING, "reverse": LType.STRING,
        "substr": LType.STRING, "concat": LType.STRING,
        "hash": LType.INT64,
    }
    if op in rules:
        return rules[op]
    if op in _EGRESS_ONLY:
        raise ExprError(f"no type rule for {op!r}")
    raise NotPortedError(f"builtin function {op!r}")


# builtins that exec/egress.py evaluates on the host over a result: where one
# reaches a device expression (a subquery, a derived table) the JAX package's
# compiler has no type rule for it either
_EGRESS_ONLY = frozenset({"date_format", "format", "bin", "oct"})


# ----------------------------------------------------------------------
# raw handlers (custom null semantics / string-aware / host literals)

_RAW = {}


def _raw(name):
    def deco(fn):
        _RAW[name] = fn
        return fn
    return deco


_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
        "le": torch.le, "gt": torch.gt, "ge": torch.ge}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}


def _make_cmp(op):
    def h(e: Call, batch: ColumnBatch) -> Column:
        return _compare(op, _eval(e.args[0], batch), _eval(e.args[1], batch), batch)
    return h


for _op in _CMP:
    _RAW[_op] = _make_cmp(_op)


def _compare(op, a, b, batch) -> Column:
    if isinstance(a, ParamStrBounds) or isinstance(b, ParamStrBounds):
        flip = isinstance(a, ParamStrBounds)
        colc, pb = (b, a) if flip else (a, b)
        if flip:
            op = _FLIP.get(op, op)
        if not (isinstance(colc, Column) and colc.ltype is LType.STRING
                and colc.dictionary is not None):
            raise ExprError("string param requires a dictionary-encoded "
                            "string column operand")
        return _cmp_code_bounds(op, colc, pb.lo, pb.hi)
    if isinstance(a, HostStr) and isinstance(b, HostStr):
        r = {"eq": a == b, "ne": a != b, "lt": a < b, "le": a <= b,
             "gt": a > b, "ge": a >= b}[op]
        return Column(_const(r, torch.bool, batch), None, LType.BOOL)
    if isinstance(b, HostStr) or isinstance(a, HostStr):
        flip = isinstance(a, HostStr)
        colc, s = (b, a) if flip else (a, b)
        if flip:
            op = _FLIP.get(op, op)
        if colc.ltype is LType.STRING and colc.dictionary is not None:
            return _cmp_code_literal(op, colc, str(s))
        if colc.ltype.is_temporal:
            # WHERE date_col >= '2024-01-01': parse the literal as a date
            litv = parse_temporal(str(s), colc.ltype)
            b = Column(_const(litv, torch_dtype(colc.ltype), batch), None, colc.ltype)
        else:
            # MySQL: numeric vs string compares as double
            b = Column(_const(_mysql_str_to_num(str(s)), torch.float64, batch),
                       None, LType.FLOAT64)
        a = colc
    if a.ltype is LType.STRING or b.ltype is LType.STRING:
        if a.ltype is LType.STRING and b.ltype is LType.STRING:
            a, b = _align_string_columns(a, b)
            x, y = a.data, b.data
        else:
            sc = a if a.ltype is LType.STRING else b
            oc = b if a.ltype is LType.STRING else a
            sc = cast_column(sc, LType.FLOAT64)
            a, b = (sc, oc) if a.ltype is LType.STRING else (oc, sc)
            x, y = _num(a, LType.FLOAT64), _num(b, LType.FLOAT64)
    else:
        lt = promote(a.ltype, b.ltype)
        x, y = _num(a, lt), _num(b, lt)
    out = Column(_CMP[op](x, y), None, LType.BOOL)
    return _with_null_prop(lambda *_: out, [a, b])


def _cmp_code_literal(op, c: Column, s: str) -> Column:
    d = c.dictionary
    return _cmp_code_bounds(op, c, d.lower_bound(s), d.upper_bound(s))


def _cmp_code_bounds(op, c: Column, lo, hi) -> Column:
    """Range test over dictionary codes [lo, hi) of the compared value."""
    codes = c.data
    if op == "eq":
        data = (codes >= lo) & (codes < hi)
    elif op == "ne":
        data = (codes < lo) | (codes >= hi)
    elif op == "lt":
        data = codes < lo
    elif op == "le":
        data = codes < hi
    elif op == "gt":
        data = codes >= hi
    else:  # ge
        data = codes >= lo
    return Column(data, c.validity, LType.BOOL)


def _remap_codes(c: Column, table: np.ndarray) -> torch.Tensor:
    return torch.where(c.data >= 0, _take(table.astype(np.int32), c.data),
                       torch.full_like(c.data, int(NULL_CODE)))


def _align_string_columns(a: Column, b: Column) -> tuple[Column, Column]:
    if a.dictionary is b.dictionary or (a.dictionary and b.dictionary and
                                        a.dictionary._id == b.dictionary._id):
        return a, b
    if a.dictionary is None or b.dictionary is None:
        raise ExprError("string column without dictionary in comparison")
    m, ra, rb = dict_merge(a.dictionary, b.dictionary)
    return (replace(a, data=_remap_codes(a, ra), dictionary=m),
            replace(b, data=_remap_codes(b, rb), dictionary=m))


@_raw("and")
def _and(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    av, bv = a.valid_mask(), b.valid_mask()
    at, bt = a.data.to(torch.bool), b.data.to(torch.bool)
    # Kleene: NULL unless (false present) or both valid
    f = (av & ~at) | (bv & ~bt)
    return Column(at & bt & av & bv, f | (av & bv), LType.BOOL)


@_raw("or")
def _or(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    av, bv = a.valid_mask(), b.valid_mask()
    data = (a.data.to(torch.bool) & av) | (b.data.to(torch.bool) & bv)
    return Column(data, data | (av & bv), LType.BOOL)


@_raw("not")
def _not(e, batch):
    a = eval_expr(e.args[0], batch)
    return Column(~a.data.to(torch.bool), a.validity, LType.BOOL)


@_raw("xor")
def _xor(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    out = Column(a.data.to(torch.bool) ^ b.data.to(torch.bool), None, LType.BOOL)
    return _with_null_prop(lambda *_: out, [a, b])


@_raw("is_null")
def _is_null(e, batch):
    a = _eval(e.args[0], batch)
    if isinstance(a, HostStr):
        return Column(_const(False, torch.bool, batch), None, LType.BOOL)
    if a.validity is None:
        data = torch.zeros(a.data.shape, dtype=torch.bool, device=a.data.device)
    else:
        data = ~a.validity
    return Column(data, None, LType.BOOL)


@_raw("is_not_null")
def _is_not_null(e, batch):
    c = _is_null(e, batch)
    return Column(~c.data, None, LType.BOOL)


@_raw("ifnull")
def _ifnull(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    lt = promote(a.ltype, b.ltype)
    av = a.valid_mask()
    data = torch.where(av, _num(a, lt), _num(b, lt))
    return Column(data, av | b.valid_mask(), lt)


@_raw("nullif")
def _nullif(e, batch):
    a = eval_expr(e.args[0], batch)
    b = eval_expr(e.args[1], batch)
    lt = promote(a.ltype, b.ltype)
    equal = _num(a, lt) == _num(b, lt)
    validity = a.valid_mask() & ~(equal & b.valid_mask())
    # result keeps a's data AND a's type (only validity changes)
    return Column(a.data, validity, a.ltype, a.dictionary)


@_raw("coalesce")
def _coalesce(e, batch):
    cols = [eval_expr(a, batch) for a in e.args]
    lt = cols[0].ltype
    for c in cols[1:]:
        lt = promote(lt, c.ltype)
    data = _num(cols[-1], lt)
    validity = cols[-1].valid_mask()
    for c in reversed(cols[:-1]):
        v = c.valid_mask()
        data = torch.where(v, _num(c, lt), data)
        validity = v | validity
    return Column(data, validity, lt)


@_raw("if")
def _if(e, batch):
    cond = eval_predicate(e.args[0], batch)
    a = eval_expr(e.args[1], batch)
    b = eval_expr(e.args[2], batch)
    lt = promote(a.ltype, b.ltype)
    data = torch.where(cond, _num(a, lt), _num(b, lt))
    validity = torch.where(cond, a.valid_mask(), b.valid_mask())
    return Column(data, validity, lt)


@_raw("case_when")
def _case_when(e, batch):
    """args = [cond1, val1, cond2, val2, ..., (else_val)?]"""
    args = list(e.args)
    else_e = args.pop() if len(args) % 2 == 1 else None
    raw_vals = [_eval(args[i + 1], batch) for i in range(0, len(args), 2)]
    raw_else = _eval(else_e, batch) if else_e is not None else None
    n = len(batch)
    if any(isinstance(v, HostStr) for v in raw_vals + [raw_else]):
        # string-valued CASE: branch values become codes into a synthetic
        # sorted dictionary (device work stays integer)
        conds = [eval_predicate(args[i], batch) for i in range(0, len(args), 2)]
        branch_vals = raw_vals + ([raw_else] if else_e is not None else [])
        if not all(isinstance(v, HostStr) for v in branch_vals):
            raise ExprError("CASE mixing string literals and non-strings")
        values = np.unique(np.asarray([str(v) for v in branch_vals], dtype=str))
        codes = [int(np.searchsorted(values, str(v))) for v in raw_vals]
        if raw_else is not None:
            data = _const(int(np.searchsorted(values, str(raw_else))), torch.int32, batch)
            validity = _const(True, torch.bool, batch)
        else:
            data = _const(int(NULL_CODE), torch.int32, batch)
            validity = _const(False, torch.bool, batch)
        for cond, code in zip(reversed(conds), reversed(codes)):
            data = torch.where(cond, _const(code, torch.int32, batch), data)
            validity = torch.where(cond, _const(True, torch.bool, batch), validity)
        return Column(data.expand(n), validity.expand(n), LType.STRING,
                      Dictionary(values))
    pairs = [(eval_predicate(args[i], batch), eval_expr(args[i + 1], batch))
             for i in range(0, len(args), 2)]
    lt = pairs[0][1].ltype
    for _, v in pairs[1:]:
        lt = promote(lt, v.ltype)
    if else_e is not None:
        ec = eval_expr(else_e, batch)
        lt = promote(lt, ec.ltype)
        data, validity = _num(ec, lt), ec.valid_mask()
    else:
        data = _const(0, torch_dtype(lt), batch)
        validity = _const(False, torch.bool, batch)
    for cond, v in reversed(pairs):
        data = torch.where(cond, _num(v, lt), data)
        validity = torch.where(cond, v.valid_mask(), validity)
    return Column(data, validity, lt)


@_raw("between")
def _between(e, batch):
    x, lo, hi = e.args
    return _and(Call("and", (Call("ge", (x, lo)), Call("le", (x, hi)))), batch)


@_raw("in")
def _in(e, batch):
    return _in_impl(e, batch, negate=False)


@_raw("not_in")
def _not_in(e, batch):
    return _in_impl(e, batch, negate=True)


def _member(table: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """x ∈ sorted host ``table``, elementwise (searchsorted + compare)."""
    t = to_tensor(table, x.device)
    flat = x.reshape(-1).contiguous()
    pos = torch.searchsorted(t, flat).clamp(0, len(table) - 1)
    return (t[pos] == flat).reshape(x.shape)


def _in_impl(e, batch, negate):
    a = _eval(e.args[0], batch)
    items = e.args[1:]
    if isinstance(a, Column) and a.ltype is LType.STRING and a.dictionary is not None:
        codes = []
        for it in items:
            if not isinstance(it, Lit) or not isinstance(it.value, str):
                raise ExprError("IN on string column requires string literals")
            c = a.dictionary.code_of(it.value)
            if c is not None:
                codes.append(c)
        if codes:
            hit = _member(np.asarray(sorted(codes), np.int32), a.data)
        else:
            hit = torch.zeros(a.data.shape, dtype=torch.bool, device=a.data.device)
        return Column(~hit if negate else hit, a.validity, LType.BOOL)
    vals = []
    lt = a.ltype
    for it in items:
        if not isinstance(it, Lit):
            raise ExprError("IN requires a literal list")
        vals.append(it.value)
        lt = promote(lt, _lit_type(it))
    hit = _member(np.sort(np.asarray(vals, lt.np_dtype)), _num(a, lt))
    return Column(~hit if negate else hit, a.validity, LType.BOOL)


def _like_to_regex(p: str) -> str:
    out = []
    i = 0
    while i < len(p):
        ch = p[i]
        if ch == "\\" and i + 1 < len(p):
            out.append(re.escape(p[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


def _like_impl(e, batch, negate):
    a = _eval(e.args[0], batch)
    pat = e.args[1]
    if not isinstance(pat, Lit) or not isinstance(pat.value, str):
        raise ExprError("LIKE pattern must be a string literal")
    if not (isinstance(a, Column) and a.ltype is LType.STRING and a.dictionary is not None):
        raise ExprError("LIKE requires a dictionary-encoded string column")
    p = pat.value
    plain = p.replace("\\%", "").replace("\\_", "")
    if "%" not in plain.rstrip("%") and "_" not in plain and p.endswith("%") \
            and not p.endswith("\\%"):
        lo, hi = a.dictionary.prefix_range(p[:-1].replace("\\%", "%").replace("\\_", "_"))
        hit = (a.data >= lo) & (a.data < hi)
    else:
        rx = re.compile(_like_to_regex(p), re.S)
        mask = a.dictionary.memo(("like", p), lambda: a.dictionary.match_mask(
            lambda v: rx.match(v) is not None))
        if len(mask) == 0:
            hit = torch.zeros(a.data.shape, dtype=torch.bool, device=a.data.device)
        else:
            hit = _take(mask, a.data)
    return Column(~hit if negate else hit, a.validity, LType.BOOL)


@_raw("__row_index")
def _row_index(e, batch):
    """Internal: a row identity (planner-injected for EXISTS decorrelation);
    one device, so the row position is unique."""
    return Column(torch.arange(len(batch), dtype=torch.int64, device=batch.device),
                  None, LType.INT64)


@_raw("match_against")
def _match_against(e, batch):
    """MATCH(col) AGAINST('query' [IN BOOLEAN MODE]), compiled as the JAX
    package compiles it: the inverted index (index/fulltext.py) over the
    column's dictionary gives one BM25 relevance per code on the host, and
    the per-row value is one gather by code on the device (0.0 where the
    code is negative).  The value is FLOAT, so a WHERE reads > 0 as a match
    and ORDER BY MATCH(...) ranks."""
    a = _eval(e.args[0], batch)
    q = e.args[1]
    if not (isinstance(q, Lit) and isinstance(q.value, str)):
        raise ExprError("AGAINST requires a string literal")
    boolean_mode = bool(e.args[2].value) if len(e.args) > 2 else False
    if not (isinstance(a, Column) and a.ltype is LType.STRING and a.dictionary is not None):
        raise ExprError("MATCH requires a dictionary-encoded string column")
    from ..index.fulltext import match_scores

    scores = match_scores(a.dictionary, q.value, boolean_mode=boolean_mode)
    if len(scores) == 0:
        hit = torch.zeros(a.data.shape, dtype=torch.float32, device=a.data.device)
    else:
        hit = torch.where(a.data >= 0, _take(scores, a.data),
                          torch.zeros((), dtype=torch.float32, device=a.data.device))
    return Column(hit, a.validity, LType.FLOAT32)


@_raw("like")
def _like(e, batch):
    return _like_impl(e, batch, False)


@_raw("not_like")
def _not_like(e, batch):
    return _like_impl(e, batch, True)


@_raw("cast")
def _cast(e, batch):
    # args = [value, Lit(type-name)]
    target = e.args[1]
    if not isinstance(target, Lit):
        raise ExprError("CAST target must be a type literal")
    lt = LType(target.value) if not isinstance(target.value, LType) else target.value
    a = _eval(e.args[0], batch)
    if isinstance(a, HostStr):
        return Column(_const(_mysql_str_to_num(str(a)), torch_dtype(lt), batch), None, lt)
    return cast_column(a, lt)


# string functions via dictionary transforms --------------------------------


def _dict_transform(c: Column, fn, key: tuple) -> Column:
    """Apply a host string->string fn over distinct values; re-sort + remap.
    ``key`` names the function and its arguments: the table is built once
    per dictionary (``Dictionary.memo``)."""
    if c.dictionary is None:
        raise ExprError("string function requires dictionary")
    if len(c.dictionary.values) == 0:
        # every row is NULL: nothing to transform
        return Column(torch.full_like(c.data, int(NULL_CODE)), c.validity,
                      LType.STRING, Dictionary(np.asarray([], dtype=str)))

    def build():
        new_vals = np.asarray([fn(v) for v in c.dictionary.values], dtype=str)
        uniq, inv = np.unique(new_vals, return_inverse=True)
        return inv, Dictionary(uniq)

    inv, d = c.dictionary.memo(key, build)
    return Column(_remap_codes(c, inv), c.validity, LType.STRING, d)


def _dict_scalar(c: Column, fn, lt: LType, key: Optional[tuple] = None) -> Column:
    """A host string->scalar fn over the distinct values, gathered by code;
    with a ``key`` the table is built once per dictionary."""
    if c.dictionary is None:
        raise ExprError("string function requires dictionary")
    if len(c.dictionary.values) == 0:
        return Column(torch.zeros(c.data.shape, dtype=torch_dtype(lt),
                                  device=c.data.device), c.validity, lt)

    def build():
        return c.dictionary.map_values(fn, lt.np_dtype)

    table = build() if key is None else c.dictionary.memo(key, build)
    return Column(_take(table, c.data), c.validity, lt)


def _str_fn(name, fn):
    @_raw(name)
    def h(e, batch, fn=fn):
        a = _eval(e.args[0], batch)
        if isinstance(a, HostStr):
            return HostStr(fn(str(a)))
        return _dict_transform(a, fn, (name,))
    return h


_str_fn("upper", str.upper)
_str_fn("lower", str.lower)
_str_fn("trim", str.strip)
_str_fn("ltrim", str.lstrip)
_str_fn("rtrim", str.rstrip)
_str_fn("reverse", lambda s: s[::-1])


@_raw("length")
def _length(e, batch):
    a = _eval(e.args[0], batch)
    if isinstance(a, HostStr):
        return Column(_const(len(str(a).encode()), torch.int64, batch), None, LType.INT64)
    return _dict_scalar(a, lambda s: len(s.encode()), LType.INT64)


@_raw("char_length")
def _char_length(e, batch):
    a = _eval(e.args[0], batch)
    if isinstance(a, HostStr):
        return Column(_const(len(str(a)), torch.int64, batch), None, LType.INT64)
    return _dict_scalar(a, len, LType.INT64)


@_raw("substr")
def _substr(e, batch):
    a = _eval(e.args[0], batch)
    pos = e.args[1]
    ln = e.args[2] if len(e.args) > 2 else None
    if not isinstance(pos, Lit) or (ln is not None and not isinstance(ln, Lit)):
        raise ExprError("SUBSTR pos/len must be literals")
    p = int(pos.value)
    n = None if ln is None else int(ln.value)

    def f(s: str) -> str:
        i = p - 1 if p > 0 else len(s) + p
        if i < 0:
            return ""
        return s[i:] if n is None else s[i:i + n]

    if isinstance(a, HostStr):
        return HostStr(f(str(a)))
    return _dict_transform(a, f, ("substr", p, n))


@_raw("concat")
def _concat(e, batch):
    parts = [_eval(a, batch) for a in e.args]
    col_idx = [i for i, p in enumerate(parts) if isinstance(p, Column)]
    if not col_idx:
        return HostStr("".join(str(p) for p in parts))
    if len(col_idx) > 1:
        raise ExprError("CONCAT of multiple columns is egress-only")
    i = col_idx[0]
    pre = "".join(str(p) for p in parts[:i])
    post = "".join(str(p) for p in parts[i + 1:])
    return _dict_transform(parts[i], lambda s: pre + s + post, ("concat", pre, post))


@_raw("hash")
def _hash(e, batch):
    """HASH(a, ...): the 32-bit key hash of utils/hashing.py, as INT64."""
    from ..utils.hashing import hash_columns

    cols = [eval_expr(a, batch) for a in e.args]
    return Column(hash_columns([c.data for c in cols]), None, LType.INT64)


# the extended builtin library registers itself into the tables above
from . import builtins_ext  # noqa: E402,F401  (import for side effects)
