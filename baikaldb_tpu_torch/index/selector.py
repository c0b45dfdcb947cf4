"""Scan predicates for access-path choices: the part of
``baikaldb_tpu/index/selector.py`` the streamed scan needs.

``analyze_conjuncts`` walks a scan's pushed filter and collects, per
column, the closed ``[lo, hi]`` interval its col-vs-literal comparisons
allow.  The streamed scan (exec/session.py ``_maybe_stream_source``) holds
each chunk's zone maps against those intervals and skips the chunks no row
of which can pass.  The device filter still runs, so the intervals only
need to be conservative supersets.  The rest of the selector (point,
secondary and zone-map region access paths) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..expr.ast import Call, ColRef, Expr, Lit

# predicates usable for zone-map pruning (each bounds a closed [lo, hi])
_RANGE_OPS = {"eq", "lt", "le", "gt", "ge"}


@dataclass
class ScanPredicates:
    """Per-column conjunctive constraints extracted from a pushed filter."""
    eq: dict = field(default_factory=dict)        # col -> literal value
    ranges: dict = field(default_factory=dict)    # col -> [lo, hi] (closed,
    #                                               None = unbounded)


def _strip(name: str) -> str:
    return name.split(".", 1)[1] if "." in name else name


def analyze_conjuncts(e: Optional[Expr]) -> ScanPredicates:
    """Walk the AND-tree collecting col-vs-literal comparisons; anything
    else is ignored (the device filter still applies it — index choices
    must only be conservative supersets)."""
    sp = ScanPredicates()
    if e is None:
        return sp

    def visit(x):
        if isinstance(x, Call) and x.op == "and":
            for a in x.args:
                visit(a)
            return
        if not isinstance(x, Call) or x.op not in _RANGE_OPS:
            return
        if len(x.args) != 2:
            return
        a, b = x.args
        op = x.op
        if isinstance(a, Lit) and isinstance(b, ColRef):
            a, b = b, a
            op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                  "eq": "eq"}[op]
        if not (isinstance(a, ColRef) and isinstance(b, Lit)):
            return
        col = _strip(a.name)
        v = b.value
        if v is None:
            return
        if op == "eq":
            sp.eq[col] = v
        lo, hi = sp.ranges.get(col, [None, None])
        try:
            if op == "eq":
                lo = v if lo is None else max(lo, v)
                hi = v if hi is None else min(hi, v)
            elif op in ("gt", "ge"):
                lo = v if lo is None else max(lo, v)
            else:                                  # lt / le
                hi = v if hi is None else min(hi, v)
        except TypeError:
            return          # mixed-type literals on one column: no constraint
        sp.ranges[col] = [lo, hi]

    visit(e)
    return sp
