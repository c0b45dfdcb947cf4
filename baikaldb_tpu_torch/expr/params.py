"""Run-time parameter feed of auto-parameterized plans.

The executor binds the bound values (plan/paramize.py ``bind``, riding the
batches dict under ``PARAMS_KEY``) here for the length of one run, as
tensors on the run's device; expr/compile.py's ``Param`` handler reads
its slot back out, so one cached plan serves every literal variant.  A
slot is a 0-d tensor (a strcmp slot: ``[2]`` dictionary-code bounds) for
one query, and a ``[G, 1]`` tensor (``[G, 2]``) for a lane-batched tick of
``G`` queries (exec/lanes.py), so a comparison against an ``[n]`` column
gives a ``[G, n]`` mask.

Thread-local: sessions are thread-per-connection and two threads may run
plans concurrently.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

# reserved key in the batches dict fed to the plan; ScanNodes look up real
# table keys ("db.table") so a dunder name can never collide
PARAMS_KEY = "__params__"

_tls = threading.local()


class ParamError(Exception):
    """A Param slot could not be served from the bound params pytree.
    Deliberately NOT a LookupError: the session's baked-literal fallback
    catches this type specifically, and must never swallow an unrelated
    KeyError/IndexError from the execution stack."""


class ParamStrBounds:
    """A strcmp param travelling through the expr compiler: (lo, hi)
    dictionary-code bounds on the device, consumed by comparison handlers
    the way a host string literal's searched bounds are."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        self.lo = lo
        self.hi = hi


@contextmanager
def bind_params(values):
    """Make ``values`` (a tuple of device tensors, one a slot) visible to
    Param evaluation for the duration of a run."""
    prev = getattr(_tls, "values", None)
    _tls.values = values
    try:
        yield
    finally:
        _tls.values = prev


def current_param(index: int):
    values = getattr(_tls, "values", None)
    if values is None or index >= len(values):
        raise ParamError(
            f"param slot {index} unbound: the plan came from a "
            "parameterized statement but no params were bound "
            f"({0 if values is None else len(values)} slots bound)")
    return values[index]
