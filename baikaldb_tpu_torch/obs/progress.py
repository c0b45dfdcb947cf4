"""Per-query phase buckets: the phase columns of ``information_schema.query_log``.

The part of ``baikaldb_tpu/obs/progress.py`` (host-only Python) that the
port reads.  ``track`` opens a :class:`QueryProgress` for one statement at
the session's dispatch seam (a contextvar beside the obs/trace root; a
nested open degrades to the outer record).  ``beat(phase=...)`` rides the
span seams the port has (``plan``, ``exec.batches``, ``exec.run``,
``exec.queued`` in the dispatcher's sliced wait, ``egress.arrow``): plain
attribute writes, no lock and no device sync.  The closed buckets
(``phase_ms``) are the query log's per-phase columns.

The reference module's live-query registry, cancel token, ``checkpoint``
and ``progress_tracking`` flag serve SHOW PROCESSLIST and KILL, which the
port does not have yet; they come with those statements.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional


class QueryProgress:
    """One statement's phase clock.  Written only by the thread driving the
    query."""

    __slots__ = ("phase", "_phase_mono", "_phase_ms")

    def __init__(self):
        self.phase = "starting"
        self._phase_mono = time.monotonic()
        self._phase_ms: dict[str, float] = {}

    def beat(self, phase: Optional[str] = None) -> None:
        """Enter ``phase``: close the previous phase's wall-clock bucket,
        keyed by its first dotted segment (parse/plan/exec/egress)."""
        if phase is None or phase == self.phase:
            return
        now = time.monotonic()
        key = self.phase.split(".", 1)[0]
        self._phase_ms[key] = self._phase_ms.get(key, 0.0) + (now - self._phase_mono) * 1e3
        self._phase_mono = now
        self.phase = phase

    def phase_ms(self) -> dict:
        """Closed per-phase wall-clock buckets so far (ms)."""
        return dict(self._phase_ms)


class _NoopProgress:
    """The record outside any statement: beats are dropped."""

    __slots__ = ()

    def beat(self, phase=None):
        return None

    def phase_ms(self):
        return {}


_NOOP = _NoopProgress()

_CUR: contextvars.ContextVar[Optional[QueryProgress]] = \
    contextvars.ContextVar("baikal_progress", default=None)


def current():
    """The live record, or the no-op when none (one contextvar read)."""
    qp = _CUR.get()
    return qp if qp is not None else _NOOP


class track:
    """Context manager opening one QueryProgress for the statement; nested
    opens degrade to the outer record."""

    __slots__ = ("qp", "_token")

    def __enter__(self):
        outer = _CUR.get()
        if outer is not None:
            self._token = None
            self.qp = outer
        else:
            self.qp = QueryProgress()
            self._token = _CUR.set(self.qp)
        return self.qp

    def __exit__(self, et, ev, tb):
        if self._token is not None:
            _CUR.reset(self._token)
        return False
