"""Live query introspection: per-query progress beats and cooperative KILL.

The port of ``baikaldb_tpu/obs/progress.py`` (host-only Python).  SHOW
PROCESSLIST and KILL are how an operator sees and stops a runaway query
(the reference's show_helper.cpp processlist, the kill path through
state_machine.cpp).  The port runs a query as a chain of eager kernel
launches, not one device program, but progress still comes from the HOST
seams between them, never from a device value:

- ``track(...)`` opens a :class:`QueryProgress` for one statement at the
  session's dispatch seam (a contextvar beside the obs/trace root; a
  nested open degrades to the outer record).  Live records sit in the
  process-wide :data:`PROGRESS` table, so other threads (SHOW
  PROCESSLIST, the watchdog, a KILL from another session) can read them.
- ``beat(phase=..., operator=..., chunk_no=...)`` rides the span seams
  (``plan``, ``exec.batches``, ``exec.run``, a streamed scan's chunks, the
  dispatcher's queued wait, ``egress.arrow``): attribute writes only, no
  lock on the query path, and no read of a device tensor, so a beat never
  syncs the card.
- every beat is also a cancellation point: ``KILL QUERY <id>`` flips the
  record's :class:`CancelToken`, and the next beat (a scan staged, a
  streamed chunk, a mesh round, a queued wait slice) raises
  :class:`QueryKilled`.  The beats sit only at points without side
  effects, so a killed DML is applied whole or not at all.

The ``progress_tracking`` flag (default on) gates it all: off means the
shared no-op record, and KILL cannot find the query.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Optional

from ..utils import metrics
from ..utils.flags import FLAGS, define

define("progress_tracking", True,
       "per-query live progress records (SHOW PROCESSLIST phase/operator/"
       "batches, KILL targeting, watchdog beats); off = the shared no-op "
       "record — no registry writes, and KILL cannot find queries")

# cached master switch (the per-statement path must not parse a flag)
_ON = True


def _refresh(value=None) -> None:
    global _ON
    _ON = bool(FLAGS.progress_tracking if value is None else value)


_refresh()
FLAGS.on_change("progress_tracking", _refresh)


def on() -> bool:
    return _ON


# MySQL's exact ER_QUERY_INTERRUPTED text: server/errors.py pattern-maps
# it to errno 1317 / sqlstate 70100
_KILLED_MSG = "Query execution was interrupted"


class QueryKilled(RuntimeError):
    """Cooperative cancellation: raised at the next progress beat after a
    KILL flipped this query's token.  NOT an OSError — it must fly past
    the RPC client's transport-retry handlers untouched."""

    def __init__(self, msg: str = _KILLED_MSG):
        super().__init__(msg)


class CancelToken:
    """One flag per query, flipped by the killer's thread, polled by the
    victim's.  A bare bool write/read under the GIL — no lock on the
    query path."""

    __slots__ = ("_killed", "reason")

    def __init__(self):
        self._killed = False
        self.reason = ""

    def kill(self, reason: str = "killed") -> None:
        self.reason = reason
        self._killed = True

    def killed(self) -> bool:
        return self._killed

    def check(self) -> None:
        if self._killed:
            raise QueryKilled()


_QIDS = itertools.count(1)


class QueryProgress:
    """One live statement's operator-visible state.  Written only by the
    thread driving the query; read racily (single attribute loads) by
    processlist renderers, the watchdog, and KILL — every field is a
    scalar or immutable, so a torn read is impossible."""

    __slots__ = ("query_id", "conn_id", "user", "host", "db", "dbname",
                 "text", "command", "phase", "operator", "batches_done",
                 "batches_total", "rows_done", "rows_est", "round_no",
                 "rounds_total", "chunk_no", "chunks_total",
                 "queue_wait_ms", "started", "beat_mono",
                 "token", "plan", "exchange", "stalled", "_phase_mono",
                 "_phase_ms")

    def __init__(self, text: str, conn_id: int = 0, user: str = "",
                 host: str = "embedded", db=None, dbname: str = ""):
        self.query_id = next(_QIDS)
        self.conn_id = conn_id
        self.user = user
        self.host = host
        self.db = db                 # Database identity, filters registry
        self.dbname = dbname
        self.text = text
        self.command = "Query"
        self.phase = "starting"
        self.operator = ""
        self.batches_done = 0
        self.batches_total = 0
        self.rows_done = 0
        self.rows_est = 0
        self.round_no = 0
        self.rounds_total = 0
        self.chunk_no = 0            # streamed scan: chunks folded so far
        self.chunks_total = 0        # streamed scan: chunks kept post-prune
        self.queue_wait_ms = 0.0
        self.started = time.time()
        self.beat_mono = time.monotonic()
        self.token = CancelToken()
        self.plan = None             # host plan object, for forensic dumps
        self.exchange = None         # exchange_summary dict when MPP ran
        self.stalled = False         # set by the watchdog, never cleared
        self._phase_mono = self.beat_mono
        self._phase_ms: dict[str, float] = {}

    # -- the hot hook ------------------------------------------------------
    def beat(self, phase: Optional[str] = None,
             operator: Optional[str] = None, **counts) -> None:
        """Progress heartbeat + cancellation point.  Attribute writes only;
        raises QueryKilled when this query was killed."""
        now = time.monotonic()
        self.beat_mono = now
        if phase is not None and phase != self.phase:
            # close the previous phase's wall-clock bucket (the query_log
            # fallback timing source when tracing is off)
            self._phase_ms[self.phase.split(".", 1)[0]] = \
                self._phase_ms.get(self.phase.split(".", 1)[0], 0.0) + \
                (now - self._phase_mono) * 1e3
            self._phase_mono = now
            self.phase = phase
        if operator is not None:
            self.operator = operator
        for k, v in counts.items():
            setattr(self, k, v)
        self.token.check()

    def checkpoint(self) -> None:
        """Cancellation point without a state change (loop tops)."""
        self.beat_mono = time.monotonic()
        self.token.check()

    def phase_ms(self) -> dict:
        """Closed per-phase wall-clock buckets so far (ms), keyed by the
        phase's first dotted segment (parse/plan/exec/egress)."""
        return dict(self._phase_ms)

    def elapsed_s(self) -> float:
        return max(0.0, time.time() - self.started)

    def row(self) -> dict:
        """One information_schema.processlist row (racy snapshot)."""
        return {
            "id": self.conn_id, "user": self.user, "host": self.host,
            "db": self.dbname, "command": self.command,
            "time_s": int(self.elapsed_s()), "state": self.state(),
            "info": self.text, "query_id": self.query_id,
            "phase": self.phase, "operator": self.operator,
            "batches_done": self.batches_done,
            "batches_total": self.batches_total,
            "rows_done": self.rows_done, "rows_est": self.rows_est,
            "round": self.round_no, "rounds_total": self.rounds_total,
            "chunk_no": self.chunk_no, "chunks_total": self.chunks_total,
            "queue_wait_ms": round(self.queue_wait_ms, 3),
            "elapsed_ms": round(self.elapsed_s() * 1e3, 3),
        }

    def state(self) -> str:
        """The SHOW PROCESSLIST State cell: phase, operator, and whichever
        progress counters are live."""
        parts = [self.phase]
        if self.operator:
            parts.append(self.operator)
        if self.batches_total:
            parts.append(f"batch {self.batches_done}/{self.batches_total}")
        if self.rows_est:
            parts.append(f"rows {self.rows_done}/{self.rows_est}")
        if self.rounds_total:
            parts.append(f"round {self.round_no}/{self.rounds_total}")
        if self.chunks_total:
            parts.append(f"chunk {self.chunk_no}/{self.chunks_total}")
        if self.stalled:
            parts.append("STALLED")
        return " ".join(parts)


class _NoopProgress:
    """Shared do-nothing record: the entire cost of progress_tracking=off.
    Carries a token so KILL checks stay structurally identical."""

    __slots__ = ()
    query_id = 0
    token = CancelToken()

    def beat(self, phase=None, operator=None, **counts):
        return None

    def checkpoint(self):
        return None

    def phase_ms(self):
        return {}


_NOOP = _NoopProgress()

_CUR: contextvars.ContextVar[Optional[QueryProgress]] = \
    contextvars.ContextVar("baikal_progress", default=None)


def current():
    """The live record, or the no-op when none (one contextvar read —
    safe at any host-path frequency)."""
    qp = _CUR.get()
    return qp if qp is not None else _NOOP


def cancel_token() -> Optional[CancelToken]:
    """The live query's cancel token, or None — what utils/net.py polls
    to make idempotent RPC waits interruptible."""
    qp = _CUR.get()
    return qp.token if qp is not None else None


class _Track:
    """Context manager registering one QueryProgress for the statement;
    nested opens (wire server then session.execute) degrade to the outer
    record so one connection shows one processlist row."""

    __slots__ = ("qp", "_token", "_nested")

    def __init__(self, qp: QueryProgress):
        self.qp = qp

    def __enter__(self):
        outer = _CUR.get()
        if outer is not None:
            self._nested = True
            self.qp = outer
            return outer
        self._nested = False
        PROGRESS.register(self.qp)
        self._token = _CUR.set(self.qp)
        return self.qp

    def __exit__(self, et, ev, tb):
        if not self._nested:
            _CUR.reset(self._token)
            PROGRESS.unregister(self.qp)
        return False


class _NoopTrack:
    __slots__ = ()

    def __enter__(self):
        return _NOOP

    def __exit__(self, *exc):
        return False


_NOOP_TRACK = _NoopTrack()


def track(text: str, conn_id: int = 0, user: str = "",
          host: str = "embedded", db=None, dbname: str = ""):
    """Open the progress record at the session dispatch seam."""
    if not _ON:
        return _NOOP_TRACK
    return _Track(QueryProgress(text, conn_id=conn_id, user=user, host=host,
                                db=db, dbname=dbname))


class _Registry:
    """Process-global table of live queries, query-id keyed.  Engine
    instances coexist in one process (every test builds its own Database),
    so readers filter by the record's ``db`` identity."""

    def __init__(self):
        self._mu = threading.Lock()
        self._live: dict[int, QueryProgress] = {}

    def register(self, qp: QueryProgress) -> None:
        with self._mu:
            self._live[qp.query_id] = qp

    def unregister(self, qp: QueryProgress) -> None:
        with self._mu:
            self._live.pop(qp.query_id, None)

    def live(self, db=None) -> list[QueryProgress]:
        with self._mu:
            qps = list(self._live.values())
        if db is None:
            return qps
        return [q for q in qps if q.db is db]

    def kill(self, conn_id: Optional[int] = None,
             query_id: Optional[int] = None, db=None,
             reason: str = "killed") -> int:
        """Flip the cancel token of every matching live query; -> count.
        The killer only writes the token — the victim's own thread raises
        at its next beat, so no cross-thread exception injection."""
        n = 0
        for qp in self.live(db):
            if conn_id is not None and qp.conn_id != conn_id:
                continue
            if query_id is not None and qp.query_id != query_id:
                continue
            qp.token.kill(reason)
            n += 1
        if n:
            metrics.queries_killed.add(n)
        return n


PROGRESS = _Registry()
