"""Query-lifecycle tracing: cheap nestable spans from wire to device.

The reference instruments everything with bvars and slow-SQL collection
(include/protocol/network_server.h:82-107, the print_agg_sql pipeline);
those are COUNTERS — they cannot answer "where did this query's 40 ms go:
parse, plan-cache miss, XLA compile, device execute, egress densify, raft
append, or binlog flush?".  PAPERS.md ("Query Processing on Tensor
Computation Runtimes", "Tailwind") argues host<->device handoffs dominate
TCR query latency and per-stage attribution is what makes them tunable.
This module is that attribution:

- ``root(kind, text)`` opens a per-query trace at the dispatch seam
  (session execute / wire _query); ``span(name, **attrs)`` nests stages
  under it.  Both are context managers costing one contextvar read when
  tracing is off (the ``debug_guards`` off-switch discipline: the
  ``tracing`` flag off means the shared no-op singleton, no allocation).
- Sampling is head-based (``trace_sample_n``: keep 1 in N roots) with an
  always-keep override for queries slower than ``slow_query_ms`` — spans
  record while a trace is live and the keep/drop decision lands at root
  close, so a slow query is never lost to the sampler.
- A span given a CUDA stream (``span(name, stream)``; the executor's
  ``op.*`` spans) also records a pair of CUDA events on that stream.  At
  the root's close, once the result is on the host, one anchor event is
  recorded and waited for, and each pair of a kept trace becomes the
  attributes ``dev_ts_us`` (the interval's start on the wall clock, the
  clock of ``ts_us`` and of the profiler's device trace) and ``dev_ms``
  (its length on the device).  A trace that is not kept drops its pairs
  unread.  Span starts and ends all read ``time.time_ns()``.
- Kept traces land in a bounded in-memory store (``TRACER``), surfaced by
  SHOW PROFILES / SHOW PROFILE [FOR QUERY n], the
  ``information_schema.trace_spans`` virtual table, and
  ``TRACER.export_chrome(path)`` (chrome://tracing / Perfetto format).
- Cross-RPC propagation: ``wire_context()`` rides utils/net.py requests as
  a ``trace`` header; the serving daemon ``adopt()``s it (recording even
  when its local flag is off — the sampling decision propagates, like every
  distributed tracer), and the finished spans ship back on the response for
  ``absorb()`` to stitch into the frontend tree under one trace_id.

Spans are HOST-side objects.  Inside a jit trace they would bake into the
compiled program (timing nothing) or leak tracers — tpulint's SPANINJIT
rule rejects tracer calls in traced scope; instrumentation belongs at the
dispatch layer around ``fn(batches)``, never inside it.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Optional

from ..utils import metrics
from ..utils.flags import FLAGS, define

define("tracing", False,
       "query-lifecycle span tracing: off = zero-overhead no-op spans "
       "(the debug_guards off-switch discipline); on = per-query trace "
       "trees, head-sampled by trace_sample_n with always-keep for "
       "queries over slow_query_ms")
define("trace_sample_n", 1,
       "head sampling: keep 1 in N query traces (1 = every query); "
       "slow queries (> slow_query_ms) are always kept regardless")
define("trace_store_max", 128,
       "bounded in-memory trace store: kept traces beyond this evict "
       "oldest-first (they count in metrics.traces_dropped, their spans in "
       "metrics.trace_spans_dropped)")
define("trace_max_spans", 512,
       "per-trace span cap; spans beyond it drop (counted in "
       "metrics.trace_spans_dropped) so a pathological statement cannot "
       "balloon one trace")

# cached master switch (the hot path must not parse a flag per statement)
_ON = False


def _refresh(value=None) -> None:
    global _ON
    _ON = bool(FLAGS.tracing if value is None else value)


_refresh()
FLAGS.on_change("tracing", _refresh)


# span ids only need uniqueness within one trace; the pid tag keeps ids
# from different processes (frontend vs store daemons) from colliding when
# remote spans stitch into one tree
_PID_TAG = format(os.getpid() & 0xFFFF, "x")
_SIDS = itertools.count(1)
_SAMPLE = itertools.count()


def _new_sid() -> str:
    return f"{_PID_TAG}.{next(_SIDS)}"


class _Ctx:
    """One live trace: the recording buffer plus the current span cursor.
    Mutated only by the thread driving the query (or, server-side, the one
    RPC handler thread that adopted it)."""

    __slots__ = ("trace_id", "span_id", "buf", "n", "dropped", "sampled",
                 "force", "keep", "max_spans", "node", "dev", "open")

    def __init__(self, trace_id: str, parent: str = "", sampled: bool = True,
                 force: bool = False, node: str = ""):
        self.trace_id = trace_id
        self.span_id = parent        # children of the adopt seam stitch here
        self.buf: list[dict] = []
        self.n = 0
        self.dropped = 0
        self.sampled = sampled
        self.force = force
        self.keep = True
        self.max_spans = max(16, int(FLAGS.trace_max_spans))
        self.node = node
        # (attrs, stream, start event, end event) of each recorded span
        # with a device interval, resolved at the root's close
        self.dev: list = []
        self.open: Optional[_Span] = None    # the innermost open span


_CUR: contextvars.ContextVar[Optional[_Ctx]] = \
    contextvars.ContextVar("baikal_trace", default=None)


def _record(ctx: _Ctx, rec: dict) -> bool:
    if ctx.n >= ctx.max_spans:
        ctx.dropped += 1
        metrics.trace_spans_dropped.add(1)
        return False
    ctx.n += 1
    ctx.buf.append(rec)
    return True


# free timing events by device index: making and freeing one is a driver
# call each, so a traced statement's events go back here once read
_EVENTS: dict = {}
_EVENTS_MAX = 4096


def _device_event(stream):
    """A timing CUDA event recorded now on ``stream``."""
    import torch

    try:
        ev = _EVENTS[stream.device_index].pop()
    except (KeyError, IndexError):
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _release(stream, events) -> None:
    free = _EVENTS.setdefault(stream.device_index, [])
    if len(free) < _EVENTS_MAX:
        free.extend(events)


def _resolve(pairs: list) -> None:
    """Put each recorded device interval on the wall clock: one anchor event
    a stream, recorded behind all the trace's work and waited for (the
    result is on the host by now, so the wait is short), read against
    ``time.time_ns`` when it is reached."""
    anchors = {}
    for _, stream, _, _ in pairs:
        if stream not in anchors:
            ev = _device_event(stream)
            ev.synchronize()
            anchors[stream] = (ev, time.time_ns() / 1e3)
    for attrs, stream, start, end in pairs:
        anchor, t_us = anchors[stream]
        attrs["dev_ts_us"] = t_us - start.elapsed_time(anchor) * 1e3
        attrs["dev_ms"] = round(start.elapsed_time(end), 4)
        _release(stream, (start, end))
    for stream, (anchor, _) in anchors.items():
        _release(stream, (anchor,))


class _Noop:
    """Shared do-nothing span: the entire cost of tracing=off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _Noop()


class _Span:
    __slots__ = ("ctx", "name", "attrs", "sid", "parent", "outer", "t0", "stream", "ev")

    def __init__(self, ctx: _Ctx, name: str, attrs: dict, stream=None):
        self.ctx = ctx
        self.name = name
        self.attrs = attrs
        self.stream = stream

    def __enter__(self):
        ctx = self.ctx
        self.parent = ctx.span_id
        self.outer = ctx.open
        self.sid = _new_sid()
        ctx.span_id = self.sid
        ctx.open = self
        self.t0 = time.time_ns()
        if self.stream is not None:
            self.ev = _device_event(self.stream)
        return self

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __exit__(self, et, ev, tb):
        ctx = self.ctx
        ctx.span_id = self.parent
        ctx.open = self.outer
        end = _device_event(self.stream) if self.stream is not None else None
        t1 = time.time_ns()
        if et is not None:
            self.attrs.setdefault("error", et.__name__)
        if _record(ctx, {"span_id": self.sid, "parent_id": self.parent,
                         "name": self.name, "ts_us": self.t0 / 1e3,
                         "dur_ms": round((t1 - self.t0) / 1e6, 4),
                         "node": ctx.node, "attrs": self.attrs}) and end is not None:
            ctx.dev.append((self.attrs, self.stream, self.ev, end))
        return False


def span(name: str, stream=None, /, **attrs):
    """A child span of the active trace; the no-op singleton when no trace
    is live (one contextvar read — safe on any host path, any frequency).
    A CUDA ``stream`` also records the span's interval on it (``dev_ts_us``
    / ``dev_ms``, resolved at the root's close).  ``name`` and ``stream``
    are positional-only so attrs may freely use any keyword."""
    ctx = _CUR.get()
    if ctx is None:
        return _NOOP
    return _Span(ctx, name, attrs, stream)


def active() -> bool:
    """True when a trace is live (one contextvar read) — lets callers skip
    building span batches whose every member would be the no-op."""
    return _CUR.get() is not None


def annotate(**attrs) -> None:
    """Set ``attrs`` on the innermost open span of the active trace (none
    live or no span open: nothing) — for what only the code under a span
    knows, such as the route a dense GROUP BY took under its ``op.agg``."""
    ctx = _CUR.get()
    if ctx is not None and ctx.open is not None:
        ctx.open.attrs.update(attrs)


def event(name: str, /, **attrs) -> None:
    """Zero-duration span: attach a point-in-time record (telemetry the
    renderers re-read) to the active trace."""
    ctx = _CUR.get()
    if ctx is None:
        return
    _record(ctx, {"span_id": _new_sid(), "parent_id": ctx.span_id,
                  "name": name, "ts_us": time.time_ns() / 1e3, "dur_ms": 0.0,
                  "node": ctx.node, "attrs": attrs})


def discard() -> None:
    """Never keep the active trace (SHOW PROFILE introspection must not
    pollute the store it reads)."""
    ctx = _CUR.get()
    if ctx is not None:
        ctx.keep = False


class _Root:
    """Trace root at the dispatch seam.  Opening a root under an already
    live trace degrades to a plain child span (the wire server and the
    session both call root(); whichever runs first owns the trace)."""

    __slots__ = ("kind", "text", "force", "ctx", "token", "inner",
                 "trace_id", "query_id", "t0")

    def __init__(self, kind: str, text: str, force: bool):
        self.kind = kind
        self.text = text
        self.force = force
        self.query_id: Optional[int] = None

    def __enter__(self):
        outer = _CUR.get()
        if outer is not None:
            if self.force:
                outer.force = True   # EXPLAIN ANALYZE under a sampled-out
                #                      root: the enclosing trace must keep
                # forced sections render their OUTPUT from these span
                # records — guarantee them a full span budget even when
                # the enclosing trace (a long multi-statement batch, a
                # floor-set trace_max_spans) already spent its cap, or
                # EXPLAIN ANALYZE would silently lose its timing lines
                outer.max_spans = max(
                    outer.max_spans,
                    outer.n + max(16, int(FLAGS.trace_max_spans)))
            self.inner = _Span(outer, self.kind,
                               {"text": self.text} if self.text else {})
            self.inner.__enter__()
            self.ctx = None
            self.trace_id = outer.trace_id
            return self
        self.inner = None
        n = int(FLAGS.trace_sample_n)
        sampled = self.force or n <= 1 or (next(_SAMPLE) % n == 0)
        self.trace_id = uuid.uuid4().hex[:16]
        self.ctx = _Ctx(self.trace_id, sampled=sampled, force=self.force)
        self.ctx.span_id = _new_sid()      # children reference the root span
        self.token = _CUR.set(self.ctx)
        self.t0 = time.time_ns()
        return self

    def set(self, **attrs):
        if self.inner is not None:
            self.inner.set(**attrs)
        return self

    def __exit__(self, et, ev, tb):
        if self.inner is not None:
            return self.inner.__exit__(et, ev, tb)
        ctx = self.ctx
        dur_ms = (time.time_ns() - self.t0) / 1e6
        attrs = {"text": self.text} if self.text else {}
        if et is not None:
            attrs["error"] = et.__name__
        _record(ctx, {"span_id": ctx.span_id, "parent_id": "",
                      "name": self.kind, "ts_us": self.t0 / 1e3,
                      "dur_ms": round(dur_ms, 4), "node": ctx.node,
                      "attrs": attrs})
        _CUR.reset(self.token)
        slow = dur_ms > float(FLAGS.slow_query_ms)
        if ctx.keep and (ctx.sampled or ctx.force or slow):
            if ctx.dev:
                _resolve(ctx.dev)
            self.query_id = TRACER.store(self.kind, self.text, ctx, dur_ms)
        else:
            if ctx.keep:
                metrics.traces_dropped.add(1)   # sampled out
            for _, stream, start, end in ctx.dev:
                _release(stream, (start, end))
        ctx.dev = []
        return False


def root(kind: str, text: str = "", force: bool = False):
    """Open a trace at a dispatch seam.  ``force`` bypasses both the
    tracing flag and the sampler (EXPLAIN ANALYZE: the span store is its
    timing source, so its trace always exists)."""
    if not _ON and not force and _CUR.get() is None:
        return _NOOP
    return _Root(kind, text, force)


# -- live-buffer introspection (EXPLAIN ANALYZE renders FROM these) ---------

def mark() -> int:
    ctx = _CUR.get()
    return len(ctx.buf) if ctx is not None else 0


def since(m: int) -> list[dict]:
    ctx = _CUR.get()
    return list(ctx.buf[m:]) if ctx is not None else []


# -- cross-RPC propagation ---------------------------------------------------

def wire_context() -> Optional[dict]:
    """The header utils/net.py attaches to outbound RPCs, or None when no
    trace is live (the common case: zero wire overhead)."""
    ctx = _CUR.get()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "parent_span": ctx.span_id}


@contextmanager
def adopt(wire: dict, name: str, node: str = ""):
    """Server-side: record handler spans under the caller's trace/span ids.
    Yields the live span buffer; after the block it holds every finished
    span dict, ready to ship back on the response.  Recording ignores the
    local tracing flag — the caller already made the sampling decision and
    it propagates (standard distributed-tracer semantics)."""
    tid = str(wire.get("trace_id") or "")
    if not tid:
        yield []
        return
    ctx = _Ctx(tid, parent=str(wire.get("parent_span") or ""), node=node)
    token = _CUR.set(ctx)
    sp = _Span(ctx, name, {})
    sp.__enter__()
    try:
        yield ctx.buf
    finally:
        sp.__exit__(None, None, None)
        _CUR.reset(token)


def absorb(spans: list) -> None:
    """Client-side: stitch spans a peer shipped back into the live trace
    (they already carry this trace's ids — parent pointers land on the
    rpc span that crossed the wire)."""
    ctx = _CUR.get()
    if ctx is None or not isinstance(spans, list):
        return
    for s in spans:
        if isinstance(s, dict) and s.get("span_id"):
            _record(ctx, s)


# -- the bounded trace store -------------------------------------------------

class Tracer:
    """Kept traces, query-id keyed, oldest-evicted (the slow-SQL ring of
    the reference, upgraded from one log line to a span tree)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._traces: "OrderedDict[int, dict]" = OrderedDict()
        self._qids = itertools.count(1)

    def store(self, kind: str, text: str, ctx: _Ctx, dur_ms: float) -> int:
        rec = {"trace_id": ctx.trace_id, "kind": kind, "text": text,
               "duration_ms": round(dur_ms, 4), "spans": list(ctx.buf),
               "dropped": ctx.dropped, "ts": time.time()}
        with self._mu:
            qid = next(self._qids)
            rec["query_id"] = qid
            self._traces[qid] = rec
            cap = max(1, int(FLAGS.trace_store_max))
            while len(self._traces) > cap:
                _, old = self._traces.popitem(last=False)
                metrics.traces_dropped.add(1)
                metrics.trace_spans_dropped.add(len(old["spans"]))
        metrics.traces_sampled.add(1)
        return qid

    def get(self, query_id: int) -> Optional[dict]:
        with self._mu:
            return self._traces.get(int(query_id))

    def last(self) -> Optional[dict]:
        with self._mu:
            if not self._traces:
                return None
            return next(reversed(self._traces.values()))

    def list(self) -> list[dict]:
        with self._mu:
            return list(self._traces.values())

    def clear(self) -> None:
        with self._mu:
            self._traces.clear()

    def export_chrome(self, path: str,
                      query_id: Optional[int] = None) -> int:
        """Write kept traces (or one) as Chrome trace_event JSON — load in
        chrome://tracing or https://ui.perfetto.dev.  Returns the event
        count.  Nodes (frontend / each store daemon) render as processes."""
        recs = [self.get(query_id)] if query_id is not None else self.list()
        recs = [r for r in recs if r is not None]
        pids: dict[str, int] = {}
        events: list[dict] = []
        for rec in recs:
            for s in rec["spans"]:
                node = s.get("node") or "frontend"
                pid = pids.setdefault(node, len(pids) + 1)
                args = {"trace_id": rec["trace_id"],
                        "query_id": rec["query_id"]}
                args.update(s.get("attrs") or {})
                events.append({"name": s["name"], "ph": "X",
                               "ts": s["ts_us"],
                               "dur": s["dur_ms"] * 1e3,
                               "pid": pid, "tid": pid, "args": args})
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": node}} for node, pid in pids.items()]
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + events,
                       "displayTimeUnit": "ms"}, f, default=str)
        return len(events)


TRACER = Tracer()


def span_tree(rec: dict) -> list[tuple[int, dict]]:
    """DFS-flatten a kept trace's spans to (depth, span) rows, children
    ordered by start time — the SHOW PROFILE rendering order.  Spans whose
    parent is missing (dropped by the cap, or a remote fragment whose rpc
    parent was evicted) root at depth 0."""
    spans = rec["spans"]
    by_id = {s["span_id"]: s for s in spans}
    kids: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in spans:
        p = s.get("parent_id") or ""
        if p and p in by_id:
            kids.setdefault(p, []).append(s)
        else:
            roots.append(s)
    out: list[tuple[int, dict]] = []

    def walk(s: dict, depth: int) -> None:
        out.append((depth, s))
        for c in sorted(kids.get(s["span_id"], ()),
                        key=lambda x: x["ts_us"]):
            walk(c, depth + 1)

    for r in sorted(roots, key=lambda x: x["ts_us"]):
        walk(r, 0)
    return out
