"""Metrics instruments — the bvar analog (SURVEY §5.5), the part the port uses.

The port of ``baikaldb_tpu/utils/metrics.py``, cut to the monotonically
growing ``Counter`` (with a per-second rate over a sliding window), the
``LatencyRecorder``, the sampled ``Gauge`` and the ``Registry`` that names
every instrument.  The process-wide ``REGISTRY``
serves the engine; ``registry.dump()`` prints one ``name.field : value``
line per field; the kernel launch counters of ops/group_kernels.py
register here like every other counter.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional


class Counter:
    kind = "counter"

    def __init__(self, name: str, registry: Optional["Registry"] = None):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()
        # (ts, cumulative) sliding window; deque so the per-add trim is
        # O(1) popleft — list.pop(0) shifted the whole window on every
        # hot-path increment
        self._window: deque[tuple[float, int]] = deque()
        (registry or REGISTRY)._register(self)

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n
            now = time.monotonic()
            self._window.append((now, self._value))
            cutoff = now - 60.0
            while len(self._window) > 2 and self._window[0][0] < cutoff:
                self._window.popleft()

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        """Back to 0 (a run that counts one phase's launches)."""
        with self._lock:
            self._value = 0
            self._window.clear()

    def per_second(self, window_s: float = 10.0) -> float:
        """Rate over (at most) the trailing ``window_s``: baseline is the
        NEWEST sample older than the window start, so the measured interval
        brackets the window; when every retained sample is inside the
        window the oldest retained sample is the baseline."""
        with self._lock:
            if len(self._window) < 2:
                return 0.0
            now = time.monotonic()
            cutoff = now - window_s
            # scan from the RIGHT: the baseline sits at the window boundary,
            # so this touches only the samples INSIDE the rate window
            # (~window_s worth) — the old forward scan walked everything
            # OLDER than it first (up to the full 60 s retention) on every
            # call, O(retention) per dump
            first = None
            for ts, v in reversed(self._window):
                if ts < cutoff:
                    first = (ts, v)
                    break
            if first is None:
                first = self._window[0]
            dt = now - first[0]
            return (self._value - first[1]) / dt if dt > 0 else 0.0

    def stats(self) -> dict:
        return {"value": self.value,
                "per_second": round(self.per_second(), 3)}


class LatencyRecorder:
    """A ring of the last ``capacity`` observations in milliseconds, with
    count/total/max over the recorder's life (the JAX package's recorder,
    cut to what the port reads)."""
    kind = "latency"

    def __init__(self, name: str, capacity: int = 4096,
                 registry: Optional["Registry"] = None):
        self.name = name
        self.capacity = capacity
        self._ring: list[float] = []
        self._idx = 0
        self._count = 0
        self._total = 0.0
        self._max = 0.0
        self._lock = threading.Lock()
        (registry or REGISTRY)._register(self)

    def observe(self, ms: float) -> None:
        with self._lock:
            self._count += 1
            self._total += ms
            self._max = max(self._max, ms)
            if len(self._ring) < self.capacity:
                self._ring.append(ms)
            else:
                self._ring[self._idx] = ms
                self._idx = (self._idx + 1) % self.capacity

    def reset(self) -> None:
        """Forget every observation (a run that measures one phase)."""
        with self._lock:
            self._ring, self._idx, self._count, self._total, self._max = [], 0, 0, 0.0, 0.0

    def stats(self) -> dict:
        with self._lock:
            ring = sorted(self._ring)
            count, total, mx = self._count, self._total, self._max

        def pct(p: float) -> float:
            return ring[min(len(ring) - 1, int(p * len(ring)))] if ring else 0.0
        return {"count": count, "total_ms": round(total, 3),
                "avg_ms": round(total / count, 3) if count else 0.0,
                "p50_ms": round(pct(0.5), 3), "p99_ms": round(pct(0.99), 3),
                "max_ms": round(mx, 3)}


class Gauge:
    """Sampled at dump time from a callable (the MVCC plane's
    ``mvcc.live_versions`` / ``mvcc.oldest_pin``)."""

    kind = "gauge"

    def __init__(self, name: str, fn, registry: Optional["Registry"] = None):
        self.name = name
        self.fn = fn
        (registry or REGISTRY)._register(self)

    @property
    def value(self) -> float:
        return float(self.fn())

    def stats(self) -> dict:
        return {"value": self.value}


class Registry:
    def __init__(self):
        self._by_name: dict = {}
        self._lock = threading.Lock()

    def _register(self, inst) -> None:
        with self._lock:
            self._by_name[inst.name] = inst

    def get(self, name: str):
        with self._lock:
            return self._by_name.get(name)

    def counter(self, name: str) -> Counter:
        """The counter named ``name``, made on first touch (atomically: two
        racing threads never mint two counters for one name)."""
        with self._lock:
            inst = self._by_name.get(name)
            if inst is None:
                inst = self._by_name[name] = Counter(name, registry=_UNREGISTERED)
            return inst

    def expose(self) -> dict[str, dict]:
        """{metric -> stats dict}."""
        with self._lock:
            items = sorted(self._by_name.items())
        return {name: inst.stats() for name, inst in items}

    def dump(self) -> str:
        """bvar-dump-style text: one ``name.field : value`` per line."""
        lines = []
        for name, stats in self.expose().items():
            for k, v in stats.items():
                lines.append(f"{name}.{k} : {v}")
        return "\n".join(lines)


class _Unregistered:
    """Registration sink for counters the Registry files itself."""

    def _register(self, inst) -> None:
        pass


_UNREGISTERED = _Unregistered()

REGISTRY = Registry()

queries_total = Counter("queries_total")
queries_failed = Counter("queries_failed")
rows_returned = Counter("rows_returned")
swallowed_exceptions = Counter("swallowed_exceptions")
traces_sampled = Counter("traces_sampled")
trace_spans_dropped = Counter("trace_spans_dropped")
multiway_joins_fused = Counter("multiway_joins_fused")
eqclass_consts_pushed = Counter("eqclass_consts_pushed")
agg_strategy_local = Counter("agg_strategy_local")
agg_strategy_raw = Counter("agg_strategy_raw")
failpoint_trips = Counter("failpoint_trips")
# mesh exchanges (exec/executor.exchange_summary): executed hash-repartition
# rounds per mesh query, and the repartitions skipped because an input was
# already partitioned on the key class
shuffle_rounds = Counter("shuffle_rounds")
shuffle_rounds_saved = Counter("shuffle_rounds_saved")
# scans reduced to an access path's rows (the ANN candidate set, a
# secondary-index gather, zone-map region pruning), host point reads, and
# the regions zone maps dropped
index_scans = Counter("index_scans")
point_lookups = Counter("point_lookups")
regions_pruned = Counter("regions_pruned")
# out-of-core streaming scans (exec/streaming.py): chunks folded, chunks
# zone-map-skipped before any transfer, coldfs segment-read retries, fold
# restarts after a group-capacity overflow, bytes moved host->device, and
# how long the fold loop waited on the prefetcher (0-ish wait = the staging
# of the next chunk fully overlapped the previous chunk's fold)
stream_chunks = Counter("stream_chunks")
stream_chunks_skipped = Counter("stream_chunks_skipped")
stream_retries = Counter("stream_retries")
stream_restarts = Counter("stream_restarts")
stream_bytes_h2d = Counter("stream_bytes_h2d")
stream_prefetch_wait_ms = LatencyRecorder("stream_prefetch_wait_ms")


# the plan cache (exec/session.py): every cached-path SELECT counts exactly
# one of hits (the same text), param_hits (another literal variant of the
# entry's shape) and misses; param_fallbacks counts parameterized runs that
# had to replan with baked literals (should stay ~0); params_hoisted the
# literals plan/paramize.py hoisted; prepared_executes the EXECUTEs
plan_cache_hits = Counter("plan_cache_hits")
plan_cache_param_hits = Counter("plan_cache_param_hits")
plan_cache_misses = Counter("plan_cache_misses")
plan_cache_param_fallbacks = Counter("plan_cache_param_fallbacks")
params_hoisted = Counter("params_hoisted")
prepared_executes = Counter("prepared_executes")
# the batched dispatcher (exec/dispatch.py): ticks that ran a lane-batched
# execution, their group sizes, each member's queue wait, each tick's run
# wall time; queries that ran inline (idle group, solo tick) and members
# sent back inline by the valve (an unexpressible plan, an injected
# dispatch.combine fault, a lane over its scatter budget)
batched_groups = Counter("batched_groups")
group_occupancy = LatencyRecorder("group_occupancy")
queue_wait_ms = LatencyRecorder("queue_wait_ms")
dispatch_tick_ms = LatencyRecorder("dispatch_tick_ms")
dispatch_inline = Counter("dispatch_inline")
dispatch_fallbacks = Counter("dispatch_fallbacks")
# typed admission rejections: qos token buckets (per sign/user/table) and
# the dispatcher's bounded per-group queue
qos_rejections = Counter("qos_rejections")


# CDC change streams (cdc/streams.py) + incrementally maintained rollup
# views (cdc/views.py): events handed to subscribers, fetch calls, how far
# behind the table high-water a cursor's ack stands, ring-trim deferrals
# because an unacked cursor pinned events, cursors force-expired past
# cdc_cursor_max_lag_s (their next fetch raises CursorLagging), matview
# fold rounds / individual deltas folded / full-or-group rescans (MIN/MAX
# retract + statement-image events), and queries the planner answered
# from view state instead of recomputing
cdc_events_delivered = Counter("cdc_events_delivered")
cdc_fetches = Counter("cdc_fetches")
cdc_cursor_lag_ms = LatencyRecorder("cdc_cursor_lag_ms")
binlog_gc_held_by_cursor = Counter("binlog_gc_held_by_cursor")
cdc_cursors_expired = Counter("cdc_cursors_expired")
view_folds = Counter("view_folds")
view_deltas_folded = Counter("view_deltas_folded")
view_rescans = Counter("view_rescans")
view_answered_queries = Counter("view_answered_queries")


def count_swallowed(site: str) -> None:
    """Record an intentionally-swallowed exception at ``site``."""
    swallowed_exceptions.add(1)
    REGISTRY.counter(f"swallowed.{site}").add(1)
