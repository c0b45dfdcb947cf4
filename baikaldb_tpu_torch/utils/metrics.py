"""Metrics instruments — the bvar analog (SURVEY §5.5).

The port of ``baikaldb_tpu/utils/metrics.py`` (host-only Python): the
monotonically growing ``Counter`` (with a per-second rate over a sliding
window), the ``LatencyRecorder`` ring, the fixed-bucket ``Histogram`` (the
instrument that merges across processes, bucket-wise), the sampled or
settable ``Gauge``, the labelled ``*Family`` variants, and the ``Registry``
that names every instrument.  The process-wide ``REGISTRY`` serves the
engine; daemons (server/store_server.py, server/meta_server.py) carry
their own Registry so several in-process daemons never collide.
Surfaces: ``SHOW STATUS``, ``information_schema.metrics`` /
``cluster_metrics``, ``registry.dump()`` (one ``name.field : value`` line
per field) and ``registry.snapshot()``, the JSON-safe form that
obs/telemetry.py renders as Prometheus text.

The engine's instruments are the port's: the kernel launch counters of
ops/group_kernels.py and ops/segments.py (``kernel_launches.*``) register
here like every other counter, and the JAX package's XLA and AOT-cache
counters have no counterpart; the RPC, region, fragment and distributed
binlog counters are the JAX package's.  ``Counter.reset`` and
``LatencyRecorder.reset`` (a run that counts one phase) are the port's.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Callable, Optional


class _NullRegistry:
    """Registration sink for family children: the family itself is the
    registered object; its labeled children must not collide in the
    by-name table."""

    def _register(self, inst) -> None:
        pass


NULL_REGISTRY = _NullRegistry()


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

    def time(self):
        """Context manager: records elapsed milliseconds."""
        rec = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                rec.observe((time.perf_counter() - self.t0) * 1e3)
                return False
        return _T()

    def stats(self) -> dict:
        with self._lock:
            n = self._count
            if n == 0:
                return {"count": 0, "avg_ms": 0.0, "p50_ms": 0.0,
                        "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
            s = sorted(self._ring)

            def q(p):
                return s[min(len(s) - 1, int(p * (len(s) - 1) + 0.5))]
            return {"count": n, "avg_ms": round(self._total / n, 3),
                    "p50_ms": round(q(0.50), 3), "p95_ms": round(q(0.95), 3),
                    "p99_ms": round(q(0.99), 3), "max_ms": round(self._max, 3)}


# default latency-histogram bounds (milliseconds): 1-2.5-5 per decade from
# 0.1 ms to 50 s.  FIXED and log-spaced so every process bins identically —
# bucket-wise summation across daemons is exact only when bounds match.
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                   10000.0, 25000.0, 50000.0)


def histogram_quantile(q: float, le: list, buckets: list) -> float:
    """Quantile estimate from cumulative-able bucket counts (per-bin counts
    + the +Inf overflow bin): linear interpolation inside the owning bucket
    — the Prometheus histogram_quantile estimator, shared by live
    instruments and the fleet aggregator's merged rows."""
    total = sum(buckets)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= rank:
            if i >= len(le):            # +Inf bin: no upper bound to
                return float(lo)        # interpolate toward — clamp
            hi = le[i]
            frac = (rank - (cum - c)) / c if c > 0 else 0.0
            return float(lo + (hi - lo) * frac)
        if i < len(le):
            lo = le[i]
    return float(lo)


def histogram_stats(le: list, buckets: list, count: float,
                    total: float) -> dict:
    """count/sum/avg + interpolated quantiles from bucket counts — works on
    a live instrument's state AND on merged snapshot rows."""
    n = float(count)
    return {"count": n, "sum": round(float(total), 3),
            "avg": round(float(total) / n, 3) if n > 0 else 0.0,
            "p50": round(histogram_quantile(0.50, le, buckets), 3),
            "p95": round(histogram_quantile(0.95, le, buckets), 3),
            "p99": round(histogram_quantile(0.99, le, buckets), 3)}


class Histogram:
    """Fixed-bucket histogram: the fleet-mergeable latency instrument.

    ``LatencyRecorder``'s ring of recent raw samples gives better local
    quantiles but cannot aggregate across processes; bucket counts sum
    bucket-wise (order-independent, exact) as long as every party uses the
    same bounds — which is why the bounds are fixed at construction and
    ride along in every snapshot."""

    kind = "histogram"

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS,
                 registry: Optional["Registry"] = None):
        self.name = name
        self.le = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.le) + 1)     # last = +Inf overflow
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()
        (registry or REGISTRY)._register(self)

    def observe(self, v: float) -> None:
        # bisect_left: a value exactly on a bound belongs to THAT bucket
        # (Prometheus ``le`` = less-than-or-equal semantics)
        i = bisect_left(self.le, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    def time(self):
        """Context manager: records elapsed milliseconds."""
        rec = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                rec.observe((time.perf_counter() - self.t0) * 1e3)
                return False
        return _T()

    def stats(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            n, s = self._count, self._sum
        return histogram_stats(list(self.le), counts, n, s)

    def snapshot_fields(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            n, s = self._count, self._sum
        out = histogram_stats(list(self.le), counts, n, s)
        out["le"] = list(self.le)
        out["buckets"] = counts
        return out


class Gauge:
    """Sampled at dump time: construct with a callable, or call ``set()``
    on a plain instance (family cells are settable)."""

    kind = "gauge"

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None,
                 registry: Optional["Registry"] = None):
        self.name = name
        self.fn = fn
        self._value = float("nan")
        self._vlock = threading.Lock()
        (registry or REGISTRY)._register(self)

    def set(self, v: float) -> None:
        with self._vlock:
            self._value = float(v)

    def add(self, d: float) -> None:
        """Relative move (in-flight counts, pool sizes); an unset gauge
        starts from 0."""
        with self._vlock:
            v = self._value
            self._value = (0.0 if v != v else v) + float(d)

    def stats(self) -> dict:
        if self.fn is None:
            return {"value": self._value}
        try:
            return {"value": float(self.fn())}
        except Exception:
            # a raising gauge fn must not break SHOW STATUS / expose():
            # the row stays (NaN) and the failure is countable per-site
            count_swallowed("metrics.gauge")
            return {"value": float("nan")}


class _Family:
    """One logical metric keyed by a label tuple.  Children are real
    instruments created on first ``labels()`` touch, registered nowhere
    (the family is the registry entry); the hot path after creation is one
    dict lookup under the family lock."""

    def __init__(self, name: str, label_names: tuple, factory,
                 registry: Optional["Registry"] = None):
        self.name = name
        self.label_names = tuple(label_names)
        self._factory = factory
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()
        (registry or REGISTRY)._register(self)

    def _key(self, kv: dict) -> tuple:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(str(kv[n]) for n in self.label_names)

    def labels(self, **kv):
        key = self._key(kv)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._factory(
                        f"{self.name}{{{','.join(key)}}}")
                    self._children[key] = child
        return child

    def remove(self, **kv) -> None:
        """Drop one labeled row (a region moved away, a table dropped)."""
        with self._lock:
            self._children.pop(self._key(kv), None)

    def rows(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return sorted(self._children.items())

    def stats(self) -> dict:
        """Flattened ``{label=value,...}.field`` rows — the SHOW STATUS /
        dump() rendering of a labeled family."""
        out: dict = {}
        for key, child in self.rows():
            tag = ",".join(f"{n}={v}"
                           for n, v in zip(self.label_names, key))
            for f, v in child.stats().items():
                out[f"{{{tag}}}.{f}"] = v
        return out

    def snapshot_rows(self) -> list[dict]:
        rows = []
        for key, child in self.rows():
            fields = child.snapshot_fields() \
                if isinstance(child, Histogram) else child.stats()
            rows.append({"labels": list(key), **fields})
        return rows


class CounterFamily(_Family):
    kind = "counter"

    def __init__(self, name: str, label_names: tuple,
                 registry: Optional["Registry"] = None):
        super().__init__(name, label_names,
                         lambda n: Counter(n, registry=NULL_REGISTRY),
                         registry)


class GaugeFamily(_Family):
    kind = "gauge"

    def __init__(self, name: str, label_names: tuple,
                 registry: Optional["Registry"] = None):
        super().__init__(name, label_names,
                         lambda n: Gauge(n, registry=NULL_REGISTRY),
                         registry)


class HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, name: str, label_names: tuple,
                 buckets=DEFAULT_BUCKETS,
                 registry: Optional["Registry"] = None):
        super().__init__(
            name, label_names,
            lambda n: Histogram(n, buckets=buckets,
                                registry=NULL_REGISTRY),
            registry)


class LatencyFamily(_Family):
    kind = "latency"

    def __init__(self, name: str, label_names: tuple,
                 registry: Optional["Registry"] = None):
        super().__init__(
            name, label_names,
            lambda n: LatencyRecorder(n, registry=NULL_REGISTRY),
            registry)


class Registry:
    def __init__(self):
        self._by_name: dict[str, object] = {}
        self._lock = threading.Lock()

    def _register(self, inst) -> None:
        with self._lock:
            self._by_name[inst.name] = inst

    def get(self, name: str):
        with self._lock:
            return self._by_name.get(name)

    def expose(self) -> dict[str, dict]:
        """{metric -> stats dict}; the SHOW STATUS / info_schema source.
        Labeled families flatten to ``{label=value,...}.field`` keys."""
        with self._lock:
            items = sorted(self._by_name.items())
        return {name: inst.stats() for name, inst in items}

    def snapshot(self) -> dict:
        """Structured, JSON-safe snapshot — the wire form of this registry
        (daemon ``rpc_metrics`` responses, the fleet aggregator's input,
        the Prometheus renderer's input)::

            {name: {"kind": "counter|latency|histogram|gauge",
                    "label_names": [...],        # [] for plain instruments
                    "rows": [{"labels": [...], <fields>}, ...]}}

        Histogram rows carry ``le`` + per-bin ``buckets`` so merging can
        sum bucket-wise; every other row is its ``stats()`` fields."""
        with self._lock:
            items = sorted(self._by_name.items())
        out: dict = {}
        for name, inst in items:
            if isinstance(inst, _Family):
                out[name] = {"kind": inst.kind,
                             "label_names": list(inst.label_names),
                             "rows": inst.snapshot_rows()}
            else:
                fields = inst.snapshot_fields() \
                    if isinstance(inst, Histogram) else inst.stats()
                out[name] = {"kind": inst.kind, "label_names": [],
                             "rows": [{"labels": [], **fields}]}
        return out

    def dump(self) -> str:
        """bvar-dump-style text: one ``name.field : value`` per line."""
        lines = []
        for name, stats in self.expose().items():
            for k, v in stats.items():
                lines.append(f"{name}.{k} : {v}")
        return "\n".join(lines)

    def _get_or_create(self, name: str, make):
        """Atomic first-touch: lookup-and-create under the registry lock.
        A bare get()-then-construct lets two racing threads mint two
        instruments for one name — the loser keeps mutating an orphan the
        snapshot never sees.  ``make`` constructs with NULL_REGISTRY so the
        instrument's self-registration no-ops while we hold the lock."""
        with self._lock:
            inst = self._by_name.get(name)
            if inst is None:
                inst = make()
                self._by_name[name] = inst
            return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, registry=NULL_REGISTRY))

    def latency(self, name: str) -> LatencyRecorder:
        return self._get_or_create(
            name, lambda: LatencyRecorder(name, registry=NULL_REGISTRY))

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, buckets=buckets,
                                    registry=NULL_REGISTRY))

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get_or_create(
            name, lambda: Gauge(name, fn=fn, registry=NULL_REGISTRY))

    def counter_family(self, name: str, label_names: tuple) -> CounterFamily:
        return self._get_or_create(
            name, lambda: CounterFamily(name, label_names,
                                        registry=NULL_REGISTRY))

    def gauge_family(self, name: str, label_names: tuple) -> GaugeFamily:
        return self._get_or_create(
            name, lambda: GaugeFamily(name, label_names,
                                      registry=NULL_REGISTRY))

    def histogram_family(self, name: str, label_names: tuple,
                         buckets=DEFAULT_BUCKETS) -> HistogramFamily:
        return self._get_or_create(
            name, lambda: HistogramFamily(name, label_names, buckets=buckets,
                                          registry=NULL_REGISTRY))

    def latency_family(self, name: str, label_names: tuple) -> LatencyFamily:
        return self._get_or_create(
            name, lambda: LatencyFamily(name, label_names,
                                        registry=NULL_REGISTRY))


REGISTRY = Registry()

# -- engine-wide instruments ------------------------------------------------
queries_total = Counter("queries_total")
# wire connections accepted (server/mysql_server.py)
connections_total = Counter("connections_total")
queries_failed = Counter("queries_failed")
# statements over slow_query_ms, rows written by DML, and every statement's
# wall time (the session's execute records all three)
slow_queries = Counter("slow_queries")
rows_returned = Counter("rows_returned")
dml_rows = Counter("dml_rows")
query_latency = LatencyRecorder("query_latency")
swallowed_exceptions = Counter("swallowed_exceptions")
traces_sampled = Counter("traces_sampled")
trace_spans_dropped = Counter("trace_spans_dropped")
# traces the store does not keep: sampled out at the root's close, or
# evicted past trace_store_max (obs/trace.py)
traces_dropped = Counter("traces_dropped")
# sanctioned device->host reads (analysis/runtime.py host_read), traced or not
host_reads = Counter("host_reads")
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
# live query introspection (obs/progress.py): queries whose cancel token a
# KILL flipped (the victim raises QueryKilled at its next beat)
queries_killed = Counter("queries_killed")
# the query watchdog (obs/watchdog.py): stall detections, each counted once
# per stalled subject, not per scan
watchdog_stalls_detected = Counter("watchdog_stalls_detected")
# flight recorder (obs/flightrec.py): completed-query summaries recorded
# and the subset that carried a full forensic bundle (slow/killed/failed)
flightrec_records = Counter("flightrec_records")
flightrec_bundles = Counter("flightrec_bundles")
# the replicated tier (storage/replicated.py, raft/fleet.py,
# storage/remote_tier.py): leaderless regions served by the most advanced
# live replica instead of failing the read; completed / aborted live
# splits, merges and learner-first migrations, and the fenced-handoff
# window each one paid.  SHOW STATUS lists them as region.*
learner_fallback_reads = Counter("learner_fallback_reads")
region_splits = Counter("region.splits")
region_split_aborts = Counter("region.split_aborts")
region_merges = Counter("region.merges")
region_migrations = Counter("region.migrations")
region_migrate_aborts = Counter("region.migrate_aborts")
region_handoff_ms = LatencyRecorder("region.handoff_ms")
# RPC plane (utils/net.py): calls that exhausted their per-call deadline
# budget (typed RpcTimeout), transport-failure resends under the
# backoff+jitter policy, and daemon-side idempotency-token dedupe hits (a
# retried write whose first copy executed with the response lost)
rpc_timeouts = Counter("rpc_timeouts")
rpc_retries = Counter("rpc_retries")
rpc_dedup_hits = Counter("rpc_dedup_hits")
# distributed-binlog appends that failed and were queued for retry /
# dropped after the retry queue overflowed (counted in events, not batches)
binlog_retry_queued = Counter("binlog_retry_queued")
binlog_events_dropped = Counter("binlog_events_dropped")
# pushed-down fragment execution (exec/fragments.py): per-region fragment
# dispatches to store daemons, re-dispatches after a mid-flight split /
# migration re-target, whole queries that fell back to the pulled image
# path, raw region bytes that did not cross the wire because only partials
# came back, and dispatches where no daemon could warm-start the fragment
# from its artifact tier (0 on any re-dispatch of a published fragment)
fragments_dispatched = Counter("fragments_dispatched")
fragment_retargets = Counter("fragment_retargets")
fragment_fallbacks = Counter("fragment_fallbacks")
fragment_bytes_saved = Counter("fragment_bytes_saved")
fragment_warm_compiles = Counter("fragment_warm_compiles")


def count_swallowed(site: str) -> None:
    """Record an intentionally-swallowed exception at ``site``."""
    swallowed_exceptions.add(1)
    REGISTRY.counter(f"swallowed.{site}").add(1)
