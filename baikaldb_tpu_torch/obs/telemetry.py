"""Cluster telemetry plane: per-daemon snapshot polling, fleet merging,
and Prometheus exposition.

The reference dumps per-process bvars to the brpc HTTP port and leaves
cross-fleet aggregation to the scraper; our daemons instead expose one
``rpc_metrics`` snapshot method on the existing RPC plane (utils/net.py)
and the frontend carries this module's :class:`Telemetry` poller:

- each registered daemon is polled under the RPC plane's retry policy (deadline
  budget + jittered resends inside one ``telemetry_rpc_timeout_s``); an
  unreachable daemon keeps its LAST snapshot, marked stale, so
  ``information_schema.cluster_metrics`` still answers with the rest of
  the fleet (bounded degradation, never an error),
- merging is type-aware: **counters sum**, **histograms sum bucket-wise**
  (exact — integer bin counts over identical fixed bounds), **gauges and
  latency rings keep per-daemon rows** (a ring of recent raw samples has
  no meaningful cross-process sum),
- any registry snapshot renders as Prometheus text exposition
  (``# TYPE`` / labels / cumulative ``_bucket`` lines), served over HTTP
  by :func:`start_http_exporter` (daemon ``--metrics-port``,
  server/store_server.py) and returned in-band by each daemon's
  ``rpc_prometheus`` method.

Merging is deterministic: daemons are folded in sorted-name order, so the
merged row is a pure function of the snapshot SET, not of poll arrival
order.

The port of ``baikaldb_tpu/obs/telemetry.py``.  The device gauges read
``torch.cuda`` (the caching allocator's bytes in use and peak, the card's
total memory), summed over the visible cards; without CUDA they are NaN, as
the JAX package's are on the CPU.  The scrape lock is a plain lock (rank 6
in the JAX package's order: below store.table_lock; RPC scrapes run
outside it).
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Optional

from ..utils import metrics
from ..utils.flags import FLAGS, define
from ..utils.metrics import histogram_stats

define("telemetry_poll_s", 2.0,
       "background fleet-telemetry poll period (started automatically in "
       "cluster mode); 0 disables the thread (information_schema."
       "cluster_metrics then polls inline per query); also the re-probe "
       "holdoff for a daemon whose last scrape failed")
define("telemetry_rpc_timeout_s", 2.0,
       "per-daemon deadline budget for one telemetry scrape RPC (rides "
       "the utils/net.py retry policy); an exhausted budget marks the "
       "daemon's rows stale instead of failing the query")

FLEET = "fleet"          # pseudo-daemon name of the merged rows

# snapshot row fields that are NOT scalar values (carried for merging /
# exposition, not rendered as cluster_metrics rows)
_STRUCT_FIELDS = ("labels", "le", "buckets")


# -- fleet merging -----------------------------------------------------------

def merge_snapshots(snaps: dict[str, dict]) -> dict:
    """Merge per-daemon registry snapshots into one fleet snapshot holding
    the SUMMABLE metrics only: counters sum, histograms sum bucket-wise.
    Gauges and latency rings are per-daemon facts — they stay out of the
    merge and render as per-daemon rows.

    Deterministic: daemons fold in sorted-name order, so any poll order
    produces the identical result; bucket counts are integers, so the
    histogram merge is exact.  Histograms whose bucket bounds differ from
    the first-seen bounds are skipped (counted per metric in
    ``swallowed.telemetry.bucket_mismatch``) — summing mismatched bins
    would silently corrupt quantiles."""
    merged: dict = {}
    for daemon in sorted(snaps):
        for name, ent in (snaps[daemon] or {}).items():
            kind = ent.get("kind")
            if kind not in ("counter", "histogram"):
                continue
            m = merged.setdefault(
                name, {"kind": kind,
                       "label_names": list(ent.get("label_names", ())),
                       "rows": {}})
            if m["kind"] != kind:
                metrics.count_swallowed("telemetry.kind_mismatch")
                continue
            for row in ent.get("rows", ()):
                key = tuple(row.get("labels", ()))
                acc = m["rows"].get(key)
                if kind == "counter":
                    if acc is None:
                        m["rows"][key] = {
                            "labels": list(key),
                            "value": float(row.get("value", 0) or 0),
                            "per_second": float(
                                row.get("per_second", 0) or 0)}
                    else:
                        acc["value"] += float(row.get("value", 0) or 0)
                        acc["per_second"] += float(
                            row.get("per_second", 0) or 0)
                else:
                    le = list(row.get("le", ()))
                    buckets = list(row.get("buckets", ()))
                    if acc is None:
                        m["rows"][key] = {
                            "labels": list(key), "le": le,
                            "buckets": [int(b) for b in buckets],
                            "count": float(row.get("count", 0) or 0),
                            "sum": float(row.get("sum", 0) or 0)}
                    elif acc["le"] != le or \
                            len(acc["buckets"]) != len(buckets):
                        metrics.count_swallowed("telemetry.bucket_mismatch")
                    else:
                        acc["buckets"] = [a + int(b) for a, b in
                                          zip(acc["buckets"], buckets)]
                        acc["count"] += float(row.get("count", 0) or 0)
                        acc["sum"] += float(row.get("sum", 0) or 0)
    out: dict = {}
    for name in sorted(merged):
        ent = merged[name]
        rows = []
        for key in sorted(ent["rows"]):
            row = ent["rows"][key]
            if ent["kind"] == "histogram":
                stats = histogram_stats(row["le"], row["buckets"],
                                        row["count"], row["sum"])
                row = {"labels": row["labels"], **stats,
                       "le": row["le"], "buckets": row["buckets"]}
            rows.append(row)
        out[name] = {"kind": ent["kind"],
                     "label_names": ent["label_names"], "rows": rows}
    return out


# -- Prometheus text exposition ---------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    n = _NAME_RE.sub("_", name)
    if not re.match(r"[a-zA-Z_:]", n):
        n = "_" + n
    return prefix + n


def _prom_labels(pairs: list[tuple[str, str]]) -> str:
    if not pairs:
        return ""
    body = ",".join(
        '%s="%s"' % (_NAME_RE.sub("_", k),
                     str(v).replace("\\", r"\\").replace('"', r'\"')
                     .replace("\n", r"\n"))
        for k, v in pairs)
    return "{" + body + "}"


def _fmt(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: dict, prefix: str = "baikal_",
                      const_labels: Optional[dict] = None) -> str:
    """One registry snapshot -> Prometheus text exposition format 0.0.4.

    counters -> ``counter``; gauges -> ``gauge``; histograms -> classic
    ``histogram`` (cumulative ``_bucket{le=...}`` + ``_sum``/``_count``);
    latency rings -> ``summary`` with quantile rows.  ``const_labels``
    (e.g. ``{"daemon": "127.0.0.1:9101"}``) stamp every sample —
    how per-daemon identity survives a fleet-merged scrape."""
    return render_fleet_prometheus({"": snapshot}, prefix=prefix,
                                   base_labels=const_labels)


def render_fleet_prometheus(snaps: dict[str, dict], prefix: str = "baikal_",
                            base_labels: Optional[dict] = None) -> str:
    """Several (daemon name -> snapshot) blocks rendered as ONE exposition:
    each metric name declares its ``# TYPE`` once, with every daemon's
    samples grouped under it carrying a ``daemon`` label (empty daemon
    name = no label, the single-process case)."""
    base = list((base_labels or {}).items())
    by_name: dict[str, dict] = {}
    for daemon in sorted(snaps):
        for name, ent in (snaps[daemon] or {}).items():
            slot = by_name.setdefault(name, {"kind": ent.get("kind"),
                                             "label_names":
                                             list(ent.get("label_names",
                                                          ())),
                                             "samples": []})
            for row in ent.get("rows", ()):
                slot["samples"].append((daemon, row))
    lines: list[str] = []
    for name in sorted(by_name):
        ent = by_name[name]
        kind = ent["kind"]
        pname = _prom_name(name, prefix)
        ptype = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram", "latency": "summary"}.get(
                     kind, "untyped")
        lines.append(f"# TYPE {pname} {ptype}")
        for daemon, row in ent["samples"]:
            labels = list(base)
            if daemon:
                labels.append(("daemon", daemon))
            labels += list(zip(ent["label_names"], row.get("labels", ())))
            if kind == "counter":
                lines.append(f"{pname}{_prom_labels(labels)} "
                             f"{_fmt(row.get('value', 0))}")
            elif kind == "gauge":
                lines.append(f"{pname}{_prom_labels(labels)} "
                             f"{_fmt(row.get('value', float('nan')))}")
            elif kind == "histogram":
                cum = 0
                le = row.get("le", ())
                buckets = row.get("buckets", ())
                for bound, c in zip(le, buckets):
                    cum += int(c)
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels(labels + [('le', format(bound, 'g'))])}"
                        f" {cum}")
                cum += int(buckets[len(le)]) if len(buckets) > len(le) else 0
                lines.append(f"{pname}_bucket"
                             f"{_prom_labels(labels + [('le', '+Inf')])}"
                             f" {cum}")
                lines.append(f"{pname}_sum{_prom_labels(labels)} "
                             f"{_fmt(row.get('sum', 0))}")
                lines.append(f"{pname}_count{_prom_labels(labels)} "
                             f"{_fmt(row.get('count', 0))}")
            elif kind == "latency":
                for q, f in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                             ("0.99", "p99_ms")):
                    lines.append(
                        f"{pname}{_prom_labels(labels + [('quantile', q)])}"
                        f" {_fmt(row.get(f, 0))}")
                n = float(row.get("count", 0) or 0)
                lines.append(f"{pname}_sum{_prom_labels(labels)} "
                             f"{_fmt(n * float(row.get('avg_ms', 0) or 0))}")
                lines.append(f"{pname}_count{_prom_labels(labels)} "
                             f"{_fmt(n)}")
    return "\n".join(lines) + "\n"


# -- device-resource gauges --------------------------------------------------

def install_device_gauges(registry) -> None:
    """Device memory gauges sampled at dump time: bytes in use / peak /
    limit summed over the visible cards (``torch.cuda.memory_allocated``,
    ``max_memory_allocated``, the card's total memory).  Without CUDA they
    report NaN: the row stays visible so dashboards show the gap, and no
    CUDA state is touched."""
    def mk(read):
        def fn():
            import torch

            if not torch.cuda.is_available():
                return float("nan")
            return float(sum(read(torch, i) for i in range(torch.cuda.device_count())))
        return fn

    registry.gauge("device_hbm_in_use_bytes",
                   fn=mk(lambda torch, i: torch.cuda.memory_allocated(i)))
    registry.gauge("device_hbm_peak_bytes",
                   fn=mk(lambda torch, i: torch.cuda.max_memory_allocated(i)))
    registry.gauge("device_hbm_limit_bytes",
                   fn=mk(lambda torch, i: torch.cuda.get_device_properties(i).total_memory))


# -- process-resource gauges -------------------------------------------------

_PROC_STARTED = time.time()


def install_process_gauges(registry) -> None:
    """OS-process gauges sampled at dump time — RSS, thread count, open
    fds, uptime, GC collections — so a watchdog stall correlates with
    resource pressure in the same scrape.  Standard library only (/proc +
    resource + gc); platforms without /proc report NaN, and a raising fn
    is already swallowed+counted by Gauge.stats()."""
    import gc
    import os

    def rss_bytes():
        try:
            with open("/proc/self/statm") as f:
                return float(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            import resource
            # ru_maxrss is the PEAK (KiB on linux) — better than nothing
            # where /proc is absent
            return float(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss) * 1024.0

    def thread_count():
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("Threads:"):
                        return float(line.split()[1])
        except OSError:
            pass
        import threading as _t
        return float(_t.active_count())      # python threads only

    def open_fds():
        try:
            return float(len(os.listdir("/proc/self/fd")))
        except OSError:
            return float("nan")

    def gc_collections():
        return float(sum(s.get("collections", 0) for s in gc.get_stats()))

    registry.gauge("process_rss_bytes", fn=rss_bytes)
    registry.gauge("process_threads", fn=thread_count)
    registry.gauge("process_open_fds", fn=open_fds)
    registry.gauge("process_uptime_s", fn=lambda: time.time() - _PROC_STARTED)
    registry.gauge("process_gc_collections", fn=gc_collections)


# -- the fleet poller --------------------------------------------------------

class Telemetry:
    """One per Database: registered daemon addresses, their cached
    snapshots with staleness state, and the merged fleet view."""


    def __init__(self, local_name: str = "frontend", registry=None,
                 device_gauges: bool = True):
        self.local_name = local_name
        self.registry = registry if registry is not None \
            else metrics.REGISTRY
        # registration + cache dict (lock rank 6 in the JAX package's
        # order; RPC scrapes themselves run OUTSIDE the lock — see poll)
        self._mu = threading.Lock()
        self._clients: dict[str, object] = {}
        # addr -> {"snapshot", "ts", "ok", "error"}; kept across failures
        # so a down daemon's last-known rows survive, marked stale
        self._cache: dict[str, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._meta_addr: Optional[str] = None
        if device_gauges:
            install_device_gauges(self.registry)
            install_process_gauges(self.registry)

    # -- registration ------------------------------------------------------
    def attach_meta(self, meta_address: str) -> None:
        """Fleet self-discovery for the three-binary deployment: the meta
        daemon joins the scrape set, and every poll refreshes the store
        list from its ``instances`` registry — late-joining stores appear
        without frontend config."""
        self._meta_addr = meta_address
        self.register(meta_address)

    def _discover(self) -> None:
        if self._meta_addr is None:
            return
        with self._mu:
            meta = self._clients.get(self._meta_addr)
        if meta is None:
            return
        inst = meta.try_call("instances")
        if isinstance(inst, dict):
            for addr in inst:
                self.register(addr)

    def register(self, address: str) -> None:
        from ..utils.net import RpcClient
        with self._mu:
            if address not in self._clients:
                self._clients[address] = RpcClient(
                    address, timeout=float(FLAGS.telemetry_rpc_timeout_s))

    def unregister(self, address: str) -> None:
        with self._mu:
            self._clients.pop(address, None)
            self._cache.pop(address, None)

    def addresses(self) -> list[str]:
        with self._mu:
            return sorted(self._clients)

    def has_daemons(self) -> bool:
        with self._mu:
            return bool(self._clients)

    # -- polling -----------------------------------------------------------
    def poll(self) -> None:
        """One scrape round: every registered daemon's ``rpc_metrics``
        under the retry policy; failures keep the previous snapshot and
        flip the stale marker.  A daemon whose last attempt FAILED within
        ``telemetry_poll_s`` is held off (rows stay stale) — without this,
        every inline-polled view query pays the full RPC timeout per dead
        daemon, serially."""
        from ..utils.net import RpcError
        self._discover()
        now = time.monotonic()
        # inline mode (telemetry_poll_s=0) still needs the holdoff — it is
        # the mode where a dead daemon's timeout lands on a QUERY — so fall
        # back to the per-daemon RPC budget as the re-probe period
        holdoff = float(FLAGS.telemetry_poll_s) \
            or float(FLAGS.telemetry_rpc_timeout_s)
        with self._mu:
            clients = dict(self._clients)
            skip = {a for a, e in self._cache.items()
                    if not e["ok"] and holdoff > 0
                    and now - e.get("attempt_ts", 0.0) < holdoff}
        for addr, client in sorted(clients.items()):
            if addr in skip:
                continue
            try:
                resp = client.call("metrics")
                snap = resp.get("metrics") if isinstance(resp, dict) else None
                if not isinstance(snap, dict):
                    raise RpcError("malformed rpc_metrics response")
                t = time.monotonic()
                entry = {"snapshot": snap, "ts": t, "attempt_ts": t,
                         "ok": True, "error": ""}
                with self._mu:
                    self._cache[addr] = entry
            except (OSError, RpcError) as e:
                with self._mu:
                    prev = self._cache.get(addr)
                    if prev is not None:
                        # "ts" stays the last SUCCESS time (age_ms = how
                        # old the surviving rows are); attempt_ts drives
                        # the re-probe holdoff above
                        prev["ok"] = False
                        prev["attempt_ts"] = time.monotonic()
                        prev["error"] = f"{type(e).__name__}: {e}"
                    else:
                        t = time.monotonic()
                        self._cache[addr] = {
                            "snapshot": None, "ts": t, "attempt_ts": t,
                            "ok": False,
                            "error": f"{type(e).__name__}: {e}"}

    def entries(self, refresh: bool = True) -> dict[str, dict]:
        """Cached per-daemon state; polls inline first unless a background
        poller thread is live (then the cache is already fresh)."""
        if refresh and not self.running():
            self.poll()
        with self._mu:
            return {a: dict(e) for a, e in self._cache.items()}

    # -- background poller -------------------------------------------------
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self, interval_s: Optional[float] = None) -> None:
        if self.running():
            return
        period = float(FLAGS.telemetry_poll_s) \
            if interval_s is None else float(interval_s)
        if period <= 0:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll()
                except Exception:   # noqa: BLE001 — the poller must survive
                    metrics.count_swallowed("telemetry.poll")
                self._stop.wait(period)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="telemetry-poller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- views -------------------------------------------------------------
    def fleet_snapshots(self, refresh: bool = True
                        ) -> tuple[dict[str, dict], dict[str, dict]]:
        """(per-daemon snapshots incl. the local registry, per-daemon
        status).  Stale daemons contribute their last-known snapshot —
        the best available estimate for fleet sums — with status marking
        how old it is."""
        snaps = {self.local_name: self.registry.snapshot()}
        status = {self.local_name: {"stale": 0, "age_ms": 0.0, "error": ""}}
        entries = self.entries(refresh=refresh)
        now = time.monotonic()           # after the poll: ages are >= 0
        for addr, ent in entries.items():
            status[addr] = {"stale": 0 if ent["ok"] else 1,
                            "age_ms": (now - ent["ts"]) * 1e3,
                            "error": ent.get("error", "")}
            if ent.get("snapshot") is not None:
                snaps[addr] = ent["snapshot"]
        return snaps, status

    def cluster_rows(self, refresh: bool = True) -> list[tuple]:
        """information_schema.cluster_metrics rows:
        (daemon, metric, labels, field, value, stale, age_ms).  Per-daemon
        rows for everything + merged ``fleet`` rows for the summable
        kinds + one ``up`` row per daemon."""
        snaps, status = self.fleet_snapshots(refresh=refresh)
        rows: list[tuple] = []

        def emit(daemon: str, snap: dict, stale: int, age: float):
            for name in sorted(snap):
                ent = snap[name]
                lnames = ent.get("label_names", ())
                for row in ent.get("rows", ()):
                    ltag = ",".join(
                        f"{n}={v}"
                        for n, v in zip(lnames, row.get("labels", ())))
                    for f in sorted(row):
                        if f in _STRUCT_FIELDS:
                            continue
                        try:
                            v = float(row[f])
                        except (TypeError, ValueError):
                            continue
                        rows.append((daemon, name, ltag, f, v, stale, age))

        for daemon in sorted(snaps):
            st = status.get(daemon, {"stale": 0, "age_ms": 0.0})
            emit(daemon, snaps[daemon], int(st["stale"]),
                 float(st["age_ms"]))
        for daemon in sorted(status):
            if daemon == self.local_name:
                continue
            st = status[daemon]
            rows.append((daemon, "up", "", "value",
                         0.0 if st["stale"] else 1.0,
                         int(st["stale"]), float(st["age_ms"])))
        emit(FLEET, merge_snapshots(snaps), 0, 0.0)
        return rows

    def status_rows(self, refresh: bool = True) -> dict[str, str]:
        """SHOW STATUS extension: the merged fleet counters/histograms plus
        per-daemon liveness, flattened to ``cluster.*`` variable names."""
        snaps, status = self.fleet_snapshots(refresh=refresh)
        out: dict[str, str] = {}
        fleet = merge_snapshots(snaps)
        for name in sorted(fleet):
            ent = fleet[name]
            for row in ent.get("rows", ()):
                ltag = "".join(
                    "{%s}" % ",".join(
                        f"{n}={v}" for n, v in zip(ent["label_names"],
                                                   row.get("labels", ()))))\
                    if row.get("labels") else ""
                for f in sorted(row):
                    if f in _STRUCT_FIELDS:
                        continue
                    out[f"cluster.{name}{ltag}.{f}"] = str(row[f])
        for daemon, st in sorted(status.items()):
            if daemon == self.local_name:
                continue
            out[f"cluster.daemon.{daemon}.up"] = \
                "0" if st["stale"] else "1"
        return out

    def prometheus(self, refresh: bool = True) -> str:
        """The whole fleet as one Prometheus exposition: every daemon's
        samples labeled ``daemon=...`` plus the merged rows under
        ``daemon="fleet"``."""
        snaps, _status = self.fleet_snapshots(refresh=refresh)
        snaps = dict(snaps)
        snaps[FLEET] = merge_snapshots(snaps)
        return render_fleet_prometheus(snaps)


# -- HTTP exposition ---------------------------------------------------------

def start_http_exporter(render: Callable[[], str], port: int,
                        host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (any path, really) from ``render()`` — the
    brpc-HTTP-port analog for daemons (``--metrics-port``) and
    tools/metrics_export.py.  Returns the ThreadingHTTPServer; call
    ``.shutdown()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server contract
            try:
                body = render().encode()
                code = 200
            except Exception as e:  # noqa: BLE001 — a scrape failure must
                #   answer 500, not kill the exporter thread
                metrics.count_swallowed("telemetry.exporter")
                body = f"# exporter error: {type(e).__name__}: {e}\n".encode()
                code = 500
            self.send_response(code)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):      # scrapes are not access-log news
            pass

    srv = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name=f"metrics-http-{srv.server_address[1]}").start()
    return srv

