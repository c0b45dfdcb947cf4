"""Always-on flight recorder: bounded forensics for every finished query.

The reference keeps a slow-SQL ring and dumps it for postmortems
(include/protocol/network_server.h print_agg_sql); a fleet operator's
first question after an incident is "what was that query doing when it
went bad?", and by then the query is gone.  This module answers it after
the fact:

- EVERY completed statement appends a cheap summary row (text, status,
  duration, rows, phase timings) to a bounded ring (``flightrec_max``,
  oldest evicted) — always on, a dict append per query.
- slow (> ``slow_query_ms``), killed, and failed queries additionally
  carry a full forensic bundle: the plan text, the query's trace spans
  (when tracing was live), deltas of the engine counters over the query,
  per-device memory stats, the MPP exchange summary, and per-phase wall
  clock.  Bundles are built AFTER the query finished — nothing here runs
  on the hot path, and nothing touches device state beyond the host-side
  memory_stats() the device gauges already read.

Surfaces: ``information_schema.flight_recorder`` and ``HANDLE flightrec
dump '<path>' [id]`` (JSON lines).  One recorder per Database (like
query_log), so engines coexisting in one process never mix forensics.

The port of ``baikaldb_tpu/obs/flightrec.py``: the per-device memory stats
come from ``torch.cuda`` under the JAX package's keys.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Optional

from ..utils import metrics
from ..utils.flags import FLAGS, define

define("flightrec_max", 256,
       "flight recorder ring capacity: completed-query records beyond "
       "this evict oldest-first (bundles evict with their record)")

# engine counters whose over-the-query delta rides a forensic bundle —
# the "which subsystem went bad" one-glance view
_DELTA_COUNTERS = (
    "shuffle_rounds", "shuffle_overflow_retries", "xla_retraces",
    "rpc_timeouts", "rpc_retries", "dispatch_fallbacks",
    "failpoint_trips", "aot_cache_hits", "plan_cache_hits",
    "plan_cache_misses",
)


def metric_marks() -> dict:
    """Cheap start-of-query counter snapshot (a few attribute reads) so a
    failure bundle can report per-query deltas."""
    out = {}
    for name in _DELTA_COUNTERS:
        c = getattr(metrics, name, None)
        if c is not None:
            out[name] = c.value
    return out


def metric_delta(marks: dict) -> dict:
    """Counter movement since ``metric_marks()``, zero rows dropped."""
    out = {}
    for name, base in marks.items():
        c = getattr(metrics, name, None)
        if c is not None:
            d = c.value - base
            if d:
                out[name] = d
    return out


def device_stats() -> list[dict]:
    """Host-side per-device memory stats (the device-gauge read, bundled
    per incident instead of per scrape), one row a device under the JAX
    package's keys: ``bytes_in_use`` (the caching allocator's
    ``allocated_bytes.all.current``), ``peak_bytes_in_use``
    (``allocated_bytes.all.peak``) and ``bytes_limit`` (the card's total
    memory).  Without CUDA the one CPU device gives a row with no memory
    keys, as the JAX package's CPU backend does; any failure degrades to
    []."""
    try:
        import torch

        if not torch.cuda.is_available():
            return [{"device": "cpu"}]
        out = []
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            out.append({"device": str(torch.device("cuda", i)),
                        "bytes_in_use": float(ms.get("allocated_bytes.all.current", 0)),
                        "peak_bytes_in_use": float(ms.get("allocated_bytes.all.peak", 0)),
                        "bytes_limit": float(
                            torch.cuda.get_device_properties(i).total_memory)})
        return out
    except Exception:                                   # noqa: BLE001
        metrics.count_swallowed("flightrec.device_stats")
        return []


class FlightRecorder:
    """The bounded ring.  ``record`` is the only writer (the query's own
    thread, post-completion); readers copy under the lock."""

    def __init__(self):
        self._mu = threading.Lock()
        self._ring: deque[dict] = deque()
        self._ids = itertools.count(1)

    def record(self, summary: dict, bundle: Optional[dict] = None) -> int:
        rec = dict(summary)
        bundled = bundle is not None
        with self._mu:
            rec["rec_id"] = next(self._ids)
            rec.setdefault("ts", time.time())
            rec["bundle"] = bundle
            self._ring.append(rec)
            cap = max(1, int(FLAGS.flightrec_max))
            while len(self._ring) > cap:
                self._ring.popleft()
        metrics.flightrec_records.add(1)
        if bundled:
            metrics.flightrec_bundles.add(1)
        return rec["rec_id"]

    def rows(self) -> list[dict]:
        with self._mu:
            return [dict(r) for r in self._ring]

    def get(self, rec_id: int) -> Optional[dict]:
        with self._mu:
            for r in self._ring:
                if r["rec_id"] == int(rec_id):
                    return dict(r)
        return None

    def bundles(self) -> list[dict]:
        """Only the records that carry a forensic bundle."""
        return [r for r in self.rows() if r.get("bundle") is not None]

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()

    def dump(self, path: str, rec_id: Optional[int] = None) -> int:
        """Write records (or one) as JSON lines; -> count written."""
        recs = [self.get(rec_id)] if rec_id is not None else self.rows()
        recs = [r for r in recs if r is not None]
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r, default=str) + "\n")
        return len(recs)
