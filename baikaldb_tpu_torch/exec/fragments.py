"""Pushed-down fragment dispatch: N store daemons scan, the frontend merges.

The reference's read architecture ships one serialized plan fragment per
region to the store processes and executes it THERE (Region::query over the
pb::Plan, src/store/region.cpp:1680/2671), so the frontend receives only
qualifying rows or aggregate partials and the fleet's scan bandwidth scales
with the store count.  plan/fragment.py holds the contract and a SERIAL
per-region loop on the frontend (``fragment_pushdown`` off); this module is
the dispatch layer:

- ``plan/distribute.slice_fragments`` keys the fragment to region ownership
  (one FragmentSpec per region, routed-range attached);
- every spec ships CONTENT-ADDRESSED (``frag_key`` — the AOT-artifact
  discipline): the body is pre-published to the stores once per frontend,
  daemons warm-start compiled programs from memory -> disk blob -> peer
  fetch, and ``fragment_warm_compiles`` stays pinned at 0 on re-dispatch;
- specs dispatch CONCURRENTLY (one thread per region — each blocks on its
  daemon's scan+fold, so N daemons deliver N× scan bandwidth);
- a mid-flight split/migration surfaces as StaleRoutingError from the
  range-validated read loop: the WHOLE attempt is discarded, routing
  refreshes, and the fragment re-slices over the new owners
  (``fragment_retargets``).  Partials are merged only from a
  fully-successful attempt, so a retarget can never double-fold a region —
  the exactly-once discipline the ``fragment_chaos`` scenario audits via
  the per-daemon ``scanned`` counts riding each payload.

Anything the stores cannot serve raises PushdownUnsupported and the caller
falls back to the frontend-pulled image path (``fragment_fallbacks``) —
pushed execution is an optimization with a full-fidelity fallback.

A copy of ``baikaldb_tpu/exec/fragments.py``.  Worker threads merge host
values only: no tensor is touched off the session's thread.
"""

from __future__ import annotations

import contextvars
import json
import threading
from collections import deque

from ..chaos import failpoint
from ..obs import trace
from ..plan.distribute import slice_fragments
from ..plan.fragment import frag_wire_key
from ..storage.remote_tier import PushdownUnsupported, StaleRoutingError
from ..utils import metrics
from ..utils.flags import FLAGS, define

define("fragment_pushdown", True,
       "dispatch eligible pushed reads as per-region fragment_execute "
       "RPCs executed by the store daemons in parallel (hash-addressed "
       "bodies, daemon-side cold fold, split/migration re-targeting); "
       "off = the serial per-region exec_fragment loop — bit-identical "
       "results, frontend-paced")
define("fragment_retry_max", 3,
       "dispatch attempts per pushed query: each retry refreshes routing "
       "and re-slices over the new region owners (mid-flight split / "
       "migration); exhausted retries fall back to the pulled image path")

# last dispatches for information_schema.fragments (newest last; the ring
# is the introspection surface, not an accounting truth — counters are)
RECENT_CAP = 64
RECENT: deque = deque(maxlen=RECENT_CAP)
_recent_mu = threading.Lock()


def recent_dispatches() -> list:
    """Snapshot of the recent-dispatch ring, oldest first."""
    with _recent_mu:
        return [dict(r) for r in RECENT]


def _payload_wire_bytes(payload: dict) -> int:
    """The JSON frame size this payload occupied on the wire — the
    subtrahend of bytes-saved (region bytes scanned daemon-side minus what
    actually crossed)."""
    from ..utils.net import _enc

    try:
        return len(json.dumps(_enc(payload)))
    except (TypeError, ValueError):
        return len(str(payload))


def dispatch_fragments(tier, frag: dict) -> tuple[list, dict]:
    """Execute one wire fragment across every region owner concurrently.
    Returns ``(payloads, stats)`` with payloads in region start-key order —
    the SAME merge order as the serial path, so
    ``plan.fragment.merge_push_results`` yields bit-identical results.
    Raises PushdownUnsupported / ReplicationError when the stores cannot
    serve it; the caller falls back to the image path."""
    key = frag_wire_key(frag)
    stats = {"frag_key": key, "table": tier.table_key,
             "mode": frag.get("mode", ""), "dispatched": 0, "local": 0,
             "retargeted": 0, "partial_rows": 0, "scanned": 0,
             "bytes_saved": 0, "status": "ok"}
    try:
        with trace.span("fragment.dispatch", table=tier.table_key,
                        frag=key):
            payloads = _dispatch(tier, frag, key, stats)
    except BaseException as e:      # noqa: BLE001 — recorded, re-raised
        stats["status"] = type(e).__name__
        raise
    finally:
        with _recent_mu:
            RECENT.append(dict(stats))
    trace.event("fragments", **{k: stats[k] for k in
                                ("dispatched", "local", "retargeted",
                                 "partial_rows", "bytes_saved")})
    return payloads, stats


def _dispatch(tier, frag: dict, key: str, stats: dict) -> list:
    if key not in tier._frag_published:
        tier.frag_publish(key, frag)
    attempts = max(1, int(FLAGS.fragment_retry_max))
    last: Exception = PushdownUnsupported(
        f"{tier.table_key}: fragment dispatch exhausted")
    for attempt in range(attempts):
        specs = slice_fragments(frag, tier, key)
        if failpoint.ENABLED:
            if failpoint.hit("fragment.dispatch", table=tier.table_key,
                             attempt=attempt):
                # drop: this attempt is abandoned before any spec leaves;
                # the loop re-dispatches, then the caller falls back
                last = PushdownUnsupported(
                    "fragment.dispatch dropped by failpoint")
                continue
        results: list = [None] * len(specs)
        errors: list = [None] * len(specs)

        def run(i, spec, region):
            try:
                results[i] = tier.fragment_execute_region(
                    region, spec.frag_key, spec.frag)
            except Exception as e:   # noqa: BLE001 — re-raised below
                errors[i] = e

        if len(specs) == 1:
            run(0, *specs[0])
        else:
            # copy_context: the worker threads must see the live query's
            # cancel token (a contextvar) so a KILL cuts their idempotent
            # fragment_execute response waits short instead of riding out
            # the full RPC deadline
            ctx = contextvars.copy_context()
            threads = [threading.Thread(
                target=ctx.copy().run, args=(run, i, spec, region),
                daemon=True,
                name=f"frag-{key[:8]}-r{spec.region_id}")
                for i, (spec, region) in enumerate(specs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        stale = next((e for e in errors
                      if isinstance(e, StaleRoutingError)), None)
        hard = next((e for e in errors if e is not None
                     and not isinstance(e, StaleRoutingError)), None)
        if hard is not None:
            raise hard
        if stale is not None:
            # a region split/migrated mid-flight: throw the WHOLE attempt
            # away, refresh routing, re-slice over the new owners.  Only a
            # fully-successful attempt is ever merged, so a region scanned
            # by both attempts still folds exactly once
            metrics.fragment_retargets.add(1)
            stats["retargeted"] += 1
            tier.refresh_routing()
            last = stale
            continue
        metrics.fragments_dispatched.add(len(results))
        stats["dispatched"] = len(results)
        saved = 0
        for p in results:
            if p.get("cold"):
                stats["local"] += 1     # cold tier folded in place
            stats["partial_rows"] += len(p.get("rows") or p.get("groups")
                                         or ())
            stats["scanned"] += int(p.get("scanned", 0))
            raw = int(p.get("raw_bytes", 0)) + int(p.get("cold_bytes", 0))
            saved += max(0, raw - _payload_wire_bytes(p))
        metrics.fragment_bytes_saved.add(saved)
        stats["bytes_saved"] = saved
        return results
    raise last
