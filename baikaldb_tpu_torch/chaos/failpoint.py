"""Failpoint registry: programmable fault injection at named seams.

A copy of ``baikaldb_tpu/chaos/failpoint.py`` (host-only Python).  The port
wires the cold tier's two seams, ``coldfs.put`` and ``coldfs.get``
(storage/coldfs.py; a streamed scan reads its chunks through the second),
the batched dispatcher's tick, ``dispatch.combine`` (exec/dispatch.py), the
binlog append, ``binlog.append`` (storage/binlog.py), a subscription's fetch
and ack, ``cdc.fetch`` and ``cdc.apply`` (cdc/streams.py), a
materialized view's fold, ``view.fold`` (cdc/views.py), and the replicated
tier's raft, 2PC, split, migration and balancer seams (``raft.*``,
``2pc.*``, ``region.*``, ``migrate.*``, ``meta.balance_tick``).
Each site follows one discipline:

    if failpoint.ENABLED:
        if failpoint.hit("coldfs.get", file=name):
            ...drop handling...

so a disabled build pays one module-attribute bool read per site.

Actions (armed per point with :func:`set_failpoint` or the
``chaos_enable``/``chaos_seed`` flag pair):

- ``return(msg)`` — raise :class:`FailpointError` at the site,
- ``delay(ms)``   — sleep ``ms`` milliseconds,
- ``drop``        — ``hit()`` returns True; the SITE decides what a drop
  means (``coldfs.put``: the bytes never land; ``coldfs.get``:
  FileNotFoundError),
- ``panic``       — raise :class:`FailpointPanic`, a BaseException, so
  ``except Exception`` handlers cannot swallow it.

Spec grammar: ``[P%][N*]action[(arg)]`` — ``P%`` triggers with probability
P (default: always), ``N*`` fires at most N times, e.g. ``30%delay(20)``,
``2*drop``, ``return(no quorum)``.

Determinism: every armed point owns a ``random.Random`` seeded by
``(chaos_seed, point name)`` and consumes exactly one draw per ``hit()``,
so a point's trigger schedule is a pure function of (seed, name, hit
index).  Re-arming a point or changing ``chaos_seed`` restarts it.  Trips
land in ``metrics.failpoint_trips``, a per-point ``failpoint.<name>``
counter and a ``failpoint`` trace event.
"""

from __future__ import annotations

import re
import threading
import time
import zlib
from random import Random
from typing import Optional

from ..utils import metrics
from ..utils.flags import FLAGS, define

define("chaos_enable", False,
       "master switch for failpoint evaluation; arming any failpoint also "
       "enables the sites (the flag alone lets the overhead of evaluated-"
       "but-unarmed sites be measured)")
define("chaos_seed", 0,
       "seed of the deterministic failpoint RNG: every armed point's "
       "trigger schedule is a pure function of (chaos_seed, point name, "
       "hit index), so a chaos run replays identically")


class FailpointError(RuntimeError):
    """An injected ``return(msg)`` failure at a failpoint site."""


class FailpointPanic(BaseException):
    """An injected ``panic``: derives from BaseException ON PURPOSE so the
    per-call fault-isolation handlers (``except Exception``) cannot swallow
    it — it reaches the caller that drives the work."""


# -- the catalog of wired seams ---------------------------------------------
CATALOG: dict[str, str] = {
    "coldfs.put": "cold-tier segment write (drop: the bytes never land)",
    "coldfs.get": "cold-tier segment read (drop: FileNotFoundError)",
    "dispatch.combine": "batched-dispatch tick (drop, return and panic abandon the "
                        "tick: every member re-runs inline; delay stalls it)",
    "binlog.append": "local WAL binlog append, before durability "
                     "(drop: the event is lost; panic: crash mid-append)",
    "cdc.fetch": "subscription fetch, before events are read off the "
                 "merged stream (drop: the fetch returns nothing this "
                 "round — delivery deferred, never lost; delay: a slow "
                 "consumer)",
    "cdc.apply": "subscription ack after a delivered batch (drop: the "
                 "ack is skipped — the batch redelivers; consumers "
                 "dedupe by commit_ts, so exactly-once application "
                 "must survive)",
    "view.fold": "matview delta fold over a fetched batch (drop: the "
                 "fold round is abandoned before any state change — "
                 "events stay unacked and staleness grows, state stays "
                 "consistent)",
    # the in-process replicated tier (raft/, meta/service.py,
    # storage/replicated.py), with the JAX package's texts
    "raft.append": "RaftGroup.propose_cmd / store rpc_propose "
                   "(drop: the append never happens, caller sees failure)",
    "raft.commit": "ReplicatedRegion.apply_committed "
                   "(drop: defer applying committed entries this round)",
    "raft.leader_step": "leader resolution (drop: report leaderless / "
                        "not_leader, forcing election churn + retries)",
    "2pc.prepare": "two-phase commit prepare fan-out "
                   "(drop: a participant's prepare fails)",
    "2pc.decide": "two-phase commit decision propose "
                  "(drop: the decision propose fails, in-doubt window)",
    "region.split_fence": "live split, before the fence/routing switch "
                          "(drop: the split aborts cleanly — child "
                          "retires, parent routing untouched)",
    "region.handoff": "live split bulk row handoff into the child region "
                      "(drop: the copy fails, split aborts; parent keeps "
                      "serving its whole range)",
    "migrate.snapshot": "live migration snapshot catch-up of the new "
                        "learner (drop: the learner is never added, "
                        "migration aborts with membership unchanged)",
    "migrate.promote": "live migration learner->voter promotion (drop: "
                       "promotion skipped, the learner is torn back down "
                       "— clean rollback)",
    "meta.balance_tick": "MetaService.tick control loop (drop: the tick "
                         "emits no orders — a stalled balancer; the data "
                         "plane must stay correct without it)",
}

_SPEC_RE = re.compile(
    r"^\s*(?:(?P<prob>\d+(?:\.\d+)?)%)?\s*(?:(?P<limit>\d+)\*)?\s*"
    r"(?P<action>return|delay|drop|panic)\s*(?:\((?P<arg>[^)]*)\))?\s*$")

_VALID_ARGS = {"return": True, "delay": True, "drop": False, "panic": False}


class _Point:
    """One armed failpoint: parsed spec + deterministic RNG + counters."""

    __slots__ = ("name", "spec", "action", "arg", "prob", "limit",
                 "rng", "hits", "trips", "fp_mu")

    def __init__(self, name: str, spec: str):
        m = _SPEC_RE.match(spec)
        if m is None:
            raise ValueError(
                f"failpoint {name!r}: bad spec {spec!r} "
                f"(want [P%][N*]return(msg)|delay(ms)|drop|panic)")
        self.name = name
        self.spec = spec
        self.action = m.group("action")
        self.arg = (m.group("arg") or "").strip()
        if self.arg and not _VALID_ARGS[self.action]:
            raise ValueError(f"failpoint {name!r}: {self.action} takes "
                             f"no argument")
        if self.action == "delay":
            try:
                float(self.arg or "0")
            except ValueError:
                raise ValueError(f"failpoint {name!r}: delay needs a "
                                 f"millisecond number, got {self.arg!r}") \
                    from None
        self.prob = float(m.group("prob")) / 100.0 if m.group("prob") \
            else 1.0
        self.limit = int(m.group("limit")) if m.group("limit") else -1
        self.rng = Random(_point_seed(name))
        self.hits = 0
        self.trips = 0
        self.fp_mu = threading.Lock()


def _point_seed(name: str) -> int:
    # crc32 is stdlib, stable across runs/platforms, and independent per
    # point name — exactly what the (seed, name) -> schedule contract needs
    return (int(FLAGS.chaos_seed) << 32) ^ zlib.crc32(name.encode())


_mu = threading.Lock()
_armed: dict[str, _Point] = {}
# retired points keep their lifetime counters across a clear()
_counts: dict[str, tuple[int, int]] = {}

# THE module-level enable check: reading this attribute is the entire cost
# of a disabled failpoint site.  True when chaos_enable is set OR any point
# is armed (arming via SET failpoint.x implies intent to fire).
ENABLED = False


def _refresh(_value=None) -> None:
    global ENABLED
    ENABLED = bool(FLAGS.chaos_enable) or bool(_armed)


def _reseed(_value=None) -> None:
    """chaos_seed changed: every armed point restarts its schedule."""
    with _mu:
        for p in _armed.values():
            with p.fp_mu:
                p.rng = Random(_point_seed(p.name))
    _refresh()


_refresh()
FLAGS.on_change("chaos_enable", _refresh)
FLAGS.on_change("chaos_seed", _reseed)


def register(name: str, doc: str) -> None:
    """Add a point to the catalog (tests/tools wiring ad-hoc seams)."""
    CATALOG.setdefault(name, doc)


def set_failpoint(name: str, spec: str) -> None:
    """Arm ``name`` with ``spec``; re-arming resets its RNG schedule.
    ``off``/empty spec clears.  Unknown names are rejected — a typo must
    not silently never fire."""
    name = name.strip().lower()
    if spec is None or str(spec).strip().lower() in ("", "off"):
        clear(name)
        return
    if name not in CATALOG:
        raise ValueError(
            f"unknown failpoint {name!r} (known: {sorted(CATALOG)})")
    point = _Point(name, str(spec).strip())
    with _mu:
        old = _armed.get(name)
        if old is not None:
            point.hits, point.trips = old.hits, old.trips
        else:
            point.hits, point.trips = _counts.get(name, (0, 0))
        _armed[name] = point
    _refresh()


def clear(name: str) -> None:
    with _mu:
        p = _armed.pop(name.strip().lower(), None)
        if p is not None:
            _counts[p.name] = (p.hits, p.trips)
    _refresh()


def clear_all() -> None:
    with _mu:
        for p in _armed.values():
            _counts[p.name] = (p.hits, p.trips)
        _armed.clear()
    _refresh()


def get_spec(name: str) -> Optional[str]:
    with _mu:
        p = _armed.get(name)
        return p.spec if p is not None else None


def describe() -> list[tuple[str, str, str, int, int]]:
    """(name, doc, spec, hits, trips) for every cataloged point."""
    with _mu:
        out = []
        for name in sorted(CATALOG):
            p = _armed.get(name)
            if p is not None:
                out.append((name, CATALOG[name], p.spec, p.hits, p.trips))
            else:
                h, t = _counts.get(name, (0, 0))
                out.append((name, CATALOG[name], "", h, t))
        return out


def hit(name: str, **ctx) -> bool:
    """Evaluate the failpoint.  Returns True when a ``drop`` triggered
    (the site interprets it); sleeps for ``delay``; raises
    :class:`FailpointError` for ``return`` and :class:`FailpointPanic`
    for ``panic``.  Call sites sit behind ``if failpoint.ENABLED:``."""
    p = _armed.get(name)
    if p is None:
        return False
    with p.fp_mu:
        p.hits += 1
        # one draw per hit, unconditionally: the schedule of a point is a
        # pure function of (seed, name, hit index), spec changes included
        r = p.rng.random()
        if p.limit == 0 or r >= p.prob:
            return False
        if p.limit > 0:
            p.limit -= 1
        p.trips += 1
        action, arg = p.action, p.arg
    metrics.failpoint_trips.add(1)
    metrics.REGISTRY.counter(f"failpoint.{name}").add(1)
    from ..obs import trace

    trace.event("failpoint", point=name, action=action, **ctx)
    if action == "delay":
        time.sleep(float(arg or "0") / 1e3)
        return False
    if action == "return":
        raise FailpointError(arg or f"failpoint {name}: injected failure")
    if action == "panic":
        raise FailpointPanic(f"failpoint {name}: injected panic")
    return True                                           # drop
