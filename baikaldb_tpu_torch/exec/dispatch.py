"""Cross-query batched dispatch: concurrent queries of one shape run as one
lane-batched execution per tick.

The port of ``baikaldb_tpu/exec/dispatch.py``.  The plan cache
(plan/paramize.py) gives every literal variant of a statement one plan, but
each query still runs its own chain of eager launches; the dispatcher
admits concurrent queries into a combiner that runs the whole group at once
(*Tailwind*, PAPERS.md), so a tick costs one launch chain instead of one a
client.

- **Group key**: queries coalesce when they hit the same plan-cache entry
  (canonical statement shape + pinned values), the same scan shapes (table,
  store version, rows) and the same plan signature: members differ only in
  their bound params.
- **Inline bypass**: a query whose group is idle (nothing queued, nothing in
  flight) runs inline on its own thread, so a query alone pays no added
  latency; only real concurrency queues.
- **The tick**: the first queued waiter becomes the group's leader, sleeps
  ``batch_dispatch_tick_ms`` (or until the group fills to
  ``batch_dispatch_max_group``, when the full group also rotates out so
  later arrivals form a new one), waits for the dispatcher's running tick
  if there is one (one tick at a time: unlike the reference, whose ticks
  may overlap, because a tick's ``[G, n]`` masks are sized by its lanes),
  pads the group to a power of two with
  pad lanes repeating lane 0, stacks the params on the host along a lane
  axis and runs ONE lane-batched execution (exec/lanes.py): each
  param-dependent mask is ``[G, n]``, and K1–K3 and the segment kernel
  launch once over all lanes.  Where the JAX package's program is
  ``jax.vmap`` of the compiled plan, this is its explicit counterpart.
- **Scatter-back**: the per-lane egress compact (the first
  ``batch_dispatch_scatter_rows`` live rows of each lane, in row order)
  runs on the device and leaves in ONE device-to-host transfer; the host
  rebuilds each client's batch, bit-identical to the serial
  ``_egress_compact``.  A lane over that budget re-runs inline.
- **Admission**: the per-group queue is bounded
  (``batch_dispatch_queue_max``; beyond it a typed :class:`DispatchOverload`),
  and the session's qos gate (utils/qos.py) sheds load before anything
  enqueues.
- **The valve differs from the reference on purpose.**  The JAX combiner
  catches any exception and runs every member inline.  Here only
  :class:`CombineFallback` sends the members inline: a plan the lane
  lowering cannot express (raised before any launch), an injected
  ``dispatch.combine`` fault, a lane over its scatter budget.  A CUDA error,
  a kernel that fails to build or launch, or a wrapper's shape check
  reaches every member of the tick as it is: an inline re-run would hide a
  broken kernel behind a slower path that still answers.

Spans: ``batch.enqueue`` (member side, its queue wait), ``batch.combine``
(leader; group and padded size) and ``batch.scatter``.  Every delivery is
exactly once: each member's rendezvous is set once, by its leader.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

from ..analysis.runtime import LOCK_RANKS, GuardedLock, register_witness
from ..obs import progress, trace
from ..utils import metrics
from ..utils.flags import FLAGS, define
from ..utils.qos import RejectedError

define("batch_dispatch", True,
       "cross-query batched dispatch: concurrent queries of one plan-cache "
       "group run as ONE lane-batched execution per combiner tick (params "
       "stacked along a lane axis); a query alone bypasses the queue.  0 "
       "restores per-query execution")
define("batch_dispatch_tick_ms", 1.5,
       "combiner latency budget: how long a group leader waits for more "
       "members before running the batch (the admission tick)")
define("batch_dispatch_max_group", 256,
       "combine at most this many queries per tick; a full group fires "
       "immediately without waiting out the tick")
define("batch_dispatch_queue_max", 1024,
       "bounded per-group queue: arrivals beyond this many waiting queries "
       "get a typed DispatchOverload rejection instead of queueing "
       "unboundedly")
define("batch_dispatch_wait_s", 120.0,
       "waiter safety net: a member falls back to inline execution if its "
       "result does not arrive within this window")
define("batch_dispatch_cache", 64,
       "lane programs kept by the dispatcher (one a cached plan)")
define("batch_dispatch_scatter_rows", 128,
       "per-lane scatter budget: a tick returns up to this many live rows a "
       "client (the egress compact runs on the device); a lane returning "
       "more re-runs inline")


class DispatchOverload(RejectedError):
    """The group's queue is full: a typed admission rejection (the
    reference's reject strategy under overload)."""


class CombineFallback(Exception):
    """This member must run inline: the lane lowering cannot express the
    plan, an injected ``dispatch.combine`` fault abandoned the tick, or its
    lane overflowed the scatter budget.  Raised before any launch of the
    tick in the first case; nothing else sends a member inline."""


# cached master switch: the per-SELECT eligibility check must not take the
# flag registry's lock
_ON = bool(FLAGS.batch_dispatch)


def _refresh(value=None) -> None:
    global _ON
    _ON = bool(FLAGS.batch_dispatch if value is None else value)


FLAGS.on_change("batch_dispatch", _refresh)


def enabled() -> bool:
    return _ON


def from_tick(e: BaseException) -> bool:
    """Whether ``e`` was raised inside a lane-batched tick: it reaches the
    client as it is, and no inline valve re-runs the statement."""
    return getattr(e, "_dispatch_tick", False)


class _Waiter:
    """One queued query: its bound params and the rendezvous."""

    __slots__ = ("params", "done", "out", "err", "t0", "group")

    def __init__(self, params):
        self.params = params
        self.done = threading.Event()
        self.out = None             # the compacted host batch on success
        self.err = None             # the exception to raise on this thread
        self.t0 = time.perf_counter()
        self.group = 0              # occupancy, filled by the leader


class _Group:
    """The queue of one group, alive while members wait; the leader pops it
    when the tick fires."""

    __slots__ = ("pending", "filled")

    def __init__(self):
        self.pending: list[_Waiter] = []
        self.filled = threading.Event()


class BatchDispatcher:
    """One per Database, so queries of different sessions coalesce.  The
    lock guards only the maps, never device work."""

    # ranked below store.table_lock (10): the combiner only holds its lock
    # for map bookkeeping — never across device work or store calls
    RANK = 4
    # the tick lock is taken before the map lock (a leader holding a tick
    # pops its group under _mu), never under it
    TICK_RANK = 2

    def __init__(self):
        # the lockset witness (debug_guards) asserts the dispatcher maps
        # are only touched under this lock
        self._mu = GuardedLock("dispatch.combine_mu", rank=self.RANK)
        # one tick runs at a time: a tick's [G, n] temporaries scale with its
        # lanes and the card runs ticks one after another anyway, so
        # overlapping ticks would only hold several sets at once (about 8 GB
        # a tick of 64 lanes over 100M rows); a leader waiting here keeps its
        # group open to arrivals.  Never held with ``_mu`` across device work
        self._tick_mu = GuardedLock("dispatch.tick_mu", rank=self.TICK_RANK)
        self._groups: dict = {}          # group key -> _Group (queued only)
        self._inflight: dict = {}        # group key -> runs in flight
        self._programs: OrderedDict = OrderedDict()   # id(plan) -> lane program
        self.occupancy: dict[int, int] = {}           # group size -> ticks

    # -- introspection (information_schema.dispatcher) ---------------------
    def queue_depth(self) -> int:
        with self._mu:
            return sum(len(g.pending) for g in self._groups.values())

    def snapshot(self) -> dict:
        with self._mu:
            return {"queue_depth": sum(len(g.pending) for g in self._groups.values()),
                    "live_groups": len(self._groups),
                    "inflight": sum(self._inflight.values()),
                    "occupancy": dict(self.occupancy),
                    "compiled": len(self._programs)}

    # -- admission ---------------------------------------------------------
    def run(self, run_inline, group_key, plan, batches: dict, device):
        """Execute one query through the dispatcher -> its compacted result
        batch.  ``run_inline`` runs the session's own inline path (the
        bypass and the valve).  Raises :class:`DispatchOverload` when the
        group's queue is full."""
        from ..expr.params import PARAMS_KEY

        with self._mu:
            g = self._groups.get(group_key)
            if g is None and not self._inflight.get(group_key):
                # idle group: run inline on this thread, zero added latency
                self._inflight[group_key] = 1
                w = None
                leader = False
            else:
                if g is None:
                    g = self._groups[group_key] = _Group()
                if len(g.pending) >= max(1, int(FLAGS.batch_dispatch_queue_max)):
                    metrics.qos_rejections.add(1)
                    raise DispatchOverload("dispatcher queue full for this statement group "
                                           f"({len(g.pending)} waiting)")
                w = _Waiter(batches[PARAMS_KEY])
                g.pending.append(w)
                leader = len(g.pending) == 1
                if len(g.pending) >= max(2, int(FLAGS.batch_dispatch_max_group)):
                    # a full group fires now and leaves the registry: later
                    # arrivals form a new group under a new leader
                    g.filled.set()
                    if self._groups.get(group_key) is g:
                        del self._groups[group_key]
        if w is None:
            metrics.dispatch_inline.add(1)
            try:
                return run_inline()
            finally:
                self._release(group_key)
        if leader:
            return self._lead(g, group_key, plan, batches, device, run_inline)
        return self._wait(w, run_inline)

    def _release(self, group_key) -> None:
        with self._mu:
            n = self._inflight.get(group_key, 0) - 1
            if n > 0:
                self._inflight[group_key] = n
            else:
                self._inflight.pop(group_key, None)

    # -- member side -------------------------------------------------------
    def _wait(self, w: _Waiter, run_inline):
        qp = progress.current()
        with trace.span("batch.enqueue") as sp:
            # a sliced wait: each slice is a progress beat and a KILL
            # cancellation point (the queue is a pure read path: walking
            # away leaves one unread lane in the tick).  The member shows
            # exec.queued from the moment it queues, not after its first
            # slice as in the JAX package: a tick shorter than a slice
            # would otherwise never show its members queued
            qp.beat(phase="exec.queued", queue_wait_ms=0.0)
            deadline = time.perf_counter() + float(FLAGS.batch_dispatch_wait_s)
            while True:
                remaining = deadline - time.perf_counter()
                ok = w.done.wait(timeout=min(0.05, max(0.0, remaining)))
                qp.beat(phase="exec.queued",
                        queue_wait_ms=(time.perf_counter() - w.t0) * 1e3)
                if ok or remaining <= 0:
                    break
            sp.set(queue_wait_ms=round((time.perf_counter() - w.t0) * 1e3, 3), group=w.group)
        if not ok or isinstance(w.err, CombineFallback):
            metrics.dispatch_fallbacks.add(1)
            return run_inline()
        if w.err is not None:
            raise w.err
        return w.out

    # -- leader side -------------------------------------------------------
    def _lead(self, g_mine: _Group, group_key, plan, batches, device, run_inline):
        # the tick: wait out the latency budget (or a full group); then wait
        # for the running tick, with the group still open to arrivals, and
        # pop it and combine
        g_mine.filled.wait(timeout=max(0.0, float(FLAGS.batch_dispatch_tick_ms)) / 1e3)
        with self._tick_mu:
            with self._mu:
                if self._groups.get(group_key) is g_mine:
                    del self._groups[group_key]
                ws = g_mine.pending
                self._inflight[group_key] = self._inflight.get(group_key, 0) + 1
            try:
                mine = self._tick(ws, plan, batches, device)
            finally:
                self._release(group_key)
        # a solo tick, the valve, or the leader's own lane over its budget
        return run_inline() if mine is None else mine

    def _tick(self, ws: list, plan, batches, device):
        """Run one group and deliver every member's result exactly once ->
        the leader's batch, or None when the leader runs inline."""
        now = time.perf_counter()
        for m in ws:
            m.group = len(ws)
            metrics.queue_wait_ms.observe((now - m.t0) * 1e3)
        if len(ws) == 1:
            # nobody joined during the tick: a plain inline run
            metrics.dispatch_inline.add(1)
            return None
        try:
            outs = self._combine(ws, plan, batches, device)
        except CombineFallback as fb:
            for m in ws[1:]:
                m.err = fb
                m.done.set()
            metrics.dispatch_fallbacks.add(1)
            return None
        except BaseException as e:
            # not the valve's to catch: every member gets the error, marked
            # so that the session's param valve re-raises it too
            e._dispatch_tick = True
            for m in ws[1:]:
                m.err = e
                m.done.set()
            raise
        for m, out in zip(ws[1:], outs[1:]):
            m.out = out
            m.done.set()
        if isinstance(ws[0].err, CombineFallback):
            metrics.dispatch_fallbacks.add(1)
            return None
        return outs[0]

    def _program(self, plan, device):
        """The lane program of ``plan`` (exec/lanes.py), kept in an LRU;
        building it raises :class:`CombineFallback` for a plan the lane
        lowering cannot express."""
        from . import lanes

        # keyed by the plan's identity: the program holds the plan, so the
        # id cannot be reused while the entry lives
        with self._mu:
            prog = self._programs.get(id(plan))
            if prog is not None:
                self._programs.move_to_end(id(plan))
                return prog
        prog = lanes.LaneProgram(plan, device)
        with self._mu:
            self._programs[id(plan)] = prog
            while len(self._programs) > max(1, int(FLAGS.batch_dispatch_cache)):
                self._programs.popitem(last=False)
        return prog

    def _combine(self, ws, plan, batches, device):
        """Stack the group's params, run the lane program once and rebuild
        every client's host batch from one transfer -> per member, its batch
        (None where its lane overflowed; that member's ``err`` then holds a
        :class:`CombineFallback`)."""
        from ..chaos import failpoint
        from ..expr.params import PARAMS_KEY
        from . import lanes

        G = len(ws)
        gpad = max(2, 1 << (G - 1).bit_length())
        feeds = [m.params for m in ws] + [ws[0].params] * (gpad - G)
        # one host stack a slot: scalars -> [gpad, 1], strcmp bounds -> [gpad, 2]
        stacked = tuple(np.stack([np.reshape(f[i], -1) for f in feeds])
                        for i in range(len(feeds[0])))
        table_batches = {k: v for k, v in batches.items() if k != PARAMS_KEY}
        scap = max(1, int(FLAGS.batch_dispatch_scatter_rows))
        t0 = time.perf_counter()
        with trace.span("batch.combine", group=G, padded=gpad):
            if failpoint.ENABLED:
                try:
                    dropped = failpoint.hit("dispatch.combine", group=G)
                except (failpoint.FailpointError, failpoint.FailpointPanic) as e:
                    raise CombineFallback(f"dispatch.combine: {e}") from None
                if dropped:
                    raise CombineFallback("dispatch.combine dropped")
            prog = self._program(plan, device)
            with self._mu:
                self.occupancy[G] = self.occupancy.get(G, 0) + 1
            metrics.batched_groups.add(1)
            metrics.group_occupancy.observe(float(G))
            packed = prog.run(table_batches, stacked, scap)
        with trace.span("batch.scatter", group=G):
            # the one device-to-host transfer of the tick
            outs = lanes.rebuild_clients(packed, G)
        metrics.dispatch_tick_ms.observe((time.perf_counter() - t0) * 1e3)
        fb = None
        for m, o in zip(ws, outs):
            if o is None:
                if fb is None:
                    fb = CombineFallback("scatter budget overflow")
                m.err = fb
        return outs


# lockset witness enrollment: debug_guards=log|disallow installs
# per-attribute assertions from the static ownership map (the dispatcher
# is the canonical witnessed class — its maps are mutated by every
# session thread plus the tick's leader)
register_witness(BatchDispatcher,
                 "baikaldb_tpu_torch/exec/dispatch.py:BatchDispatcher")
# ranks visible at import, without constructing a dispatcher
LOCK_RANKS.setdefault("dispatch.combine_mu", BatchDispatcher.RANK)
LOCK_RANKS.setdefault("dispatch.tick_mu", BatchDispatcher.TICK_RANK)
