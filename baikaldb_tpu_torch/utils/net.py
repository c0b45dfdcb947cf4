"""Cluster RPC plane: length-prefixed JSON messages over TCP.

The reference's inter-process contract is protobuf over brpc (SURVEY §5.8:
meta control / store data / MPP shuffle planes).  Here the MPP shuffle plane
is the mesh's in-program collectives, so the host side only needs a control/data
RPC for raft messages, heartbeats, and region ops — small, latency-tolerant
payloads.  JSON with tagged base64 for byte fields keeps the protocol
language-neutral and safe (no pickle: a store must not execute payloads).

Framing: 4-byte little-endian length + UTF-8 JSON body.

Reliability policy (the brpc retry discipline, chaos-hardened — see
docs/CHAOS.md):

- every ``RpcClient.call`` runs under ONE per-call deadline budget
  (``timeout``), propagated to the server as a ``deadline_ms`` header so
  handlers with internal waits (``rpc_propose``) never work past the
  caller's deadline; exhaustion raises the typed :class:`RpcTimeout`,
- transport failures AFTER an established connection retry with
  exponential backoff + full jitter inside the budget; connection-refused
  fails fast (peer rotation belongs to the caller's routing loop),
- non-idempotent methods carry an idempotency ``token``: the server keeps
  a bounded token -> response cache and replays the recorded response for
  a resend, so a retried write whose first copy executed with the
  response lost applies exactly once (metrics.rpc_dedup_hits),
- malformed frames are counted (``swallowed.rpc.bad_frame``) and drop the
  connection instead of silently killing the serving thread.

Failpoints (chaos/failpoint.py): ``rpc.send``, ``rpc.recv`` client-side,
``store.handler`` around server dispatch — ``panic`` there crashes the
daemon through ``RpcServer.on_panic``.

A copy of ``baikaldb_tpu/utils/net.py`` (host-only Python): the frames are
byte for byte the JAX package's, so a client of either package calls a
server of the other.  ``send_msg`` / ``recv_msg`` leave the traversal to
the C JSON codec (``_b64_default`` / ``_b64_hook`` write and read what the
JAX package's ``_enc`` / ``_dec`` do), and a frame is received into one
buffer.
"""

from __future__ import annotations

import base64
import itertools
import json
import select
import socket
import struct
import threading
import time
import uuid
from collections import OrderedDict
from random import Random
from typing import Callable, Optional

from ..chaos import failpoint
from ..obs import progress, trace
from . import metrics
from .flags import FLAGS, define

define("rpc_retry_max", 3,
       "transport-failure resends per RPC call (established-connection "
       "failures only; all attempts share the call's deadline budget)")
define("rpc_backoff_ms", 20.0,
       "base of the exponential backoff between RPC retries; the actual "
       "sleep is full-jitter uniform(0, backoff), backoff doubling per "
       "attempt (capped at 1s)")

_BYTES_TAG = "__b64__"

# process-wide wire accounting (diagnostics + the pushdown transfer tests:
# a pushed fragment must move a small fraction of what a raw region pull
# moves).  Plain int adds under the GIL — close enough for accounting.
WIRE_STATS = {"sent_bytes": 0, "recv_bytes": 0}


def _enc(obj):
    if isinstance(obj, bytes):
        return {_BYTES_TAG: base64.b64encode(obj).decode()}
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    return obj


def _b64_default(obj):
    """``json.dumps`` hook: a bytes value becomes its tagged base64 object,
    the bytes ``_enc`` writes, with the traversal left to the C encoder."""
    if isinstance(obj, bytes):
        return {_BYTES_TAG: base64.b64encode(obj).decode()}
    raise TypeError(f"Object of type {type(obj).__name__} is not JSON serializable")


def _b64_hook(obj: dict):
    """``json.loads`` hook: a tagged base64 object becomes its bytes (the
    JAX package's ``_dec``, one object at a time)."""
    if len(obj) == 1 and _BYTES_TAG in obj:
        return base64.b64decode(obj[_BYTES_TAG])
    return obj


def send_msg(sock: socket.socket, obj) -> None:
    body = json.dumps(obj, default=_b64_default).encode()
    WIRE_STATS["sent_bytes"] += 4 + len(body)
    sock.sendall(struct.pack("<I", len(body)) + body)


# frame-length sanity cap: a garbage 4-byte prefix (the most common
# malformed frame) must be rejected, not buffered — 0xFFFFFFFF would
# otherwise accumulate 4 GiB of attacker-controlled bytes before the
# JSON parse could ever fail.  64 MiB clears every real payload (full
# region scans included) by a wide margin.
MAX_FRAME_BYTES = 64 << 20


def recv_msg(sock: socket.socket):
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack("<I", header)
    if n > MAX_FRAME_BYTES:
        raise ValueError(f"frame length {n} exceeds cap {MAX_FRAME_BYTES}")
    body = _recv_exact(sock, n)
    if body is None:
        return None
    WIRE_STATS["recv_bytes"] += 4 + n
    return json.loads(body, object_hook=_b64_hook)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes (None at EOF), received into one preallocated
    buffer: a region scan's frame is tens of MB."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return bytes(buf)


class RpcError(RuntimeError):
    pass


class RpcTimeout(RpcError):
    """The per-call deadline budget expired (connect, send, or receive).
    Typed so callers can tell 'the peer is slow/dead' from a handler-side
    failure; counted in metrics.rpc_timeouts."""


# the caller's propagated deadline, visible to the handler serving it
_BUDGET = threading.local()


def handler_deadline_s() -> Optional[float]:
    """Remaining seconds of the calling client's deadline budget (from the
    ``deadline_ms`` request header), or None when the caller sent none.
    Handlers with internal waits (rpc_propose) clamp to it so a daemon
    never keeps working past the caller's deadline."""
    until = getattr(_BUDGET, "until", None)
    if until is None:
        return None
    return max(0.0, until - time.monotonic())


class RpcServer:
    """Thread-per-connection RPC dispatch (the brpc service analog at test
    scale; the data plane lives on the TPU, not in this loop)."""

    # bounded idempotency-token -> response cache (exactly-once replay for
    # retried writes); 1024 entries comfortably covers every in-flight
    # retry window at test/bench scale
    DEDUPE_MAX = 1024

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._handlers: dict[str, Callable] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        # node label stamped on spans recorded while serving a traced RPC,
        # so a stitched frontend tree shows WHICH daemon did the work
        self.trace_node = f"{self.host}:{self.port}"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns: set[socket.socket] = set()
        self._conns_mu = threading.Lock()
        self._dedupe: "OrderedDict[str, dict]" = OrderedDict()
        self._dedupe_mu = threading.Lock()
        # crash hook for the ``store.handler`` panic action: the owning
        # daemon installs its kill-9 analog (StoreServer.crash); default
        # is stop() — the server goes dark
        self.on_panic: Optional[Callable[[], None]] = None
        # telemetry-plane instrumentation (attach_metrics): per-method
        # handler latency histogram + in-flight gauge, recorded into the
        # OWNING daemon's registry; None = uninstrumented, zero cost
        self._m_handler = None
        self._m_inflight = None

    def register(self, name: str, fn: Callable) -> None:
        self._handlers[name] = fn

    def attach_metrics(self, registry) -> None:
        """Record per-method handler telemetry into ``registry`` (a
        daemon-scoped metrics.Registry): ``rpc_handler_ms`` histogram —
        the mergeable instrument, so the frontend's fleet aggregator can
        sum latency distributions across daemons — and ``rpc_inflight``
        gauge (requests currently executing, the brpc concurrency bvar)."""
        self._m_handler = registry.histogram_family(
            "rpc_handler_ms", ("method",))
        self._m_inflight = registry.gauge_family(
            "rpc_inflight", ("method",))

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def stop(self, hard: bool = False) -> None:
        """Stop accepting.  ``hard`` additionally severs every LIVE
        connection, so in-flight handlers cannot ack after the stop — the
        kill-9 analog the chaos harness's daemon crash needs (a soft stop
        lets in-flight replies drain)."""
        self._stop.set()
        try:
            # shutdown BEFORE close: the accept thread blocks inside
            # accept() holding the socket's fd reference, so a bare
            # close() defers the actual fd teardown until one more
            # connection arrives — the port stays LISTENING and a
            # restarted daemon on the same address gets EADDRINUSE
            # forever.  shutdown() pops the blocked accept immediately.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if hard:
            with self._conns_mu:
                conns = list(self._conns)
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _panic(self) -> None:
        """Injected daemon crash (failpoint ``panic``): run the owner's
        crash hook, default to going dark."""
        cb = self.on_panic
        if cb is None:
            self.stop()
            return
        try:
            cb()
        except Exception:           # the crash hook itself must not throw
            metrics.count_swallowed("rpc.on_panic")

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._conns_mu:
            self._conns.add(conn)
        try:
            self._serve_conn_loop(conn)
        finally:
            with self._conns_mu:
                self._conns.discard(conn)

    def _serve_conn_loop(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    req = recv_msg(conn)
                except OSError:
                    return
                except (ValueError, struct.error) as e:
                    # malformed frame: the stream is garbage from here —
                    # count it (operators must see a flood) and drop the
                    # connection instead of killing the thread silently
                    metrics.count_swallowed("rpc.bad_frame")
                    print(f"rpc {self.host}:{self.port}: malformed frame: "
                          f"{type(e).__name__}: {e}", flush=True)
                    return
                if req is None:
                    return
                method = req.get("method", "")
                try:
                    if failpoint.ENABLED and \
                            failpoint.hit("store.handler", method=method):
                        return          # drop: no reply, connection dies
                except failpoint.FailpointPanic:
                    self._panic()
                    return
                except failpoint.FailpointError as e:
                    try:
                        send_msg(conn, {"ok": False,
                                        "error": f"{type(e).__name__}: {e}"})
                        continue
                    except OSError:
                        return
                token = req.get("token")
                entry = None
                replay = False
                if token is not None:
                    with self._dedupe_mu:
                        entry = self._dedupe.get(token)
                        if entry is None:
                            # first copy: claim the token BEFORE executing
                            # so a retry arriving mid-execution waits for
                            # this outcome instead of re-executing (the
                            # double-execute race a completed-only cache
                            # still has)
                            entry = {"done": threading.Event(),
                                     "resp": None}
                            self._dedupe[token] = entry
                            if len(self._dedupe) > self.DEDUPE_MAX:
                                # evict COMPLETED entries only: dropping a
                                # claimed-but-executing token would let its
                                # retry re-execute — the exact race the
                                # cache exists to close
                                for tok in list(self._dedupe):
                                    if len(self._dedupe) <= self.DEDUPE_MAX:
                                        break
                                    if self._dedupe[tok]["done"].is_set():
                                        del self._dedupe[tok]
                        else:
                            replay = True
                    if replay:
                        metrics.rpc_dedup_hits.add(1)
                        budget = req.get("deadline_ms")
                        wait_s = min(30.0, float(budget) / 1e3
                                     if budget is not None else 10.0)
                        entry["done"].wait(wait_s)
                        resp = entry["resp"]
                        if resp is None:
                            resp = {"ok": False,
                                    "error": "RetryInProgress: first "
                                             "attempt still executing"}
                        try:
                            send_msg(conn, resp)
                        except OSError:
                            return
                        continue
                deadline_ms = req.get("deadline_ms")
                _BUDGET.until = None if deadline_ms is None else \
                    time.monotonic() + float(deadline_ms) / 1e3
                fn = self._handlers.get(method)
                wire = req.get("trace")
                buf = None

                def run():
                    if fn is None:
                        raise RpcError(f"unknown method {method!r}")
                    rem = handler_deadline_s()
                    if rem is not None and rem <= 0:
                        # the caller's budget is already gone (a delay
                        # failpoint or a slow queue ate it): don't do work
                        # nobody is waiting for
                        raise RpcError("DeadlineExceeded: caller budget "
                                       "exhausted before dispatch")
                    return {"ok": True,
                            "result": fn(**req.get("args", {}))}
                # only KNOWN methods mint metric children: the label value
                # is client-supplied, and an unknown-method probe must not
                # grow the registry one Gauge+Histogram row per spelling
                instrumented = self._m_inflight is not None \
                    and fn is not None
                if instrumented:
                    self._m_inflight.labels(method=method).add(1)
                t_h = time.perf_counter()
                try:
                    try:
                        if isinstance(wire, dict):
                            # caller's sampling decision propagates: record
                            # handler spans under ITS trace and ship them
                            # back for the frontend tree (obs/trace.py)
                            with trace.adopt(wire, f"serve.{method}",
                                             node=self.trace_node) as buf:
                                resp = run()
                        else:
                            resp = run()
                    except failpoint.FailpointPanic:
                        # a panic failpoint fired INSIDE the handler (e.g.
                        # binlog.append): the daemon crashes, no reply
                        self._panic()
                        return
                    except Exception as e:  # noqa: BLE001 — fault isolation per call
                        resp = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
                finally:
                    if instrumented:
                        self._m_inflight.labels(method=method).add(-1)
                        self._m_handler.labels(method=method).observe(
                            (time.perf_counter() - t_h) * 1e3)
                if buf:
                    resp["trace_spans"] = list(buf)
                if entry is not None:
                    # publish the outcome: retries waiting on this token
                    # (and any later resend) replay it instead of
                    # re-executing
                    entry["resp"] = resp
                    entry["done"].set()
                try:
                    send_msg(conn, resp)
                except OSError:
                    return


# wall-clock retry jitter: deliberately NOT the chaos RNG — fault schedules
# are deterministic per failpoint (chaos/failpoint.py); backoff spacing is
# an anti-thundering-herd measure, not part of the replayed schedule
_JITTER = Random()
_TOKEN_TAG = uuid.uuid4().hex[:12]
_TOKENS = itertools.count(1)


def _new_token() -> str:
    """Process-unique idempotency token (uuid tag + counter: two frontends
    can never mint the same token, and tokens are cheap)."""
    return f"{_TOKEN_TAG}.{next(_TOKENS)}"


def _fp_rpc(point: str, **ctx) -> bool:
    """Client-seam failpoint evaluation honoring RpcClient's error
    contract: an injected ``return(msg)`` surfaces as RpcError — the type
    the routing/retry loops already absorb — never as a bare RuntimeError
    that would blow through them."""
    try:
        return failpoint.ENABLED and failpoint.hit(point, **ctx)
    except failpoint.FailpointError as e:
        raise RpcError(str(e)) from None


class RpcClient:
    """One persistent connection to a peer; reconnects on failure, retries
    transport failures with backoff + jitter inside one per-call deadline
    budget (``timeout``), and stamps non-idempotent calls with an
    idempotency token so resends dedupe at the server."""

    def __init__(self, address: str, timeout: float = 5.0):
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._mu = threading.Lock()

    def _connect(self, timeout: Optional[float] = None) -> socket.socket:
        s = socket.create_connection(
            (self.host, self.port),
            timeout=self.timeout if timeout is None else timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    # Methods idempotent by protocol: reads, health, and ops where a
    # duplicate is a no-op (raft messages dedupe by term/index; drops are
    # no-ops the second time).  These resend WITHOUT a token.  Everything
    # else (split_region_key, create_regions, propose, ...) carries an
    # idempotency token so the server's dedupe cache makes resends safe —
    # the first copy may have executed with the response lost, and a
    # duplicated split would mint a second child region with an identical
    # start key, bricking the table layout.
    _IDEMPOTENT = frozenset({
        "ping", "scan_raw", "txn_status", "region_size", "region_status",
        "instances", "table_regions", "heartbeat", "tso", "raft_msg",
        "drop_region", "drop_regions", "register_store", "cold_manifest",
        "exec_fragment", "fragment_execute", "metrics", "prometheus",
        "health",
        # AOT artifact tier: reads, plus puts/publishes that are
        # idempotent by construction (same key -> same bytes; the meta
        # manifest is last-writer-wins on identical content)
        "aot_fetch", "aot_fetch_xla", "aot_list", "aot_lookup",
        "aot_manifest", "aot_put", "aot_put_xla", "aot_publish",
        # fragment artifact tier: same discipline (same key -> same bytes)
        "frag_put", "frag_fetch",
    })

    # Fire-and-forget at the transport: raft IS its own retry protocol
    # (retransmit on tick, dedupe by term/index is only half the story —
    # a transport-level resend re-delivers STALE acks out of order, which
    # churns the leader's nextIndex into ever-longer suffix retransmits:
    # under a 25% injected response-drop the raft_msg traffic went
    # superlinear until writes starved).  A lost raft message is the case
    # the protocol is built for; the transport must not "help".
    _FIRE_AND_FORGET = frozenset({"raft_msg"})

    def call(self, method: str, **args):
        with self._mu, trace.span(f"rpc.{method}",
                                  peer=f"{self.host}:{self.port}"):
            # wire context captured INSIDE the rpc span: the daemon's
            # serve.* span nests under it, not beside it
            wire = trace.wire_context()
            req = {"method": method, "args": args}
            if wire is not None:
                req["trace"] = wire
            if method not in self._IDEMPOTENT:
                req["token"] = _new_token()
            resp = self._call_retrying(method, req)
            remote = resp.get("trace_spans")
            if remote:
                # the daemon's spans already carry this trace's ids:
                # stitch them under the rpc span that crossed the wire
                trace.absorb(remote)
            if not resp.get("ok"):
                raise RpcError(resp.get("error", "rpc failed"))
            return resp.get("result")

    def _call_retrying(self, method: str, req: dict) -> dict:
        """One logical call under the retry policy.  All attempts share one
        deadline budget (``self.timeout``) that also rides the request as
        the ``deadline_ms`` header; between attempts: exponential backoff
        with full jitter.  Connection-refused raises immediately (the
        caller's routing loop owns peer rotation — burning the budget on a
        dead peer would starve the live ones); a failure after an
        established connection retries, which the idempotency token makes
        safe for mutating methods."""
        deadline = time.monotonic() + self.timeout
        backoff = max(1.0, float(FLAGS.rpc_backoff_ms)) / 1e3
        retries = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                metrics.rpc_timeouts.add(1)
                raise RpcTimeout(
                    f"rpc {method} to {self.host}:{self.port}: deadline "
                    f"budget ({self.timeout}s) exhausted after "
                    f"{retries} retries")
            # KILL integration (obs/progress.py): a killed query must not
            # even send an idempotent call.  Non-idempotent (tokened)
            # methods are exempt end to end — interrupting a write whose
            # outcome is unknown would break exactly-once; they run to
            # their own deadline and the kill lands at the next statement
            # boundary.
            tok = progress.cancel_token()
            if tok is not None and tok.killed() \
                    and method in self._IDEMPOTENT:
                raise progress.QueryKilled()
            try:
                if self._sock is None:
                    self._sock = self._connect(remaining)
                self._sock.settimeout(remaining)
                if _fp_rpc("rpc.send", method=method,
                           peer=f"{self.host}:{self.port}"):
                    raise OSError("rpc.send dropped (failpoint)")
                req["deadline_ms"] = int(remaining * 1e3)
                send_msg(self._sock, req)
                if _fp_rpc("rpc.recv", method=method,
                           peer=f"{self.host}:{self.port}"):
                    # the server got (and executes) the request; its
                    # response is lost with the connection
                    raise OSError("rpc.recv dropped (failpoint)")
                resp = self._recv_cancellable(method, deadline)
                if resp is None:
                    raise OSError("connection closed")
                return resp
            except (socket.timeout, TimeoutError):
                self.close_locked()
                metrics.rpc_timeouts.add(1)
                raise RpcTimeout(
                    f"rpc {method} to {self.host}:{self.port} timed out "
                    f"({self.timeout}s budget, {retries} retries)") from None
            except OSError:
                conn_failed = self._sock is None    # _connect itself failed
                self.close_locked()
                if conn_failed or method in self._FIRE_AND_FORGET or \
                        retries >= int(FLAGS.rpc_retry_max):
                    raise
                retries += 1
                metrics.rpc_retries.add(1)
                trace.event("rpc.retry", method=method, attempt=retries,
                            peer=f"{self.host}:{self.port}")
                delay = _JITTER.uniform(0.0, backoff)
                if time.monotonic() + delay >= deadline:
                    metrics.rpc_timeouts.add(1)
                    raise RpcTimeout(
                        f"rpc {method} to {self.host}:{self.port}: deadline "
                        f"budget ({self.timeout}s) exhausted after "
                        f"{retries} retries") from None
                time.sleep(delay)
                backoff = min(backoff * 2.0, 1.0)

    def _recv_cancellable(self, method: str, deadline: float):
        """The response wait, interruptible by KILL for IDEMPOTENT methods
        only: poll the live query's cancel token between short select()
        slices, then do the normal blocking receive once bytes are
        pending.  select-before-recv (never a sliced recv) so a timeout
        can never strand a partial frame and desync the stream.  On kill
        the connection is severed — the response may still arrive later,
        and the next call must start on a clean stream."""
        tok = progress.cancel_token()
        if tok is None or method not in self._IDEMPOTENT:
            return recv_msg(self._sock)
        while True:
            if tok.killed():
                self.close_locked()
                raise progress.QueryKilled()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("deadline while polling for response")
            r, _, _ = select.select([self._sock], [], [],
                                    min(0.05, remaining))
            if r:
                return recv_msg(self._sock)

    def try_call(self, method: str, **args):
        """call() that returns None instead of raising on transport/handler
        failure (fan-out paths where a dead peer is expected).  Injected
        FailpointErrors count as failures too — chaos must not crash the
        tick/heartbeat loops that use this."""
        try:
            return self.call(method, **args)
        except (OSError, RpcError, failpoint.FailpointError):
            return None

    def close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._mu:
            self.close_locked()
