"""The port's RPC plane (baikaldb_tpu_torch/utils/net.py) against the JAX
package's.

``tests/test_net_retry.py``'s eight cases run on the port: a non-idempotent
method is resent under one idempotency token, an idempotent one without,
``raft_msg`` is fire-and-forget, the server's dedupe executes a token once,
an exhausted deadline raises the typed ``RpcTimeout`` and the deadline
reaches the handler, a malformed frame is counted and survived.  Then the
wire itself: the port's ``send_msg`` writes byte for byte the JAX
package's frame for the same seeded messages (bytes fields, nested lists,
floats, unicode), each package's ``recv_msg`` decodes the other's frame,
and a client of either package calls a server of the other, tokens and
dedupe included.
"""

import random
import socket
import threading
import time

import pytest

from baikaldb_tpu.utils import net as jnet
from baikaldb_tpu_torch.utils import metrics
from baikaldb_tpu_torch.utils import net as tnet
from baikaldb_tpu_torch.utils.flags import FLAGS
from baikaldb_tpu_torch.utils.net import (RpcClient, RpcError, RpcServer,
                                          RpcTimeout, handler_deadline_s,
                                          recv_msg, send_msg)


class OneShotDropServer:
    """Processes each request, then closes the connection WITHOUT replying —
    the worst case: work done, response lost.  No dedupe (a raw socket
    server), so every resend is visible in ``seen``."""

    def __init__(self):
        self.seen: list[dict] = []
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        self._srv.settimeout(0.2)
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except TimeoutError:
                continue
            with conn:
                conn.settimeout(1.0)
                try:
                    req = recv_msg(conn)
                except TimeoutError:
                    continue
                if req is not None:
                    self.seen.append(req)
                # close without replying

    def close(self):
        self._stop = True
        self._thread.join()
        self._srv.close()


class CountingServer:
    """Replies normally but records every request (duplicate detector)."""

    def __init__(self):
        self.seen: list[dict] = []
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        self._srv.settimeout(0.2)
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except TimeoutError:
                continue
            with conn:
                conn.settimeout(0.3)    # so close() can always join
                while not self._stop:
                    try:
                        req = recv_msg(conn)
                    except TimeoutError:
                        continue
                    if req is None:
                        break
                    self.seen.append(req)
                    send_msg(conn, {"ok": True, "result": "pong"})

    def close(self):
        self._stop = True
        self._thread.join()
        self._srv.close()


def test_non_idempotent_resent_with_one_token():
    """A mutating method IS resent after a lost response — but every copy
    carries the SAME idempotency token, so a dedupe-aware server executes
    once.  Without dedupe (this raw server) the copies are visible:
    1 original + rpc_retry_max resends."""
    srv = OneShotDropServer()
    try:
        c = RpcClient(f"127.0.0.1:{srv.port}", timeout=5.0)
        with pytest.raises(OSError):
            c.call("split_region_key", region_id=1, split_key_hex="00")
        frames = [r for r in srv.seen if r["method"] == "split_region_key"]
        assert len(frames) == 1 + int(FLAGS.rpc_retry_max)
        tokens = {r.get("token") for r in frames}
        assert len(tokens) == 1 and None not in tokens
    finally:
        srv.close()


def test_idempotent_resent_without_token():
    srv = OneShotDropServer()
    try:
        c = RpcClient(f"127.0.0.1:{srv.port}", timeout=5.0)
        with pytest.raises(OSError):
            c.call("ping")
        frames = [r for r in srv.seen if r["method"] == "ping"]
        assert len(frames) == 1 + int(FLAGS.rpc_retry_max)
        assert all(r.get("token") is None for r in frames)
    finally:
        srv.close()


def test_raft_msg_is_fire_and_forget():
    """raft messages never resend at the transport: raft retransmits by
    protocol, and duplicated stale acks churn the leader's nextIndex."""
    srv = OneShotDropServer()
    try:
        c = RpcClient(f"127.0.0.1:{srv.port}", timeout=5.0)
        with pytest.raises(OSError):
            c.call("raft_msg", region_id=1, msg=b"x")
        assert len([r for r in srv.seen if r["method"] == "raft_msg"]) == 1
    finally:
        srv.close()


def test_dedupe_executes_exactly_once():
    """The exactly-once contract end to end: a real RpcServer with a
    non-idempotent counting handler; resends of one token execute once."""
    srv = RpcServer("127.0.0.1", 0)
    hits = []
    srv.register("bump", lambda: hits.append(1) or len(hits))
    srv.start()
    try:
        c = RpcClient(f"127.0.0.1:{srv.port}", timeout=5.0)
        token = "tok.exactly.once"
        req = {"method": "bump", "args": {}, "token": token}
        first = c._call_retrying("bump", req)
        again = c._call_retrying("bump", dict(req))   # same token, resend
        assert first["ok"] and again["ok"]
        assert first["result"] == again["result"] == 1
        assert hits == [1]
        assert metrics.rpc_dedup_hits.value >= 1
    finally:
        srv.stop()


def test_deadline_budget_raises_typed_timeout():
    """A hung handler exhausts the per-call budget: the typed RpcTimeout
    (an RpcError subclass) raises and metrics.rpc_timeouts counts it."""
    srv = RpcServer("127.0.0.1", 0)
    srv.register("hang", lambda: time.sleep(5.0))
    srv.start()
    try:
        before = metrics.rpc_timeouts.value
        c = RpcClient(f"127.0.0.1:{srv.port}", timeout=0.3)
        with pytest.raises(RpcTimeout):
            c.call("hang")
        assert issubclass(RpcTimeout, RpcError)
        assert metrics.rpc_timeouts.value > before
    finally:
        srv.stop()


def test_deadline_budget_propagates_to_handler():
    """The deadline_ms header reaches the serving daemon: a handler
    observing handler_deadline_s() sees (at most) the client's budget."""
    seen = []
    srv = RpcServer("127.0.0.1", 0)
    srv.register("peek", lambda: seen.append(handler_deadline_s()) or "ok")
    srv.start()
    try:
        c = RpcClient(f"127.0.0.1:{srv.port}", timeout=2.0)
        assert c.call("peek") == "ok"
        assert len(seen) == 1 and seen[0] is not None
        assert 0.0 < seen[0] <= 2.0
    finally:
        srv.stop()


def test_malformed_frame_counted_not_fatal():
    """Garbage bytes on the wire: the server counts the bad frame
    (swallowed.rpc.bad_frame), drops that connection, and keeps serving."""
    srv = RpcServer("127.0.0.1", 0)
    srv.register("ping", lambda: "pong")
    srv.start()
    try:
        before = metrics.REGISTRY.counter("swallowed.rpc.bad_frame").value
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=2.0)
        # valid length prefix, invalid JSON body
        s.sendall(b"\x07\x00\x00\x00garbage")
        s.close()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if metrics.REGISTRY.counter(
                    "swallowed.rpc.bad_frame").value > before:
                break
            time.sleep(0.02)
        assert metrics.REGISTRY.counter(
            "swallowed.rpc.bad_frame").value > before
        # the server survived: a normal call on a fresh connection works
        c = RpcClient(f"127.0.0.1:{srv.port}", timeout=2.0)
        assert c.call("ping") == "pong"
    finally:
        srv.stop()


def test_normal_call_still_works():
    srv = CountingServer()
    try:
        c = RpcClient(f"127.0.0.1:{srv.port}", timeout=2.0)
        assert c.call("ping") == "pong"
        assert c.call("split_region_key", region_id=1) == "pong"
        assert [r["method"] for r in srv.seen] == ["ping",
                                                   "split_region_key"]
    finally:
        srv.close()


# -- the wire against the JAX package's ------------------------------------

def _messages(seed: int, n: int = 40) -> list:
    """Seeded RPC-shaped messages: requests with bytes payloads, nested
    lists of [key, value] byte pairs, floats, ints, NULLs and unicode."""
    rng = random.Random(seed)

    def value(depth: int):
        kind = rng.randrange(8 if depth < 3 else 6)
        if kind == 0:
            return rng.randbytes(rng.randrange(0, 40))
        if kind == 1:
            return rng.randrange(-2**62, 2**62)
        if kind == 2:
            return rng.uniform(-1e9, 1e9) * rng.choice([1, 1e-12, 1e12])
        if kind == 3:
            return "".join(rng.choice("abcxyz_é漢\u00ff\"\\ ") for _ in range(rng.randrange(12)))
        if kind == 4:
            return rng.choice([None, True, False, 0, -0.0, 0.5])
        if kind == 5:
            return [rng.randbytes(8), rng.randbytes(rng.randrange(30))]
        if kind == 6:
            return [value(depth + 1) for _ in range(rng.randrange(5))]
        return {f"k{i}": value(depth + 1) for i in range(rng.randrange(5))}

    return [{"method": rng.choice(["propose", "scan_raw", "fragment_execute", "metrics"]),
             "args": {f"a{i}": value(0) for i in range(rng.randrange(1, 6))},
             "token": None if rng.random() < 0.5 else f"t{rng.randrange(10**9)}",
             "deadline_ms": rng.uniform(1, 5000)} for _ in range(n)]


def _frame(send, msg) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        send(a, msg)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_byte_equal_to_jax(seed):
    for msg in _messages(seed):
        want = _frame(jnet.send_msg, msg)
        got = _frame(tnet.send_msg, msg)
        assert got == want
        # and each package decodes the other's frame to the same message
        for send, recv in ((jnet.send_msg, tnet.recv_msg), (tnet.send_msg, jnet.recv_msg)):
            a, b = socket.socketpair()
            with a, b:
                send(a, msg)
                assert recv(b) == recv_msg_roundtrip(msg)


def recv_msg_roundtrip(msg):
    """What a message reads back as: tuples become lists (JSON)."""
    return jnet._dec(jnet._enc(msg))


def _serve(pkg):
    srv = pkg.RpcServer("127.0.0.1", 0)
    hits = []
    srv.register("echo", lambda blob, n: {"blob": blob, "n": n + 1})
    srv.register("bump", lambda: hits.append(1) or len(hits))
    srv.start()
    return srv, hits


@pytest.mark.parametrize("client_pkg,server_pkg", [(tnet, jnet), (jnet, tnet)],
                         ids=["port_client-jax_server", "jax_client-port_server"])
def test_calls_cross_the_packages(client_pkg, server_pkg):
    srv, hits = _serve(server_pkg)
    try:
        c = client_pkg.RpcClient(f"127.0.0.1:{srv.port}", timeout=5.0)
        blob = bytes(range(256)) * 3
        assert c.call("echo", blob=blob, n=41) == {"blob": blob, "n": 42}
        # a non-idempotent call carries a token; a resend of it executes once
        req = {"method": "bump", "args": {}, "token": "tok.cross"}
        first = c._call_retrying("bump", req)
        again = c._call_retrying("bump", dict(req))
        assert first["result"] == again["result"] == 1 and hits == [1]
        with pytest.raises(client_pkg.RpcError):
            c.call("no_such_method")
        c.close()
    finally:
        srv.stop()
