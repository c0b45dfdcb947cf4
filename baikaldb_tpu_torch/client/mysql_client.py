"""Minimal MySQL-protocol client (the baikal-client SDK analog).

The reference ships a C++ SDK over libmariadb with service discovery and
connection pools (baikal-client/).  This is the protocol core: a pure-python
client that speaks protocol 41 text mode and the binary prepared-statement
protocol against any MySQL-compatible server (including
server/mysql_server.py), a change-stream cursor over FETCH, and a tiny
connection pool.

The port of ``baikaldb_tpu/client/mysql_client.py``, over the port's
``Packets`` (server/mysql_server.py); it speaks to either package's
server.
"""

from __future__ import annotations

import socket
import struct
import threading
from dataclasses import dataclass
from typing import Optional

from ..server.mysql_server import Packets, lenenc_int


class MySQLError(RuntimeError):
    def __init__(self, code: int, msg: str):
        super().__init__(f"({code}) {msg}")
        self.code = code


def _read_lenenc(data: bytes, pos: int) -> tuple[Optional[int], int]:
    b = data[pos]
    if b < 0xFB:
        return b, pos + 1
    if b == 0xFB:
        return None, pos + 1
    if b == 0xFC:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if b == 0xFD:
        return int.from_bytes(data[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9


@dataclass
class QueryResult:
    columns: list[str]
    rows: list[tuple]
    affected_rows: int = 0


class Connection:
    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 user: str = "root", database: str = "", password: str = ""):
        self.host, self.port = host, port
        self.sock = socket.create_connection((host, port), timeout=30)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.p = Packets(self.sock)
        self._handshake(user, database, password)

    def _handshake(self, user: str, database: str, password: str):
        greet = self.p.read()
        if greet is None:
            raise ConnectionError("no handshake from server")
        if greet[0] == 0xFF:
            raise MySQLError(struct.unpack_from("<H", greet, 1)[0],
                             greet[9:].decode(errors="replace"))
        # salt: 8 bytes after server version NUL + thread id, 12 more in the
        # extension block (protocol 10 layout)
        pos = greet.find(b"\x00", 1) + 5
        salt = greet[pos:pos + 8]
        # the second salt chunk sits past filler/caps/charset/status/reserved
        salt2_off = pos + 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        salt = salt + greet[salt2_off:salt2_off + 12]
        caps = 0x00000200 | 0x00008000 | 0x00000001      # PROTOCOL_41|SECURE|LONG_PW
        if database:
            caps |= 0x00000008
        auth = b""
        if password:
            import hashlib

            def sha1(b: bytes) -> bytes:
                return hashlib.sha1(b).digest()

            sha_pw = sha1(password.encode())
            mask = sha1(salt + sha1(sha_pw))
            auth = bytes(a ^ b for a, b in zip(sha_pw, mask))
        payload = (struct.pack("<I", caps) + struct.pack("<I", 1 << 24) +
                   bytes([0x21]) + b"\x00" * 23 + user.encode() + b"\x00" +
                   bytes([len(auth)]) + auth)
        if database:
            payload += database.encode() + b"\x00"
        self.p.write(payload)
        resp = self.p.read()
        if resp is None:
            raise ConnectionError("server closed during auth")
        if resp[0] == 0xFF:
            raise MySQLError(struct.unpack_from("<H", resp, 1)[0],
                             resp[9:].decode(errors="replace"))

    # -- prepared statements (binary protocol) -------------------------------
    def prepare(self, sql: str) -> int:
        """COM_STMT_PREPARE -> statement id."""
        self.p.reset()
        self.p.write(b"\x16" + sql.encode())
        resp = self.p.read()
        if resp is None:
            raise ConnectionError("server closed")
        if resp[0] == 0xFF:
            raise MySQLError(struct.unpack_from("<H", resp, 1)[0],
                             resp[9:].decode(errors="replace"))
        sid = struct.unpack_from("<I", resp, 1)[0]
        nparams = struct.unpack_from("<H", resp, 7)[0]
        for _ in range(nparams + (1 if nparams else 0)):   # defs + EOF
            self.p.read()
        return sid

    def execute(self, sid: int, params: tuple = ()) -> QueryResult:
        """COM_STMT_EXECUTE with binary params; decodes binary result rows."""
        self.p.reset()
        body = b"\x17" + struct.pack("<I", sid) + b"\x00" + \
            struct.pack("<I", 1)
        n = len(params)
        if n:
            bitmap = bytearray((n + 7) // 8)
            types = b""
            vals = b""
            for i, v in enumerate(params):
                if v is None:
                    bitmap[i // 8] |= 1 << (i % 8)
                    types += struct.pack("<H", 6)          # MYSQL_TYPE_NULL
                elif isinstance(v, bool):
                    types += struct.pack("<H", 1)
                    vals += struct.pack("<b", int(v))
                elif isinstance(v, int):
                    types += struct.pack("<H", 8)
                    vals += struct.pack("<q", v)
                elif isinstance(v, float):
                    types += struct.pack("<H", 5)
                    vals += struct.pack("<d", v)
                else:
                    types += struct.pack("<H", 253)
                    b = str(v).encode()
                    vals += lenenc_int(len(b)) + b
            body += bytes(bitmap) + b"\x01" + types + vals
        self.p.write(body)
        first = self.p.read()
        if first is None:
            raise ConnectionError("server closed")
        if first[0] == 0xFF:
            raise MySQLError(struct.unpack_from("<H", first, 1)[0],
                             first[9:].decode(errors="replace"))
        if first[0] == 0x00:
            affected, _ = _read_lenenc(first, 1)
            return QueryResult([], [], affected or 0)
        ncols, _ = _read_lenenc(first, 0)
        columns = []
        while True:
            pkt = self.p.read()
            if pkt is None:
                raise ConnectionError("server closed mid result")
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            pos = 0
            vals2 = []
            for _ in range(6):
                ln, pos = _read_lenenc(pkt, pos)
                vals2.append(pkt[pos:pos + (ln or 0)])
                pos += ln or 0
            columns.append(vals2[4].decode())
        rows = []
        while True:
            pkt = self.p.read()
            if pkt is None:
                raise ConnectionError("server closed mid rows")
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            # binary row: 0x00 header + null bitmap (offset 2) + lenenc vals
            nb = (ncols + 9) // 8
            bitmap = pkt[1:1 + nb]
            pos = 1 + nb
            row = []
            for i in range(ncols):
                if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                    row.append(None)
                else:
                    ln, pos = _read_lenenc(pkt, pos)
                    row.append(pkt[pos:pos + ln].decode())
                    pos += ln
            rows.append(tuple(row))
        return QueryResult(columns, rows)

    def query(self, sql: str) -> QueryResult:
        from ..obs import trace

        # client-observed wall time (queueing + wire + server); a child
        # span only when the CALLING process has a live trace — the wire
        # protocol itself carries no trace header (MySQL compatibility)
        with trace.span("client.query", peer=f"{self.host}:{self.port}"):
            return self._query(sql)

    def _query(self, sql: str) -> QueryResult:
        self.p.reset()
        self.p.write(b"\x03" + sql.encode())
        first = self.p.read()
        if first is None:
            raise ConnectionError("server closed")
        if first[0] == 0xFF:
            raise MySQLError(struct.unpack_from("<H", first, 1)[0],
                             first[9:].decode(errors="replace"))
        if first[0] == 0x00:                              # OK packet
            affected, pos = _read_lenenc(first, 1)
            return QueryResult([], [], affected or 0)
        ncols, _ = _read_lenenc(first, 0)
        columns = []
        while True:
            pkt = self.p.read()
            if pkt is None:
                raise ConnectionError("server closed mid result")
            if pkt[0] == 0xFE and len(pkt) < 9:           # EOF
                break
            # column definition: skip catalog/schema/table/org_table, read name
            pos = 0
            vals = []
            for _ in range(6):
                ln, pos = _read_lenenc(pkt, pos)
                vals.append(pkt[pos:pos + (ln or 0)])
                pos += ln or 0
            columns.append(vals[4].decode())
        rows = []
        while True:
            pkt = self.p.read()
            if pkt is None:
                raise ConnectionError("server closed mid rows")
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            if pkt[0] == 0xFF:
                raise MySQLError(struct.unpack_from("<H", pkt, 1)[0],
                                 pkt[9:].decode(errors="replace"))
            pos = 0
            row = []
            for _ in range(ncols):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    ln, pos = _read_lenenc(pkt, pos)
                    row.append(pkt[pos:pos + ln].decode())
                    pos += ln
            rows.append(tuple(row))
        return QueryResult(columns, rows)

    def ping(self) -> bool:
        self.p.reset()
        self.p.write(b"\x0e")
        r = self.p.read()
        return r is not None and r[0] == 0x00

    def close(self):
        try:
            self.p.reset()
            self.p.write(b"\x01")
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class PreparedStatement:
    """Client-side handle over COM_STMT_PREPARE/EXECUTE: prepare once,
    execute many with positional ``?`` params.

    Server-side the bound statement rides the auto-parameterized plan cache
    (plan/paramize.py), so repeated executes of one shape reuse one cached
    plan, and concurrent executes of one shape coalesce in the batched
    dispatcher (exec/dispatch.py) — the intended hot path for point-query
    traffic (reference: baikal-client prepared statements over
    libmariadb)."""

    def __init__(self, conn: Connection, sql: str):
        self.conn = conn
        self.sql = sql
        self.sid = conn.prepare(sql)
        self._closed = False

    def execute(self, params: tuple = ()) -> QueryResult:
        if self._closed:
            raise MySQLError(1243, f"prepared statement closed: {self.sql}")
        return self.conn.execute(self.sid, tuple(params))

    def close(self) -> None:
        """COM_STMT_CLOSE (no response packet)."""
        if self._closed:
            return
        self._closed = True
        try:
            self.conn.p.reset()
            self.conn.p.write(b"\x19" + struct.pack("<I", self.sid))
        except OSError:
            pass        # connection already gone: nothing to free

    def __enter__(self) -> "PreparedStatement":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


@dataclass
class ChangeEvent:
    """One decoded CDC event from FETCH (cdc/streams.py over the wire)."""
    commit_ts: int
    event_type: str
    table: str
    rows: list
    statement: str
    affected: int


class SubscriptionCursor:
    """Client-side change-stream iterator (the baikal_capturer SDK analog):
    ``CREATE SUBSCRIPTION`` once, then repeated ``FETCH`` batches decoded
    into :class:`ChangeEvent`.  The server acks each delivered batch
    durably, so a reconnecting client resumes exactly where the last FETCH
    left off — the cursor is the server-side resume token, not client
    state."""

    def __init__(self, conn: Connection, name: str,
                 table: Optional[str] = None, batch: int = 0):
        self.conn = conn
        self.name = name
        self.batch = batch
        on = f" ON {table}" if table else ""
        conn.query(f"CREATE SUBSCRIPTION IF NOT EXISTS {name}{on}")

    def fetch(self) -> list[ChangeEvent]:
        """One FETCH batch (empty list = caught up)."""
        import json

        n = f"{self.batch} " if self.batch else ""
        res = self.conn.query(f"FETCH {n}FROM {self.name}")
        return [ChangeEvent(commit_ts=int(r[0]), event_type=str(r[1]),
                            table=str(r[2]),
                            rows=json.loads(r[3]) if r[3] else [],
                            statement=str(r[4] or ""),
                            affected=int(r[5] or 0))
                for r in res.rows]

    def __iter__(self):
        """Drain until caught up (a tailing client calls fetch() in its
        own poll loop; iteration is the catch-up read)."""
        while True:
            got = self.fetch()
            if not got:
                return
            yield from got

    def drop(self) -> None:
        self.conn.query(f"DROP SUBSCRIPTION IF EXISTS {self.name}")


class Pool:
    """Tiny connection pool (reference: baikal_client connection pools with
    health checks; health = ping-on-borrow here)."""

    def __init__(self, host: str, port: int, size: int = 4, user: str = "root"):
        self.host, self.port, self.user = host, port, user
        self.size = size
        self._idle: list[Connection] = []
        self._mu = threading.Lock()

    def acquire(self) -> Connection:
        with self._mu:
            while self._idle:
                c = self._idle.pop()
                try:
                    if c.ping():
                        return c
                except OSError:
                    pass
                c.close()
        return Connection(self.host, self.port, self.user)

    def release(self, c: Connection):
        with self._mu:
            if len(self._idle) < self.size:
                self._idle.append(c)
                return
        c.close()

    def query(self, sql: str) -> QueryResult:
        c = self.acquire()
        try:
            return c.query(sql)
        finally:
            self.release(c)
