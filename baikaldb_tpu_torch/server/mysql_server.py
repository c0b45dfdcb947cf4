"""MySQL wire-protocol frontend.

The reference's frontend is an epoll loop + per-connection state machine
speaking the MySQL client/server protocol (src/protocol/network_server.cpp,
state_machine.cpp, mysql_wrapper.cpp: handshake at mysql_wrapper.cpp:28, auth
parse, result-set/ok/err encode).  This is the same protocol surface built on
a thread-per-connection TCP server feeding Session.execute:

- protocol 10 handshake with per-connection random salt; mysql_native_password
  VERIFIED against the privilege catalog (meta/privileges.py) — wrong
  passwords get ER_ACCESS_DENIED,
- COM_QUERY (text protocol), COM_PING, COM_INIT_DB, COM_QUIT, COM_FIELD_LIST,
- COM_STMT_PREPARE/EXECUTE/CLOSE/RESET: server-side prepared statements with
  binary parameter decoding and binary result rows (reference: COM_STMT_* in
  state_machine.cpp hdr :118-119),
- result sets as column-definition + text/binary row packets; OK/ERR/EOF
  with the MySQL errno catalog (server/errors.py),
- a processlist registry feeding SHOW PROCESSLIST; KILL CONNECTION severs
  the registered socket.

The port of ``baikaldb_tpu/server/mysql_server.py``: the same bytes on the
wire (every column is declared VAR_STRING, values are the text of the
result's Python scalars, ``Result.rows`` going through Arrow's
``to_pylist``), over the port's ``Session``.  ``MySQLServer(db=None)``
builds a ``Database`` on the card; every connection's session runs on
``db.device``, one server thread a connection, all launching on that
device.

Any MySQL client (pymysql, mysql CLI, JDBC) can connect and run SQL.
"""

from __future__ import annotations

import datetime
import os
import socket
import struct
import threading
import time
from typing import Optional

from ..exec.session import Database, Result, Session, next_conn_id
from ..types import LType
from .errors import errno_for

CLIENT_PROTOCOL_41 = 0x00000200
CLIENT_PLUGIN_AUTH = 0x00080000
CLIENT_CONNECT_WITH_DB = 0x00000008
CLIENT_DEPRECATE_EOF = 0x01000000

SERVER_CAPS = (0x00000001 | CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41 |
               0x00008000 | CLIENT_PLUGIN_AUTH)  # LONG_PASSWORD|...|SECURE_CONN

# MySQL column type codes (protocol)
T_LONGLONG, T_DOUBLE, T_VARSTRING, T_DATE, T_DATETIME, T_TINY, T_LONG, T_FLOAT = \
    8, 5, 253, 10, 12, 1, 3, 4

_TYPE_MAP = {
    LType.BOOL: T_TINY, LType.INT8: T_TINY, LType.INT16: T_LONG,
    LType.INT32: T_LONG, LType.INT64: T_LONGLONG, LType.UINT32: T_LONG,
    LType.UINT64: T_LONGLONG, LType.FLOAT32: T_FLOAT, LType.FLOAT64: T_DOUBLE,
    LType.DECIMAL: T_DOUBLE, LType.DATE: T_DATE, LType.DATETIME: T_DATETIME,
    LType.TIMESTAMP: T_DATETIME, LType.STRING: T_VARSTRING,
}


def lenenc_int(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


class Packets:
    """Packet framing: 3-byte length + 1-byte sequence id."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0

    def read(self) -> Optional[bytes]:
        hdr = self._recvn(4)
        if hdr is None:
            return None
        ln = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
        self.seq = (hdr[3] + 1) & 0xFF
        return self._recvn(ln)

    def _recvn(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def write(self, payload: bytes):
        while True:
            part = payload[:0xFFFFFF]
            payload = payload[0xFFFFFF:]
            hdr = struct.pack("<I", len(part))[:3] + bytes([self.seq])
            self.seq = (self.seq + 1) & 0xFF
            self.sock.sendall(hdr + part)
            if len(part) < 0xFFFFFF:
                break

    def reset(self):
        self.seq = 0


class MySQLServer:
    """Thread-per-connection server (the NetworkServer analog; bthread M:N
    scheduling is replaced by OS threads — connection counts here are test
    scale, the data plane lives on the card)."""

    def __init__(self, db: Optional[Database] = None, host: str = "127.0.0.1",
                 port: int = 0, qos=None):
        self.db = db or Database()
        if qos is not None:
            self.db.qos = qos
        self.host = host
        self.port = port
        self._listener: Optional[socket.socket] = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    # -- lifecycle -------------------------------------------------------
    def start(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(64)
        self.port = s.getsockname()[1]
        self._listener = s
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self, close_db: bool = True):
        """Close the listener (open connections end with their clients);
        ``close_db`` also stops the database's background threads, as when
        the server owns it."""
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if close_db:
            self.db.close()   # background telemetry poller dies with the server

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            # disable Nagle: request/response protocol, every packet small —
            # without this each query stalls ~40ms on delayed ACKs
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            from ..utils import metrics
            metrics.connections_total.add(1)
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    # -- per-connection state machine ------------------------------------
    def _serve(self, conn: socket.socket):
        p = Packets(conn)
        # one id space with embedded Session ids: KILL <id> and the
        # processlist Id column resolve in the same table either way
        conn_id = next_conn_id()
        peer = "?"
        try:
            peer = "%s:%d" % conn.getpeername()
        except OSError:
            pass
        try:
            session = self._handshake(p, conn_id, peer)
            if session is None:
                return
            stmts: dict[int, tuple] = {}      # stmt_id -> (sql, nparams, types)
            stmt_ids = iter(range(1, 1 << 31))
            while True:
                p.reset()
                ent = self.db.processlist.get(conn_id, {})
                if ent.get("kill"):          # KILL CONNECTION landed while
                    return                   # a command was in flight
                ent.update(command="Sleep", info="", since=time.time())
                pkt = p.read()
                if pkt is None or not pkt:
                    return
                if self.db.processlist.get(conn_id, {}).get("kill"):
                    return
                cmd, body = pkt[0], pkt[1:]
                if cmd == 0x01:                       # COM_QUIT
                    return
                if cmd == 0x0E:                       # COM_PING
                    self._ok(p)
                    continue
                if cmd == 0x02:                       # COM_INIT_DB
                    try:
                        session.execute(f"USE `{body.decode()}`")
                        self.db.processlist.get(conn_id, {}).update(
                            db=session.current_db)
                        self._ok(p)
                    except Exception as e:
                        code, state = errno_for(e)
                        self._err(p, code, str(e), state)
                    continue
                if cmd == 0x03:                       # COM_QUERY
                    sql = body.decode(errors="replace")
                    # full text stored; SHOW PROCESSLIST truncates Info at
                    # render time (100 chars) unless FULL was asked
                    self.db.processlist.get(conn_id, {}).update(
                        command="Query", info=sql, since=time.time())
                    self._query(p, session, sql)
                    continue
                if cmd == 0x04:                       # COM_FIELD_LIST (legacy)
                    self._eof(p)
                    continue
                if cmd == 0x16:                       # COM_STMT_PREPARE
                    sql = body.decode(errors="replace")
                    nparams = _count_placeholders(sql)
                    sid = next(stmt_ids)
                    stmts[sid] = (sql, nparams, None)
                    self._stmt_prepare_ok(p, sid, nparams)
                    continue
                if cmd == 0x17:                       # COM_STMT_EXECUTE
                    self._stmt_execute(p, session, stmts, body)
                    continue
                if cmd == 0x19:                       # COM_STMT_CLOSE (no resp)
                    if len(body) >= 4:
                        stmts.pop(struct.unpack_from("<I", body)[0], None)
                    continue
                if cmd == 0x1A:                       # COM_STMT_RESET
                    self._ok(p)
                    continue
                self._err(p, 1047, f"unsupported command {cmd:#x}")
        except (ConnectionError, BrokenPipeError, OSError):
            pass
        finally:
            self.db.processlist.pop(conn_id, None)
            try:
                conn.close()
            except OSError:
                pass

    def _handshake(self, p: Packets, conn_id: int, peer: str):
        """Initial Handshake v10 + mysql_native_password verification
        (reference: mysql_wrapper.cpp:28 handshake, privilege check against
        the meta privilege catalog).  Returns the authenticated Session, or
        None (error already sent)."""
        # 20 printable salt bytes, cryptographically random per connection
        salt = bytes(33 + b % 94 for b in os.urandom(20))
        payload = (bytes([10]) + b"8.0.0-baikaldb-tpu\x00" +
                   struct.pack("<I", conn_id) + salt[:8] + b"\x00" +
                   struct.pack("<H", SERVER_CAPS & 0xFFFF) +
                   bytes([0x21]) +                      # charset utf8
                   struct.pack("<H", 0x0002) +          # status autocommit
                   struct.pack("<H", (SERVER_CAPS >> 16) & 0xFFFF) +
                   bytes([21]) + b"\x00" * 10 +
                   salt[8:] + b"\x00" + b"mysql_native_password\x00")
        p.write(payload)
        resp = p.read()
        if resp is None:
            raise ConnectionError("client hung up during handshake")
        user, auth_resp, dbname = "", b"", None
        if len(resp) >= 32:
            caps = struct.unpack_from("<I", resp, 0)[0]
            pos = 32
            end = resp.find(b"\x00", pos)
            user = resp[pos:end].decode(errors="replace")
            pos = end + 1
            if pos < len(resp):
                alen = resp[pos]
                auth_resp = resp[pos + 1:pos + 1 + alen]
                pos += 1 + alen
            if caps & CLIENT_CONNECT_WITH_DB and pos < len(resp):
                end = resp.find(b"\x00", pos)
                if end > pos:
                    dbname = resp[pos:end].decode(errors="replace")
        if not self.db.privileges.authenticate(user, salt, auth_resp):
            self._err(p, 1045, f"Access denied for user '{user}'", "28000")
            return None
        session = Session(self.db, user=user)
        # the session answers CONNECTION_ID() and runs queries under this
        # id: KILL QUERY <id> must find the wire connection's work
        session._conn_id = conn_id
        if dbname:
            try:
                session.execute(f"USE `{dbname}`")
            except Exception as e:
                code, state = errno_for(e)
                self._err(p, code, str(e), state)
                return None
        self.db.processlist[conn_id] = {
            "user": user, "host": peer, "db": session.current_db,
            "command": "Sleep", "info": "", "since": time.time(),
            "_sock": p.sock}          # KILL CONNECTION severs it mid-read
        self._ok(p)
        return session

    # -- responses --------------------------------------------------------
    def _ok(self, p: Packets, affected: int = 0):
        p.write(b"\x00" + lenenc_int(affected) + lenenc_int(0) +
                struct.pack("<H", 0x0002) + struct.pack("<H", 0))

    def _err(self, p: Packets, code: int, msg: str, sqlstate: str = "HY000"):
        p.write(b"\xff" + struct.pack("<H", code) +
                b"#" + sqlstate.encode()[:5] + msg.encode()[:400])

    def _eof(self, p: Packets):
        p.write(b"\xfe" + struct.pack("<H", 0) + struct.pack("<H", 0x0002))

    def _query(self, p: Packets, session: Session, sql: str):
        from ..obs import trace

        # wire-level trace root: session.execute's root degrades to a child
        # span under it, so a kept trace shows protocol encode time too —
        # "from wire protocol to device and back"
        with trace.root("wire.query", sql):
            try:
                res = session.execute(sql)
            except Exception as e:                     # noqa: BLE001
                code, state = errno_for(e)
                self._err(p, code, f"{type(e).__name__}: {e}", state)
                return
            if res.arrow is None:
                self._ok(p, affected=res.affected_rows)
                return
            with trace.span("wire.result_set"):
                self._result_set(p, res)

    def _result_set(self, p: Packets, res: Result, binary: bool = False):
        """Column defs + text/binary rows (reference: PacketNode encode)."""
        table = res.arrow
        ncols = table.num_columns
        p.write(lenenc_int(ncols))
        for name in table.column_names:
            nb = name.encode()
            col = (lenenc_str(b"def") + lenenc_str(b"") + lenenc_str(b"") +
                   lenenc_str(b"") + lenenc_str(nb) + lenenc_str(nb) +
                   bytes([0x0c]) + struct.pack("<H", 0x21) +
                   struct.pack("<I", 1024) + bytes([T_VARSTRING]) +
                   struct.pack("<H", 0) + bytes([0]) + b"\x00\x00")
            p.write(col)
        self._eof(p)
        for row in res.rows:
            if binary:
                # binary row: header 0x00 + NULL bitmap (offset 2) + values;
                # every column is declared VAR_STRING, so values are lenenc
                bitmap = bytearray((ncols + 9) // 8)
                vals = b""
                for i, v in enumerate(row):
                    if v is None:
                        bitmap[(i + 2) // 8] |= 1 << ((i + 2) % 8)
                    else:
                        vals += lenenc_str(_text_value(v))
                p.write(b"\x00" + bytes(bitmap) + vals)
            else:
                out = b""
                for v in row:
                    if v is None:
                        out += b"\xfb"
                    else:
                        out += lenenc_str(_text_value(v))
                p.write(out)
        self._eof(p)

    # -- prepared statements (COM_STMT_*) ---------------------------------
    def _stmt_prepare_ok(self, p: Packets, sid: int, nparams: int):
        p.write(b"\x00" + struct.pack("<I", sid) + struct.pack("<H", 0) +
                struct.pack("<H", nparams) + b"\x00" + struct.pack("<H", 0))
        if nparams:
            for _ in range(nparams):
                nb = b"?"
                p.write(lenenc_str(b"def") + lenenc_str(b"") + lenenc_str(b"")
                        + lenenc_str(b"") + lenenc_str(nb) + lenenc_str(nb) +
                        bytes([0x0c]) + struct.pack("<H", 0x21) +
                        struct.pack("<I", 1024) + bytes([T_VARSTRING]) +
                        struct.pack("<H", 0) + bytes([0]) + b"\x00\x00")
            self._eof(p)

    def _stmt_execute(self, p: Packets, session: Session, stmts: dict,
                      body: bytes):
        if len(body) < 9:
            self._err(p, 1064, "malformed COM_STMT_EXECUTE")
            return
        sid = struct.unpack_from("<I", body, 0)[0]
        ent = stmts.get(sid)
        if ent is None:
            self._err(p, 1243, f"unknown prepared statement {sid}", "HY000")
            return
        sql, nparams, types = ent
        try:
            pos = 9                               # id(4) flags(1) iter(4)
            params: list = []
            if nparams:
                nb = (nparams + 7) // 8
                null_bitmap = body[pos:pos + nb]
                pos += nb
                new_bound = body[pos]
                pos += 1
                if new_bound:
                    types = []
                    for i in range(nparams):
                        types.append(struct.unpack_from("<H", body, pos)[0])
                        pos += 2
                    stmts[sid] = (sql, nparams, types)  # sticky per statement
                if types is None:
                    types = [T_VARSTRING] * nparams
                for i in range(nparams):
                    if null_bitmap[i // 8] & (1 << (i % 8)):
                        params.append(None)
                        continue
                    t = types[i] & 0xFF if i < len(types) else T_VARSTRING
                    v, pos = _read_binary_value(body, pos, t)
                    params.append(v)
        except (IndexError, struct.error) as e:
            # malformed/truncated execute body must produce an ERR packet,
            # never kill the connection thread
            self._err(p, 1064, f"malformed COM_STMT_EXECUTE: {e}")
            return
        try:
            bound = _bind_placeholders(sql, params)
            res = session.execute(bound)
        except Exception as e:                         # noqa: BLE001
            code, state = errno_for(e)
            self._err(p, code, f"{type(e).__name__}: {e}", state)
            return
        if res.arrow is None:
            self._ok(p, affected=res.affected_rows)
            return
        self._result_set(p, res, binary=True)


def _text_value(v) -> bytes:
    if isinstance(v, bool):
        return b"1" if v else b"0"
    if isinstance(v, float):
        return repr(v).encode()
    if isinstance(v, (datetime.date, datetime.datetime)):
        return str(v).encode()
    return str(v).encode()


# -- prepared-statement helpers ---------------------------------------------

def _count_placeholders(sql: str) -> int:
    """Count ? params outside string literals and comments."""
    n = 0
    i = 0
    quote = None
    while i < len(sql):
        ch = sql[i]
        if quote:
            if ch == "\\":
                i += 1              # backslash escape (lexer honors these)
            elif ch == quote:
                if i + 1 < len(sql) and sql[i + 1] == quote:
                    i += 1          # doubled quote
                else:
                    quote = None
        elif ch in ("'", '"', "`"):
            quote = ch
        elif ch == "#" or (ch == "-" and sql[i:i + 3].startswith("-- ")):
            nl = sql.find("\n", i)
            i = len(sql) if nl < 0 else nl
        elif sql[i:i + 2] == "/*":
            end = sql.find("*/", i + 2)
            i = len(sql) if end < 0 else end + 1
        elif ch == "?":
            n += 1
        i += 1
    return n


def _sql_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, bytes):
        v = v.decode(errors="replace")
    s = str(v).replace("\\", "\\\\").replace("'", "''")
    return f"'{s}'"


def _bind_placeholders(sql: str, params: list) -> str:
    """Substitute ? placeholders (outside quotes) with SQL literals."""
    out = []
    it = iter(params)
    quote = None
    i = 0
    while i < len(sql):
        ch = sql[i]
        if quote:
            out.append(ch)
            if ch == "\\" and i + 1 < len(sql):
                out.append(sql[i + 1])      # escaped char stays literal
                i += 1
            elif ch == quote:
                if i + 1 < len(sql) and sql[i + 1] == quote:
                    out.append(sql[i + 1])
                    i += 1
                else:
                    quote = None
        elif ch in ("'", '"', "`"):
            quote = ch
            out.append(ch)
        elif ch == "?":
            out.append(_sql_literal(next(it, None)))
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def _read_binary_value(body: bytes, pos: int, t: int):
    """Decode one binary-protocol parameter value -> (python value, new pos)."""
    if t == T_TINY:
        return struct.unpack_from("<b", body, pos)[0], pos + 1
    if t == 2:          # SHORT
        return struct.unpack_from("<h", body, pos)[0], pos + 2
    if t in (T_LONG, 9):   # LONG / INT24
        return struct.unpack_from("<i", body, pos)[0], pos + 4
    if t == T_LONGLONG:
        return struct.unpack_from("<q", body, pos)[0], pos + 8
    if t == T_FLOAT:
        return struct.unpack_from("<f", body, pos)[0], pos + 4
    if t == T_DOUBLE:
        return struct.unpack_from("<d", body, pos)[0], pos + 8
    if t in (T_DATE, T_DATETIME, 7, 11):   # date/datetime/timestamp/time
        ln = body[pos]
        pos += 1
        raw = body[pos:pos + ln]
        pos += ln
        if ln >= 4:
            y, m, d = struct.unpack_from("<HBB", raw, 0)
            if ln >= 7:
                hh, mi, ss = raw[4], raw[5], raw[6]
                return f"{y:04d}-{m:02d}-{d:02d} {hh:02d}:{mi:02d}:{ss:02d}", pos
            return f"{y:04d}-{m:02d}-{d:02d}", pos
        return None, pos
    # everything else: length-encoded string/blob/decimal
    first = body[pos]
    if first < 251:
        ln, pos = first, pos + 1
    elif first == 0xFC:
        ln, pos = struct.unpack_from("<H", body, pos + 1)[0], pos + 3
    elif first == 0xFD:
        ln = body[pos + 1] | (body[pos + 2] << 8) | (body[pos + 3] << 16)
        pos += 4
    else:
        ln, pos = struct.unpack_from("<Q", body, pos + 1)[0], pos + 9
    raw = body[pos:pos + ln]
    pos += ln
    return raw.decode(errors="replace"), pos
