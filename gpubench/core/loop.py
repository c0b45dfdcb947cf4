"""The closed loop: each client sends its next statement when the last one
came back, on its own thread and its own Session, over one Database.

A statement's latency runs from its client calling ``Session.execute``
with the SQL text to the result's rows being on the host (the call
returns a host Arrow table).  The window is ``[t0, t_end)`` on
``time.perf_counter``: a statement belongs to it when it was sent inside it,
and clients send nothing at or after ``t_end``; the statements still out at
``t_end`` are waited for, and their whole latency counts."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

JOIN_S = 120.0          # how long past the window an answer is waited for


@dataclass
class Record:
    client: int
    stmt: object
    sent: float
    done: float
    arrow: object = None       # the result (pyarrow.Table); kept inside the window
    error: str = ""


class ClosedLoop:
    def __init__(self, sessions: list, streams: list):
        self.sessions = sessions
        self.streams = streams
        self.records: list[list[Record]] = [[] for _ in streams]
        self.t0: float | None = None        # the window's start, once set
        self.t_end = float("inf")
        self.threads: list[threading.Thread] = []
        self.fatal: list[str] = []          # errors of statements before the window
        self.done: list[list[float]] = [[] for _ in streams]   # every answer's return time

    def passes(self, n: int) -> None:
        """``n`` passes over every client's statements, one client after the
        other, outside any window (set-up)."""
        for _ in range(n):
            for s, stream in zip(self.sessions, self.streams):
                for st in stream:
                    s.execute(st.sql)

    def first_runs(self) -> None:
        """Each distinct statement name once, in first-seen order (set-up)."""
        seen: set = set()
        s = self.sessions[0]
        for stream in self.streams:
            for st in stream:
                if st.name not in seen:
                    seen.add(st.name)
                    s.execute(st.sql)

    def _client(self, c: int) -> None:
        s, stream, out = self.sessions[c], self.streams[c], self.records[c]
        i = 0
        while True:
            st = stream[i % len(stream)]
            i += 1
            sent = time.perf_counter()
            if sent >= self.t_end:
                return
            try:
                res = s.execute(st.sql)
                arrow, err = res.arrow, ""
            except Exception as e:          # noqa: BLE001 — a failed statement is counted
                arrow, err = None, f"{type(e).__name__}: {e}"
            done = time.perf_counter()
            if not err:
                self.done[c].append(done)
            t0 = self.t0
            if t0 is not None and sent >= t0:
                out.append(Record(c, st, sent, done, arrow, err))
            elif err:
                self.fatal.append(f"client {c}, before the window: {st.sql}: {err}")
                return

    def start(self, t0: float | None = None) -> None:
        """Start every client; with ``t0`` the window starts then."""
        self.t0 = t0
        self.threads = [threading.Thread(target=self._client, args=(c,), daemon=True,
                                         name=f"gpubench-client-{c}")
                        for c in range(len(self.streams))]
        for t in self.threads:
            t.start()

    def stop(self, t_end: float) -> bool:
        """No statement is sent from ``t_end`` on; wait for those still out.
        -> whether every client came back within ``JOIN_S`` of the close."""
        self.t_end = t_end
        deadline = t_end + JOIN_S
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return not any(t.is_alive() for t in self.threads)

    def window(self) -> list[Record]:
        return sorted((r for rs in self.records for r in rs), key=lambda r: r.sent)

    def answered(self, t0: float, t_end: float) -> int:
        """Statements that came back without an error inside ``[t0, t_end)``,
        whenever they were sent."""
        return sum(1 for ds in self.done for d in ds if t0 <= d < t_end)
