"""QoS admission control: token buckets per SQL signature, user, and table.

A copy of ``baikaldb_tpu/utils/qos.py`` (host-only Python).  The reference
meters work per "SQL sign" (a hash of the normalized statement) with token
buckets and a reject strategy under overload (include/engine/qos.h:105-114,
src/engine/qos.cpp): acquiring a token admits the query, an empty bucket
raises :class:`RejectedError` instead of queueing unboundedly.  Admission is
also gated per user and per table; both default high enough to be
invisible.  ``Database.qos`` (None by default) arms the session's gate, and
the live token state shows in ``information_schema.dispatcher``.
"""

from __future__ import annotations

import threading
import time


class RejectedError(RuntimeError):
    """Admission rejected under overload (reference: reject strategy)."""


class TokenBucket:
    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.clock = clock
        self._last = clock()
        self._mu = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._mu:
            now = self.clock()
            self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
            self._last = now
            if self.tokens >= n:
                self.tokens -= n
                return True
            return False

    def refund(self, n: float = 1.0) -> None:
        """Return tokens consumed by an admission that a LATER bucket then
        rejected — a throttled tenant's rejected storm must not drain the
        buckets it shares with everyone else."""
        with self._mu:
            self.tokens = min(self.burst, self.tokens + n)

    def peek(self) -> float:
        """Current token level (refreshed, not consumed) — the
        information_schema.dispatcher per-bucket state."""
        with self._mu:
            now = self.clock()
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now
            return self.tokens


class QosManager:
    """Per-sign + per-user + per-table buckets over a global bucket (the
    store-level QoS analog).  ``admit`` raises :class:`RejectedError` when
    ANY applicable bucket is exhausted; every rejection also counts in
    ``metrics.qos_rejections``."""

    def __init__(self, global_rate: float = 10_000.0, global_burst: float = 20_000.0,
                 sign_rate: float = 1_000.0, sign_burst: float = 2_000.0,
                 user_rate: float = 5_000.0, user_burst: float = 10_000.0,
                 table_rate: float = 5_000.0, table_burst: float = 10_000.0,
                 clock=time.monotonic):
        self.clock = clock
        self.global_bucket = TokenBucket(global_rate, global_burst, clock)
        self.sign_rate = sign_rate
        self.sign_burst = sign_burst
        self.user_rate = user_rate
        self.user_burst = user_burst
        self.table_rate = table_rate
        self.table_burst = table_burst
        self._signs: dict[int, TokenBucket] = {}
        self._users: dict[str, TokenBucket] = {}
        self._tables: dict[str, TokenBucket] = {}
        self._mu = threading.Lock()
        self.rejected = 0
        self.admitted = 0

    def _bucket(self, sign: int) -> TokenBucket:
        return self._keyed(self._signs, sign, self.sign_rate,
                           self.sign_burst)

    def _keyed(self, reg: dict, key, rate: float,
               burst: float) -> TokenBucket:
        with self._mu:
            b = reg.get(key)
            if b is None:
                b = reg[key] = TokenBucket(rate, burst, self.clock)
            return b

    @staticmethod
    def sign_of(sql: str) -> int:
        """Normalized statement signature (reference: SQL sign)."""
        import re

        norm = re.sub(r"\s+", " ", sql.strip().lower())
        norm = re.sub(r"'(?:[^'\\]|\\.)*'", "?", norm)
        norm = re.sub(r"\b\d+(\.\d+)?\b", "?", norm)
        norm = re.sub(r"\s*([=<>!,()+\-*/])\s*", r"\1", norm)
        return hash(norm) & 0x7FFFFFFFFFFFFFFF

    def _reject(self, msg: str, taken: list, cost: float):
        """Refund every bucket an earlier check already charged: a rejected
        request consumed nothing, so one throttled tenant's storm cannot
        drain the sign/table buckets it shares with admitted traffic."""
        for b in taken:
            b.refund(cost)
        self.rejected += 1
        from . import metrics
        metrics.qos_rejections.add(1)
        raise RejectedError(msg)

    def admit(self, sql: str, cost: float = 1.0, user: str = "",
              tables: tuple = ()):
        """Raise RejectedError when the statement's sign bucket, the user's
        bucket, any touched table's bucket, or the global bucket is
        exhausted — checked in that order, narrowest first, so the error
        names the binding constraint.  All-or-nothing: a rejection refunds
        whatever earlier buckets already took."""
        taken: list = []
        sign = self.sign_of(sql)
        b = self._bucket(sign)
        if not b.try_acquire(cost):
            self._reject(f"per-statement rate exceeded (sign {sign:x})",
                         taken, cost)
        taken.append(b)
        if user:
            b = self._keyed(self._users, user, self.user_rate,
                            self.user_burst)
            if not b.try_acquire(cost):
                self._reject(f"per-user rate exceeded (user {user!r})",
                             taken, cost)
            taken.append(b)
        for tk in tables:
            b = self._keyed(self._tables, tk, self.table_rate,
                            self.table_burst)
            if not b.try_acquire(cost):
                self._reject(f"per-table rate exceeded (table {tk!r})",
                             taken, cost)
            taken.append(b)
        if not self.global_bucket.try_acquire(cost):
            self._reject("server overloaded (global rate exceeded)",
                         taken, cost)
        self.admitted += 1

    def state(self) -> list[tuple[str, str, float, str]]:
        """(kind, key, tokens, detail) rows for every live bucket — the
        information_schema.dispatcher qos section."""
        with self._mu:
            signs = list(self._signs.items())
            users = list(self._users.items())
            tables = list(self._tables.items())
        rows = [("qos_global", "", self.global_bucket.peek(),
                 f"rate={self.global_bucket.rate} "
                 f"burst={self.global_bucket.burst}")]
        rows += [("qos_sign", format(k, "x"), b.peek(),
                  f"rate={b.rate} burst={b.burst}") for k, b in signs]
        rows += [("qos_user", k, b.peek(),
                  f"rate={b.rate} burst={b.burst}") for k, b in users]
        rows += [("qos_table", k, b.peek(),
                  f"rate={b.rate} burst={b.burst}") for k, b in tables]
        return rows
