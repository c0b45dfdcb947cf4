"""The hybrid timestamp oracle: process-local behind
``storage.mvcc.TsoClient()``, and the meta service's (meta/service.py
``MetaService.tso``) behind every fleet-bound Database, so a fleet has one.

The port of ``Tso`` in ``baikaldb_tpu/meta/service.py``.  A hybrid timestamp is
``physical_ms << 18 | logical``; a grant of ``count`` timestamps is the
integer interval ``[first, first + count)``: logical overflow carries into
the physical bits by plain arithmetic, so the client serves allocations as
in-memory bumps inside a granted range.
"""

from __future__ import annotations

import threading
import time


class Tso:
    """Hybrid timestamp oracle (physical ms << 18 | logical), monotonic
    across a clock that steps back and across restarts via the save-ahead
    lease."""

    LOGICAL_BITS = 18

    def __init__(self):
        self._mu = threading.Lock()
        self._last_physical = 0
        self._logical = 0
        self._save_ahead_ms = 3000
        self._saved_max = 0

    def gen(self, count: int = 1) -> int:
        """Returns the FIRST of ``count`` consecutive timestamps."""
        return self.gen_at(int(time.time() * 1000), count)

    def restore(self, saved_max: int) -> None:
        """Restart: resume past the persisted lease, so timestamps stay
        monotonic across a clock that is behind the previous run's."""
        with self._mu:
            self._last_physical = max(self._last_physical, saved_max)
            self._saved_max = max(self._saved_max, saved_max)

    def gen_at(self, now: int, count: int = 1) -> int:
        """Allocation at an explicit physical clock reading."""
        with self._mu:
            if now <= self._last_physical:
                now = self._last_physical
            else:
                self._logical = 0
            self._last_physical = now
            if now + self._save_ahead_ms > self._saved_max:
                self._saved_max = now + self._save_ahead_ms
            first = (now << self.LOGICAL_BITS) | self._logical
            self._logical += count
            while self._logical >= (1 << self.LOGICAL_BITS):
                # the batch crossed into the next physical tick: carry the
                # remainder so no timestamp in the batch is issued twice
                self._last_physical += 1
                self._logical -= 1 << self.LOGICAL_BITS
            return first
